"""h2o-danube-3-4b — dense, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    sliding_window=4096,          # mistral-style SWA on every layer
    rope_theta=10_000.0,
)
