"""rwkv6-3b ("Finch") — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,                 # informational; attention-free
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    ssm_head_dim=64,              # 40 rwkv heads × 64
)
