"""gemma3-4b — dense, 5:1 local:global attention, 128k context, 262k vocab.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,                 # gemma uses head_dim ≠ d_model/num_heads
    sliding_window=1024,          # local layers
    global_every=6,               # every 6th layer is global (5:1)
    rope_theta=1_000_000.0,
)
