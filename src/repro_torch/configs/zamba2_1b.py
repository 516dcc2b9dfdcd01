"""zamba2-1.2b — Mamba2 backbone + weight-shared attention blocks.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,                    # shared transformer block FFN
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    shared_attn_every=6,
)
