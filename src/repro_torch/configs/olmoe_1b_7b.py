"""olmoe-1b-7b — 64-expert top-8 MoE (1B active / 7B total).
[arXiv:2409.02060; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                    # per-expert FFN width
    vocab_size=50304,
    head_dim=128,
    num_experts=64,
    num_experts_per_tok=8,
)
