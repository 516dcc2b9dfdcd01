"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,                    # per-expert FFN width
    vocab_size=32064,
    head_dim=128,
    num_experts=16,
    num_experts_per_tok=2,
)
