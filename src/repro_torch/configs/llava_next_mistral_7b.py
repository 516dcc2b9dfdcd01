"""llava-next-mistral-7b — VLM: mistral-7b backbone + anyres patch frontend
(stub: precomputed patch embeddings). [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1_000_000.0,
    num_prefix_embeddings=2880,   # anyres tiling: ~5 tiles × 576 patches
)
