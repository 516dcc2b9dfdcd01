"""whisper-medium — encoder-decoder ASR; conv frontend is a stub
(the caller supplies 1,500 precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,                # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=52224,   # 51865 padded to 256·204 for TP divisibility
    head_dim=64,
    encoder_seq=1500,             # 30 s of audio at 50 Hz after conv stub
    mlp_gated=False,
    act="gelu",
)
