"""Data pipeline: the deterministic synthetic LM stream (port of
``repro/data``)."""
from repro_torch.data.tokens import SyntheticTokens

__all__ = ["SyntheticTokens"]
