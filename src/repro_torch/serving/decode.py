"""serve_step: one new token for every sequence in the batch (port of
``repro/serving/decode.py``).

Sampling is greedy, or temperature with optional top-k through the
Gumbel-max trick on the port's threefry keys (``prng.categorical``), so
a key draws the reference's token.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (DecodeState, Transformer,
                                            decode_step)


def sample_token(logits: torch.Tensor, key: torch.Tensor,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """``logits [B, V]`` → int32 ``[B]``: argmax at temperature 0, else a
    categorical draw from ``logits / temperature`` restricted to the
    values at or above the ``top_k``-th largest."""
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    lf = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, float("-inf"), lf)
    return prng.categorical(key, lf).to(torch.int32)


def serve_step(params: Transformer, state: DecodeState, tokens: torch.Tensor,
               cfg: ModelConfig, key: Optional[torch.Tensor] = None,
               temperature: float = 0.0, top_k: int = 0
               ) -> Tuple[torch.Tensor, DecodeState]:
    """Decode one token per sequence → (next tokens int32 ``[B]``, new
    state). ``key`` defaults to ``PRNGKey(0)``, as in the reference."""
    logits, state = decode_step(params, state, tokens, cfg)
    if key is None:
        key = prng.PRNGKey(0, logits.device)
    return sample_token(logits, key, temperature=temperature,
                        top_k=top_k), state
