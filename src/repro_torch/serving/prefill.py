"""Prefill: run the prompt through the cache, return the last token's
logits and the filled state (port of ``repro/serving/prefill.py``).

A token-by-token loop over ``decode_step``, as the reference's scan is:
exact for every cache layout, one decode program. The reference has no
fused prefill either; its ``prefill_32k`` shape lowers the full-sequence
forward (``models.forward_train``), which is where the port's
``flash_attention`` kernel runs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (DecodeState, Transformer,
                                            decode_step, init_decode_state)


def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, encoder_frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, DecodeState]:
    """``tokens int[B, S_prompt]`` → (logits of the last prompt token
    ``[B, V]``, the state after it). whisper's decode state needs
    ``encoder_frames [B, T, d]``."""
    B, S = tokens.shape
    state = init_decode_state(params, cfg, B, max_len,
                              encoder_frames=encoder_frames)
    logits = None
    for t in range(S):
        logits, state = decode_step(params, state, tokens[:, t], cfg)
    return logits, state
