"""Gated MLP (SwiGLU / GeGLU) and the plain two-matrix MLP (port of
``repro/models/mlp.py``).

``jax.nn.gelu`` defaults to the tanh approximation, so ``"gelu"`` is
``F.gelu(..., approximate="tanh")`` here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import compute_weight, dense_init, pdtype_of

ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


class MLP(nn.Module):
    """``w_up`` / ``w_gate`` ``[d_ff, d_model]`` and ``w_down``
    ``[d_model, d_ff]``; no ``w_gate`` when ``mlp_gated`` is False."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator],
                 d_ff: Optional[int] = None):
        super().__init__()
        d = cfg.d_model
        f = d_ff if d_ff is not None else cfg.d_ff
        pd = pdtype_of(cfg)
        self.w_up = dense_init((f, d), pd, device, generator)
        self.w_down = dense_init((d, f), pd, device, generator)
        if cfg.mlp_gated:
            self.w_gate = dense_init((f, d), pd, device, generator)


def mlp_forward(params: MLP, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    act = ACTIVATIONS[cfg.act]
    u = F.linear(x, compute_weight(params, "w_up", cfg))
    if cfg.mlp_gated:
        h = act(F.linear(x, compute_weight(params, "w_gate", cfg))) * u
    else:
        h = act(u)
    return F.linear(h, compute_weight(params, "w_down", cfg))
