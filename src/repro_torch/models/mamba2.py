"""Mamba-2 (SSD) block: the selective state-space layer of zamba2's
backbone (port of ``repro/models/mamba2.py``).

* input projections to ``z``, ``x``, ``B``, ``C`` and ``Δ``; ``Δ =
  softplus(x·W_dt + dt_bias)`` in float32 (``F.softplus`` returns its
  input above 20, where ``log1p(exp(−x))`` is below float32's last bit of
  it);
* a depthwise causal conv over time on ``x`` (``conv_w [W, C]``, summed
  tap by tap in the compute dtype, as the reference does), then ``silu``;
  its decode carry is the last ``W − 1`` inputs before the conv;
* per head a scalar decay ``a = −exp(A_log)`` and the state ``h ∈ R^{D×n}``:
  ``h_t = exp(Δ_t·a)·h_{t−1} + Δ_t·(x_t ⊗ B_t)``, ``y_t = h_t·C_t``, run
  by ``kernels.ops.ssd_scan`` (the hand-written CUDA scan on the card, the
  reference's step looped over time on the CPU);
* the ``D`` skip on the post-conv ``x``, then ``silu(z)`` gating before an
  RMS norm over the whole inner width.

``_dims`` takes the head count as ``2·d_model // ssm_head_dim`` (64 for
zamba2-1.2b), not ``cfg.ssm_heads`` (32): the inner width is twice the
model's. Matrices are ``[out, in]``; ``conv_w`` keeps the reference's
``[W, C]``. The stages run under ``record_function`` ranges
(``mamba.proj``, ``mamba.conv``, ``mamba.scan``, ``mamba.out``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (compute_weight, dense_init, dtype_of,
                                       pdtype_of)


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """``(d_inner, H, D, n)`` of the Mamba-2 layer."""
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, \
        cfg.ssm_state


class Mamba2(nn.Module):
    """``w_in_z`` / ``w_in_x [d_inner, d]``, ``w_in_B`` / ``w_in_C [n,
    d]``, ``w_in_dt [H, d]``, ``w_out [d, d_inner]``; ``dt_bias``,
    ``A_log``, ``D [H]``; ``conv_w [W, d_inner]``; ``norm_scale
    [d_inner]``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d = cfg.d_model
        d_inner, H, _, n = _dims(cfg)
        pd = pdtype_of(cfg)
        for name, rows in (("w_in_z", d_inner), ("w_in_x", d_inner),
                           ("w_in_B", n), ("w_in_C", n), ("w_in_dt", H)):
            setattr(self, name, dense_init((rows, d), pd, device, generator))
        self.dt_bias = nn.Parameter(torch.zeros(H, dtype=pd, device=device))
        a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
        self.A_log = nn.Parameter(a_log.to(pd))
        self.D = nn.Parameter(torch.ones(H, dtype=pd, device=device))
        conv = torch.empty(cfg.conv_width, d_inner, dtype=torch.float32,
                           device=device)
        if device.type != "meta":
            conv.normal_(generator=generator)
        self.conv_w = nn.Parameter((conv * 0.1).to(pd))
        self.norm_scale = nn.Parameter(torch.ones(d_inner, dtype=pd,
                                                  device=device))
        self.w_out = dense_init((d, d_inner), pd, device, generator)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 buf: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time: ``x [B, S, C]``, ``w [W, C]``,
    ``buf [B, W − 1, C]`` (the inputs before ``x``; zeros when None) →
    (``[B, S, C]``, the new buffer). Taps summed in order in x's dtype."""
    B, S, C = x.shape
    W = w.shape[0]
    if buf is None:
        buf = x.new_zeros(B, W - 1, C)
    xp = torch.cat([buf, x], dim=1)                      # [B, S + W − 1, C]
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i]
    return out, xp[:, -(W - 1):]


def _gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """``x · silu(z)`` normalised by its RMS over the last axis, in
    float32, in x's dtype."""
    xf = x.float() * F.silu(z.float())
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def mamba2_forward(params: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``x [B, S, d]`` → (``[B, S, d]``, ``(conv_buf, h)``): the carry for
    the next call, the conv buffer ``[B, W − 1, d_inner]`` in the compute
    dtype and the float32 state ``[B, H, D, n]``; ``state`` the same pair
    (zeros when None)."""
    B, S, _ = x.shape
    d_inner, H, D, _ = _dims(cfg)
    with record_function("mamba.proj"):
        z, xc, Bv, Cv = (F.linear(x, compute_weight(params, name, cfg))
                         for name in ("w_in_z", "w_in_x", "w_in_B",
                                      "w_in_C"))
        delta = F.softplus(
            F.linear(x, compute_weight(params, "w_in_dt", cfg)).float()
            + params.dt_bias.float())                    # [B, S, H]
    with record_function("mamba.conv"):
        xc, conv_buf = _causal_conv(
            xc, compute_weight(params, "conv_w", cfg),
            None if state is None else state[0])
        xc = F.silu(xc)
    with record_function("mamba.scan"):
        a = -torch.exp(params.A_log.float())                 # [H] (negative)
        xh = xc.view(B, S, H, D)
        y, h_last = kops.ssd_scan(xh, Bv, Cv, delta, a,
                                  None if state is None else state[1])
    with record_function("mamba.out"):
        y = y + params.D.float()[None, None, :, None] * xh.float()
        y = y.reshape(B, S, d_inner).to(dtype_of(cfg))
        y = _gated_rmsnorm(y, z, params.norm_scale, cfg.norm_eps)
        out = F.linear(y, compute_weight(params, "w_out", cfg))
    return out, (conv_buf, h_last)
