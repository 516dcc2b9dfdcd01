"""RWKV-6 ("Finch") block: the attention-free linear recurrence with
data-dependent decay (port of ``repro/models/rwkv6.py``).

* token shift: each projection's input mixes the token with the one
  before it (``μ``-interpolation), the carry ``x_prev`` in the compute
  dtype; decode returns ``x[:, -1]``, the pre-mix input;
* the data-dependent decay ``w_t = exp(−exp(w0 + tanh(x·A)·B))`` in
  float32 from a LoRA run in the compute dtype;
* per head the state ``S ∈ R^{D×D}``: ``S_t = diag(w_t)·S_{t−1} + k_t
  v_tᵀ`` with the readout ``o_t = r_tᵀ(S_{t−1} + diag(u)·k_t v_tᵀ)``, run
  by ``kernels.ops.wkv6_scan`` (the hand-written CUDA scan on the card,
  the reference's step looped over time on the CPU);
* a per-head group norm of the readout (the population variance), a
  ``silu(g)`` gate, and a squared-ReLU channel mix (which ignores
  ``cfg.act``, as the reference's does).

The projections run over the whole sequence before the recurrence, as in
the reference, so the scan reads only per-step vectors and the state.
Matrices are ``[out, in]`` (the reference's ``[in, out]`` transposed).
The stages run under ``torch.profiler.record_function`` ranges
(``rwkv.time_mix``, ``rwkv.scan`` inside it, ``rwkv.channel_mix``), by
which a trace splits a layer's device time.
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

LORA_RANK = 64
MIX_NAMES = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g")


class RWKVTimeMix(nn.Module):
    """``mu_*`` and the decay offset ``w0``, ``u`` and ``ln_scale``
    ``[d]``; ``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_o`` ``[d, d]``; the
    decay LoRA ``w_lora_a [64, d]`` and ``w_lora_b [d, 64]``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d = cfg.d_model
        if cfg.ssm_heads * cfg.ssm_head_dim != d:
            raise ValueError(f"ssm_heads {cfg.ssm_heads} × ssm_head_dim "
                             f"{cfg.ssm_head_dim} != d_model {d}")
        pd = pdtype_of(cfg)

        def full(value):
            return nn.Parameter(torch.full((d,), value, dtype=pd,
                                           device=device))

        for name in MIX_NAMES:
            setattr(self, name, full(0.5))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, dense_init((d, d), pd, device, generator))
        self.w0 = full(-6.0)
        self.w_lora_a = dense_init((LORA_RANK, d), pd, device, generator)
        self.w_lora_b = dense_init((d, LORA_RANK), pd, device, generator)
        u = torch.empty(d, dtype=torch.float32, device=device)
        if device.type != "meta":
            u.normal_(generator=generator)
        self.u = nn.Parameter((u * 0.1).to(pd))
        self.ln_scale = nn.Parameter(torch.ones(d, dtype=pd, device=device))


class RWKVChannelMix(nn.Module):
    """``mu [d]``, ``w_in [d_ff, d]``, ``w_out [d, d_ff]``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, f, pd = cfg.d_model, cfg.d_ff, pdtype_of(cfg)
        self.mu = nn.Parameter(torch.full((d,), 0.5, dtype=pd, device=device))
        self.w_in = dense_init((f, d), pd, device, generator)
        self.w_out = dense_init((d, f), pd, device, generator)


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """``x`` shifted one step along time, ``x_prev`` in front."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _decay(params: RWKVTimeMix, xw: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """``w_t ∈ (0, 1)``: ``exp(−exp(w0 + tanh(x·A)·B))``, the LoRA in the
    compute dtype, the rest in float32."""
    a = torch.tanh(F.linear(xw, compute_weight(params, "w_lora_a", cfg)))
    lora = F.linear(a, compute_weight(params, "w_lora_b", cfg))
    raw = params.w0.float() + lora.float()
    return torch.exp(-torch.exp(raw))


def _group_norm(x: torch.Tensor, scale: torch.Tensor, H: int,
                eps: float) -> torch.Tensor:
    """Per-head normalization of the readout ``x [..., d]`` in float32
    with the population variance (``jnp.var``'s), in x's dtype."""
    shape = x.shape
    xh = x.reshape(*shape[:-1], H, shape[-1] // H).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    y = (xh - mu) * torch.rsqrt(var + eps)
    return (y.reshape(shape) * scale.float()).to(x.dtype)


def rwkv_time_mix(params: RWKVTimeMix, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``x [B, S, d]`` → (``[B, S, d]``, ``(x_last, S_last)``): the carry
    for the next call, ``x[:, -1]`` and the float32 state ``[B, H, D,
    D]``. ``state`` is ``(x_prev [B, d], S [B, H, D, D])``, zeros when
    None."""
    B, S, d = x.shape
    H, D = cfg.ssm_heads, cfg.ssm_head_dim
    with record_function("rwkv.time_mix"):
        if state is None:
            x_prev0, S0 = x.new_zeros(B, d, dtype=dtype_of(cfg)), None
        else:
            x_prev0, S0 = state
        shifted = _shift(x, x_prev0)

        def mix(name):
            m = compute_weight(params, name, cfg)
            return x * m + shifted * (1.0 - m)

        r, k, v, g = (F.linear(mix(mu), compute_weight(params, wname, cfg))
                      for mu, wname in (("mu_r", "w_r"), ("mu_k", "w_k"),
                                        ("mu_v", "w_v"), ("mu_g", "w_g")))
        w = _decay(params, mix("mu_w"), cfg)                    # float32
        with record_function("rwkv.scan"):
            o, S_last = kops.wkv6_scan(
                r.view(B, S, H, D), k.view(B, S, H, D), v.view(B, S, H, D),
                w.view(B, S, H, D), params.u.float().view(H, D), S0)
        out = _group_norm(o.view(B, S, d), params.ln_scale, H, cfg.norm_eps)
        out = out * F.silu(g)
        out = F.linear(out, compute_weight(params, "w_o", cfg))
    return out, (x[:, -1], S_last)


def rwkv_channel_mix(params: RWKVChannelMix, x: torch.Tensor,
                     cfg: ModelConfig, x_prev: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d]`` → (``[B, S, d]``, ``x[:, -1]``): the token-shifted
    squared-ReLU MLP; ``x_prev [B, d]`` is the decode carry."""
    B, S, d = x.shape
    with record_function("rwkv.channel_mix"):
        if x_prev is None:
            x_prev = x.new_zeros(B, d, dtype=dtype_of(cfg))
        shifted = _shift(x, x_prev)
        m = compute_weight(params, "mu", cfg)
        xm = x * m + shifted * (1.0 - m)
        h = F.linear(xm, compute_weight(params, "w_in", cfg))
        h = torch.square(F.relu(h))
        y = F.linear(h, compute_weight(params, "w_out", cfg))
    return y, x[:, -1]
