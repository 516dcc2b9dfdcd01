"""GQA attention block: the full-sequence forward (training / prefill) and
KV-cache decode (port of ``repro/models/attention.py``).

Decode keeps the reference's two cache layouts:

* ``full`` — cache length = max context (global layers);
* ``ring`` — cache length = sliding window, positions wrapping modulo it
  (danube, gemma3's local layers), so decode memory is O(window).

The cache is updated in place (the reference returns a new array; here
the write saves a copy of every layer's cache per token), and
``decode_attention`` returns the same dict it was given. The full-sequence
forward runs ``kernels.ops.attention`` under ``cfg.attn_impl``: the
hand-written ``flash_attention`` kernel for CUDA tensors under ``"auto"``.
Decode attention is the plain ``decode_attention_ref``, as in the
reference. The projections read their weights through
``layers.compute_weight``, which keeps one compute-dtype copy of each. The reference's context-parallel ``cp_kv_attention`` and its
split-KV decode need the mesh (``ROADMAP.md`` Queue 1 item 8e).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, compute_weight,
                                       dense_init, dtype_of, pdtype_of)


class Attention(nn.Module):
    """``wq [Hq·hd, d]``, ``wk`` / ``wv [Hkv·hd, d]``, ``wo [d, Hq·hd]``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, hd, pd = cfg.d_model, cfg.head_dim, pdtype_of(cfg)
        self.wq = dense_init((cfg.num_heads * hd, d), pd, device, generator)
        self.wk = dense_init((cfg.num_kv_heads * hd, d), pd, device,
                             generator)
        self.wv = dense_init((cfg.num_kv_heads * hd, d), pd, device,
                             generator)
        self.wo = dense_init((d, cfg.num_heads * hd), pd, device, generator)


def _project_q(params: Attention, x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """``[B, S, d]`` → ``[B, Hq, S, hd]`` (a transposed view)."""
    B, S, _ = x.shape
    q = F.linear(x, compute_weight(params, "wq", cfg))
    return q.view(B, S, cfg.num_heads, cfg.head_dim).transpose(1, 2)


def project_kv(params: Attention, src: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V projection from ``src`` → two ``[B, Hkv, S, hd]`` views."""
    B, S, _ = src.shape
    k = F.linear(src, compute_weight(params, "wk", cfg))
    v = F.linear(src, compute_weight(params, "wv", cfg))
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    return k.view(shape).transpose(1, 2), v.view(shape).transpose(1, 2)


def attention_forward(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                      is_global: bool = True, causal: bool = True,
                      positions: Optional[torch.Tensor] = None,
                      kv_source: Optional[torch.Tensor] = None,
                      use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill / cross)."""
    B, S, _ = x.shape
    q = _project_q(params, x, cfg)
    k, v = project_kv(params, kv_source if kv_source is not None else x, cfg)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if kv_source is None and use_rope:          # self-attention gets RoPE
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = None if is_global else cfg.sliding_window
    out = kops.attention(q, k, v, causal=causal, window=window,
                         soft_cap=cfg.logit_soft_cap, impl=cfg.attn_impl,
                         chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    return F.linear(out, compute_weight(params, "wo", cfg))


# ----------------------------------------------------------------------------
# KV-cache decode
# ----------------------------------------------------------------------------

def cache_is_ring(cfg: ModelConfig, is_global: bool) -> bool:
    """Static layout decision: windowed layers use a ring cache."""
    return not (is_global or cfg.sliding_window is None)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  is_global: bool, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """One layer's cache, ``[B, Hkv, length, hd]``: ring-sized when the
    layer is windowed. ``kv_cache_dtype="int8"`` stores symmetric int8
    K/V with one float32 scale per (batch, head, position)."""
    length = max_len if not cache_is_ring(cfg, is_global) else min(
        max_len, cfg.sliding_window)
    shape = (batch, cfg.num_kv_heads, length, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=device)}
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(batch, head, position) int8 quantization; rounding
    is half-to-even, as ``jnp.round``'s."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dt: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dt)


def decode_attention(params: Attention, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos: int,
                     cfg: ModelConfig, is_global: bool = True,
                     use_rope: bool = True
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for ``x [B, 1, d]`` at absolute position ``pos``:
    write K/V into the cache (in place) and attend to the valid prefix.
    The reference's single-device branch."""
    B = x.shape[0]
    q = _project_q(params, x, cfg)
    k_new, v_new = project_kv(params, x, cfg)
    if use_rope:
        p = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, p, cfg.rope_theta)
        k_new = apply_rope(k_new, p, cfg.rope_theta)

    ring = cache_is_ring(cfg, is_global)
    L = cache["k"].shape[2]
    window = None if (is_global or ring) else cfg.sliding_window
    slot = pos % L if ring else pos
    if cfg.kv_cache_dtype == "int8":
        for name, new in (("k", k_new), ("v", v_new)):
            q8, sc = _quantize_kv(new)
            cache[name][:, :, slot] = q8[:, :, 0]
            cache[name + "_scale"][:, :, slot] = sc[:, :, 0]
        dt = dtype_of(cfg)
        k_att = _dequantize_kv(cache["k"], cache["k_scale"], dt)
        v_att = _dequantize_kv(cache["v"], cache["v_scale"], dt)
    else:
        cache["k"][:, :, slot] = k_new[:, :, 0]
        cache["v"][:, :, slot] = v_new[:, :, 0]
        k_att, v_att = cache["k"], cache["v"]
    if ring:
        # The ring holds the last ≤ L positions in wrapped order; RoPE was
        # applied at absolute positions when written and the softmax is
        # order-invariant, so the wrapped order does not change the scores.
        out = kref.decode_attention_ref(q, k_att, v_att, min(pos + 1, L),
                                        window=None,
                                        logit_soft_cap=cfg.logit_soft_cap)
    else:
        out = kref.decode_attention_ref(q, k_att, v_att, pos + 1,
                                        window=window,
                                        logit_soft_cap=cfg.logit_soft_cap)
    out = out.transpose(1, 2).reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return F.linear(out, compute_weight(params, "wo", cfg)), cache
