"""Shared building blocks: norms, rotary embeddings, embedding and
initializers (port of ``repro/models/layers.py``).

Weights are stored in ``cfg.param_dtype`` (float32) and cast to the
compute dtype ``cfg.dtype`` where they are used, as in the reference.
``compute_weight`` keeps that cast on the module: one compute-dtype copy
of each weight, made again when the weight changes (another tensor or
device, or an in-place write), so inference does not re-cast every
weight on every call; the copy holds the same values as the cast.
Matrices use ``nn.Linear``'s ``[out, in]`` layout (the reference's
``[in, out]`` transposed). Initialization draws from an explicit
``torch.Generator``: truncated normals on [-2, 2], scaled by
``fan_in ** -0.5`` for dense matrices, as the reference's
``dense_init`` / ``embed_init`` do. The draws match the reference in
distribution, not in bytes; the tests carry the reference's parameters
across (``repro_torch.convert.model_params_from_numpy``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def compute_weight(module: nn.Module, name: str,
                   cfg: ModelConfig) -> torch.Tensor:
    """``module.<name>`` in the compute dtype. Without autograd the cast
    is kept in the module's ``_compute_copies`` and reused while the
    weight is the same tensor at the same in-place version; with autograd
    recording, the cast is made anew so gradients reach the weight."""
    w = getattr(module, name)
    dt = dtype_of(cfg)
    if w.dtype == dt:
        return w
    if torch.is_grad_enabled():
        return w.to(dt)
    stamp = (w.data_ptr(), w.device, 0 if w.is_inference() else w._version)
    copies = module.__dict__.setdefault("_compute_copies", {})
    hit = copies.get((name, dt))
    if hit is None or hit[0] != stamp:
        hit = copies[(name, dt)] = (stamp, w.to(dt))
    return hit[1]


# ----------------------------------------------------------------------------
# initializers
# ----------------------------------------------------------------------------

def _trunc_normal(shape: Sequence[int], device: torch.device,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if device.type != "meta":
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t


def dense_init(shape: Sequence[int], dtype: torch.dtype,
               device: torch.device, generator: Optional[torch.Generator],
               fan_in: Optional[int] = None) -> nn.Parameter:
    """An ``[out, in]`` matrix: truncated normal times ``fan_in ** -0.5``
    (``fan_in`` defaults to ``in``)."""
    fan_in = fan_in if fan_in is not None else shape[-1]
    t = _trunc_normal(shape, device, generator) * fan_in ** -0.5
    return nn.Parameter(t.to(dtype))


def embed_init(shape: Sequence[int], dtype: torch.dtype,
               device: torch.device,
               generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(_trunc_normal(shape, device, generator).to(dtype))


# ----------------------------------------------------------------------------
# RMSNorm
# ----------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale`` in float32, in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params.scale.float()).to(x.dtype)


# ----------------------------------------------------------------------------
# Rotary position embeddings (half-split; positions [S] or [B, S])
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """RoPE on ``x [B, H, S, D]`` at ``positions`` (int ``[S]`` or
    ``[B, S]``), float32 math, result in x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [D/2]
    pos = positions.to(device=x.device, dtype=torch.float32)
    if pos.dim() == 1:
        ang = (pos[:, None] * freqs[None, :])[None, None]     # [1,1,S,D/2]
    else:
        ang = pos[:, None, :, None] * freqs                   # [B,1,S,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.embedding = embed_init((cfg.vocab_size, cfg.d_model),
                                    pdtype_of(cfg), device, generator)


class LMHead(nn.Module):
    """The untied output projection, ``[vocab, d_model]``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.kernel = dense_init((cfg.vocab_size, cfg.d_model),
                                 pdtype_of(cfg), device, generator)


def embed_tokens(params: Embedding, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Rows of the table in the compute dtype, times √d_model cast to that
    dtype before the multiply. The rows are gathered before the cast
    (the same values as the reference's cast-then-gather)."""
    dt = dtype_of(cfg)
    x = F.embedding(tokens.long(), params.embedding).to(dt)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)


def unembed(params: Embedding, x: torch.Tensor, cfg: ModelConfig,
            head: Optional[LMHead] = None) -> torch.Tensor:
    """Vocab logits through the tied table or the separate head."""
    if cfg.tie_embeddings or head is None:
        return F.linear(x, compute_weight(params, "embedding", cfg))
    return F.linear(x, compute_weight(head, "kernel", cfg))
