"""Time-chunked scan with checkpointing: the recurrent families' training
memory fix (port of ``repro/models/scan_utils.py``).

Autograd through a plain loop over time keeps every step's tensors for the
backward: at rwkv6-3b's training shape (2 × 4,096 tokens) one layer's
states alone would be 2 · 40 · 64 · 64 · 4 bytes a step, 5.4 GB a layer.
``chunked_scan`` cuts the sequence into segments of ``chunk`` steps and,
while autograd records, runs each segment under ``torch.utils.checkpoint``
(non-reentrant): the backward keeps only the carries at the segment
boundaries (and the segments' inputs, which are views of the caller's) and
runs each segment again when its gradient is due, as the reference's
``jax.checkpoint`` over its inner ``lax.scan`` does. Memory O(S / chunk +
chunk) for about twice the forward's work.

The port's plain scans (``kernels.ref.wkv6_scan_ref``,
``ssd_scan_ref``) run their loops through it with the reference's chunks
(256 and 64), so a CPU training step keeps what the reference keeps. The
card runs the hand-written scan kernels, whose autograd Functions keep
their own chunk checkpoints (``kernels/ops.py``).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.utils.checkpoint

Step = Callable[[torch.Tensor, Tuple[torch.Tensor, ...]],
                Tuple[torch.Tensor, torch.Tensor]]


def _scan(step: Step, carry: torch.Tensor, xs: Sequence[torch.Tensor]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.scan`` over dim 0 of ``xs``: ``(last carry, the steps' outputs
    stacked along dim 0)``."""
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step: Step, carry0: torch.Tensor,
                 xs: Sequence[torch.Tensor], chunk: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``step(carry, x_t) -> (carry, y_t)`` over the time-major tensors
    ``xs`` (each ``[S, ...]``; ``x_t`` is the tuple of their rows ``t``)
    → ``(carry, ys [S, ...])``, the values of a plain loop. When ``S ≤
    chunk`` or ``S % chunk ≠ 0`` it is the plain loop, as in the
    reference; otherwise ``S / chunk`` segments, each checkpointed while
    autograd records (grad mode on and ``carry0`` or an ``xs`` tensor
    requiring grad). Without grad the segments run as the plain loop
    does, so the values are its bytes."""
    xs = tuple(xs)
    S = xs[0].shape[0]
    if S == 0:
        raise ValueError("chunked_scan: xs hold no time step")
    if S <= chunk or S % chunk:
        return _scan(step, carry0, xs)
    recording = torch.is_grad_enabled() and any(
        t.requires_grad for t in (carry0, *xs))

    def segment(carry, *xc):
        return _scan(step, carry, xc)

    carry, ys = carry0, []
    for i in range(S // chunk):
        xc = tuple(x[i * chunk:(i + 1) * chunk] for x in xs)
        if recording:
            carry, yc = torch.utils.checkpoint.checkpoint(
                segment, carry, *xc, use_reentrant=False)
        else:
            carry, yc = segment(carry, *xc)
        ys.append(yc)
    return carry, torch.cat(ys)
