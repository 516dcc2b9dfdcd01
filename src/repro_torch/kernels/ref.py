"""Plain PyTorch versions of the port's four kernels (port of the matching
oracles in ``repro/kernels/ref.py``).

Each computes exactly what its CUDA kernel computes, on any device; the
wrappers in ``ops.py`` take them for CPU tensors, the tests hold them
against the reference's Pallas kernels, and ``chip_smoke.py`` holds the
kernels against them on the card. Integer outputs, so every comparison is
byte-equal.
"""
from __future__ import annotations

import torch

from repro_torch.graph.csr import uniform_successor


def frog_count_ref(dest: torch.Tensor, n: int) -> torch.Tensor:
    """``counts[v] = #{f : dest[f] == v}`` (int32[n]); entries outside
    ``[0, n)``, such as the padding sentinel -1, are ignored."""
    valid = (dest >= 0) & (dest < n)
    idx = torch.where(valid, dest.long(), n)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=dest.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts[:n]


def frog_step_ref(pos, die, bits, row_ptr, col_idx, deg, n: int):
    """The fused walker step: ``(next int32[N], death_counts int32[n])``.

    ``next = col_idx[row_ptr[pos] + bits % deg[pos]]`` (stay put when
    ``d_out = 0``); the counts tally ``die`` at each frog's current vertex.
    """
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    counts.index_add_(0, pos.long(), die.to(torch.int32))
    return uniform_successor(row_ptr, col_idx, deg, pos, bits), counts


def stitch_gather_ref(pos, bits, endpoints):
    """The gather-only stitch round: ``next = endpoints[pos, bits % R]``."""
    R = endpoints.shape[1]
    idx = pos.long() * R + torch.remainder(bits, R).long()
    return endpoints.reshape(-1)[idx].to(torch.int32)


def stitch_step_ref(pos, stop, bits, endpoints, n: int):
    """The fused stitch round: ``(next int32[W], stop_counts int32[n])``;
    the counts tally ``stop`` at each walk's current vertex."""
    nxt = stitch_gather_ref(pos, bits, endpoints)
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    counts.index_add_(0, pos.long(), stop.to(torch.int32))
    return nxt, counts
