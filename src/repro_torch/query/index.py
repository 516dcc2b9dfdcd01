"""Offline walk-segment index (port of ``repro/query/index.py``, dense
single-device build).

For every vertex ``v`` the index stores ``R`` endpoints of plain (p_s = 1,
no-death) random walks of exactly ``L`` steps started at ``v``: a dense
``int32[n, R]`` slab on the device, each cell an exact sample of
``P^L(· | v)``.

Randomness is per (vertex, step): ``fold_in(fold_in(key, v), l)`` draws the
row's ``R`` slot bits at shape ``(R,)``, so a row's endpoints do not depend
on the batch it is walked in, and the slab is byte-equal to the
reference's. The build walks one range shard of ``build_shards`` at a time,
which bounds the walkers (and the key streams) alive per step to
``R · n / build_shards``. Every hop runs through ``ops.frog_step``.

Not yet ported: the per-segment ``visited_blocks`` masks (dynamic-graph
invalidation; ``None`` here, which the reference allows for indexes loaded
from pre-epoch checkpoints), the ``shard_map`` build, and persistence.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.config import WalkIndexConfig
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.partition import partition_graph
from repro_torch.kernels import ops

@dataclasses.dataclass(frozen=True)
class WalkIndex:
    """Dense per-vertex walk-segment endpoints.

    Attributes:
      endpoints:   int32[n, R] — ``endpoints[v, r] ~ P^L(· | v)``.
      segment_len: L, the number of steps each stored segment advanced.
      seed:        build seed (provenance; queries use their own keys).
      visited_blocks: per-segment visited-block masks — ``None`` until the
                   dynamic-graphs slice is ported.
      graph_epoch / mutation_offset: provenance of the graph walked.
    """

    endpoints: torch.Tensor
    segment_len: int
    seed: int
    visited_blocks: Optional[torch.Tensor] = None
    graph_epoch: int = 0
    mutation_offset: int = 0

    @property
    def n(self) -> int:
        return int(self.endpoints.shape[0])

    @property
    def segments_per_vertex(self) -> int:
        return int(self.endpoints.shape[1])


def _segment_step(row_ptr, col_idx, deg, n, step_impl, pos, bits):
    """One no-death plain walker move for a batch of segment walks (the
    death tally of ``frog_step`` is all zeros and discarded)."""
    nxt, _ = ops.frog_step(pos, torch.zeros_like(pos), bits, row_ptr,
                           col_idx, deg, n, impl=step_impl)
    return nxt


def _segment_walk_rows(row_ptr, col_idx, deg, n, step_impl, R, L, vertices,
                       key):
    """Walks the L-step segments of ``vertices`` (all ``R`` slots per row)
    with the per-vertex key streams → ``endpoints int32[C, R]``."""
    row_keys = prng.fold_in(key, vertices)
    pos = torch.repeat_interleave(vertices.to(torch.int32), R)
    for step in range(L):
        ks = prng.fold_in(row_keys, step)
        bits = prng.randint(ks, (R,), 0, 1 << 30)
        pos = _segment_step(row_ptr, col_idx, deg, n, step_impl, pos,
                            bits.reshape(-1))
    return pos.reshape(-1, R)


def _build_walk_index(g: CSRGraph, cfg: WalkIndexConfig,
                      key: Optional[torch.Tensor] = None) -> WalkIndex:
    """Builds the ``int32[n, R]`` slab on ``g``'s device, one range shard at
    a time; ``key`` defaults to ``PRNGKey(cfg.seed)`` there."""
    if cfg.segment_len < 1:
        raise ValueError(f"segment_len must be ≥ 1, got {cfg.segment_len}")
    if key is None:
        key = prng.PRNGKey(cfg.seed, g.device)
    gp, part = partition_graph(g, cfg.num_shards)
    R, L = cfg.segments_per_vertex, cfg.segment_len
    blocks = []
    for s in range(cfg.num_shards):
        lo, hi = part.bounds(s)
        vs = torch.arange(lo, hi, dtype=torch.int32, device=g.device)
        blocks.append(_segment_walk_rows(
            gp.row_ptr, gp.col_idx, gp.out_deg, gp.n, cfg.step_impl, R, L,
            vs, key))
    return WalkIndex(
        endpoints=torch.cat(blocks)[: g.n].contiguous(),
        segment_len=cfg.segment_len,
        seed=cfg.seed,
        graph_epoch=g.epoch,
        mutation_offset=g.mutation_offset,
    )
