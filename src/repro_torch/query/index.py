"""Offline walk-segment index (port of ``repro/query/index.py``,
single-device build).

For every vertex ``v`` the index stores ``R`` endpoints of plain (p_s = 1,
no-death) random walks of exactly ``L`` steps started at ``v``, each cell
an exact sample of ``P^L(· | v)``. The index exists in two forms:

* :class:`WalkIndex` — the dense ``int32[n, R]`` slab on the device;
* :class:`ShardedWalkIndex` — the same rows range-partitioned into
  ``num_shards`` blocks of ``shard_size`` rows, held as one stacked
  ``int32[S, shard_size, R]`` tensor on the device (rows past ``n`` are
  zero and never read). Sharded serving gathers each walk's next segment
  from the block that owns its vertex (:func:`shard_walk_index`).

Randomness is per (vertex, step): ``fold_in(fold_in(key, v), l)`` draws the
row's ``R`` slot bits at shape ``(R,)``, so a row's endpoints do not depend
on the batch it is walked in, and the slab is byte-equal to the
reference's. The build walks one range shard of ``build_shards`` at a time,
which bounds the walkers (and the key streams) alive per step to
``R · n / build_shards``. Every hop runs through ``ops.frog_hop``, one
launch that draws the rows' bits itself; with ``step_impl="stream"``
through the streamed kernel over the graph's :class:`BlockedCSR` (the
service's cached one). (The reference documents ``"stream"`` for its
build but its jitted row walker passes the graph as traced operands, which
its ``ops.frog_step`` refuses; the port's slab equals the reference's slab
built with any other step backend.)

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
from repro_torch.kernels import ops
from repro_torch.kernels.frog_step_stream import BlockedCSR, blocked_csr_of

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


@dataclasses.dataclass(frozen=True)
class ShardedWalkIndex:
    """The walk-index slab as range-partitioned per-shard blocks.

    ``blocks[s]`` holds the ``[shard_size, R]`` endpoints of vertices
    ``[s · shard_size, (s+1) · shard_size)``. All blocks live on one device
    as one stacked tensor, so ``blocks.view(S · shard_size, R)`` is the
    row-padded dense slab without a copy.

    Attributes:
      blocks:      int32[S, shard_size, R].
      n:           true vertex count (``S · shard_size ≥ n``; the padded
                   rows are zero and never gathered, since walk positions
                   are graph vertices).
      segment_len: L, steps per precomputed segment.
      seed:        build seed (provenance).
      visited_blocks: ``None`` until the dynamic-graphs slice is ported.
      graph_epoch / mutation_offset: provenance of the graph walked.
    """

    blocks: torch.Tensor
    n: int
    segment_len: int
    seed: int
    visited_blocks: Optional[torch.Tensor] = None
    graph_epoch: int = 0
    mutation_offset: int = 0

    @property
    def num_shards(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def shard_size(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def segments_per_vertex(self) -> int:
        return int(self.blocks.shape[2])

    def reassemble(self) -> WalkIndex:
        """The dense ``int32[n, R]`` slab, a copy on the blocks' device."""
        S, sz, R = self.blocks.shape
        return WalkIndex(
            endpoints=self.blocks.reshape(S * sz, R)[: self.n].clone(),
            segment_len=self.segment_len, seed=self.seed,
            graph_epoch=self.graph_epoch,
            mutation_offset=self.mutation_offset)


def shard_walk_index(index: WalkIndex, num_shards: int) -> ShardedWalkIndex:
    """Range-partitions a dense index into ``num_shards`` blocks of
    ``⌈n / num_shards⌉`` rows on the index's device; the rows padded past
    ``n`` are zero."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be ≥ 1, got {num_shards}")
    n, R = index.endpoints.shape
    sz = -(-n // num_shards)
    ep = torch.zeros(num_shards * sz, R, dtype=torch.int32,
                     device=index.endpoints.device)
    ep[:n] = index.endpoints
    return ShardedWalkIndex(
        blocks=ep.reshape(num_shards, sz, R), n=n,
        segment_len=index.segment_len, seed=index.seed,
        graph_epoch=index.graph_epoch,
        mutation_offset=index.mutation_offset)


def _segment_walk_rows(row_ptr, col_idx, deg, n, step_impl, R, L, vertices,
                       key, blocked=None):
    """Walks the L-step segments of ``vertices`` (all ``R`` slots per row)
    with the per-vertex key streams → ``endpoints int32[C, R]``; each hop
    is one ``ops.frog_hop``, which draws the row's bits itself."""
    row_keys = prng.fold_in(key, vertices)
    pos = torch.repeat_interleave(vertices.to(torch.int32), R)
    for step in range(L):
        ops.frog_hop(pos, row_keys, step, R, row_ptr, col_idx, deg, n,
                     impl=step_impl, blocked=blocked)
    return pos.reshape(-1, R)


def _build_walk_index(g: CSRGraph, cfg: WalkIndexConfig,
                      key: Optional[torch.Tensor] = None,
                      blocked: Optional[BlockedCSR] = None) -> WalkIndex:
    """Builds the ``int32[n, R]`` slab on ``g``'s device, one range shard at
    a time; ``key`` defaults to ``PRNGKey(cfg.seed)`` there. ``blocked``
    is ``g``'s slab layout for ``step_impl="stream"`` (built here when not
    given).

    The reference walks the rows of its graph padded to a multiple of
    ``num_shards`` and drops the padding rows; a padding vertex has no
    in-edge, so walks from the real vertices never reach one and walking
    ``g`` itself gives the same rows."""
    if cfg.segment_len < 1:
        raise ValueError(f"segment_len must be ≥ 1, got {cfg.segment_len}")
    if key is None:
        key = prng.PRNGKey(cfg.seed, g.device)
    R, L = cfg.segments_per_vertex, cfg.segment_len
    if cfg.step_impl == "stream" and blocked is None:
        blocked = blocked_csr_of(g)
    sz = -(-g.n // cfg.num_shards)
    blocks = []
    for lo in range(0, g.n, sz):
        vs = torch.arange(lo, min(lo + sz, g.n), dtype=torch.int32,
                          device=g.device)
        blocks.append(_segment_walk_rows(
            g.row_ptr, g.col_idx, g.out_deg, g.n, cfg.step_impl, R, L, vs,
            key, blocked))
    return WalkIndex(
        endpoints=torch.cat(blocks),
        segment_len=cfg.segment_len,
        seed=cfg.seed,
        graph_epoch=g.epoch,
        mutation_offset=g.mutation_offset,
    )
