"""Distributed GraphLab-PR baseline: power iteration over a
:class:`~repro_torch.distributed.runtime.ShardMesh` (port of
``repro/engine/baseline.py``).

Pull-form PageRank over range-sharded vertices. Each iteration reads the
rank of every predecessor, which under vertex replication is the
all-mirror synchronization GraphLab performs: an all-gather of the full
rank vector (O(n) bytes a shard an iteration), then a segment sum of the
shard's in-edges. That dense synchronization is the cost FrogWild's sparse,
partially synchronized frog exchange avoids.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.runtime import ShardMesh
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.partition import partition_graph


@dataclasses.dataclass(frozen=True)
class PullGraph:
    """Per-shard in-edge COO blocks (pull orientation), stacked on the
    shard axis, on the graph's device. ``src`` holds global predecessor
    ids, ``dst`` local successor ids, ``w = 1/d_out(src)``; padded entries
    have w = 0."""

    num_shards: int
    shard_size: int
    n: int
    nnz_max: int
    src: torch.Tensor      # int32[S, nnz_max]
    dst: torch.Tensor      # int32[S, nnz_max]
    w: torch.Tensor        # f32[S, nnz_max]

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.src, self.dst, self.w))


def build_pull_graph(g: CSRGraph, num_shards: int) -> PullGraph:
    """Each shard's in-edges, in the graph's edge order, on ``g``'s
    device."""
    gp, part = partition_graph(g, num_shards)
    S, sz, dev = num_shards, part.shard_size, gp.device
    src_all = gp.edge_src.long()
    dst_all = gp.col_idx.long()
    w_all = (1.0 / gp.out_deg[src_all].double()).float()
    owner = dst_all // sz
    nnz_per = torch.bincount(owner, minlength=S)
    nnz_max = max(8, -(-int(nnz_per.max()) // 8) * 8)
    # a stable sort by owner keeps each shard's edges in edge order
    order = torch.sort(owner, stable=True).indices
    owner_s = owner[order]
    start = torch.cumsum(nnz_per, 0) - nnz_per
    slot = owner_s * nnz_max + torch.arange(gp.nnz, device=dev) \
        - start[owner_s]

    def stacked(values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = torch.zeros(S * nnz_max, dtype=dtype, device=dev)
        out[slot] = values.to(dtype)
        return out.view(S, nnz_max)

    return PullGraph(
        num_shards=S, shard_size=sz, n=g.n, nnz_max=nnz_max,
        src=stacked(src_all[order], torch.int32),
        dst=stacked(dst_all[order] - owner_s * sz, torch.int32),
        w=stacked(w_all[order], torch.float32))


def distributed_power_iteration(pg: PullGraph, mesh: ShardMesh,
                                num_iters: int = 50, p_T: float = 0.15
                                ) -> torch.Tensor:
    """The PageRank vector (float32[n], padding stripped) after
    ``num_iters`` iterations on ``mesh``, the same on every rank."""
    if mesh.num_shards != pg.num_shards:
        raise ValueError(f"mesh has {mesh.num_shards} shards, graph has "
                         f"{pg.num_shards} shards")
    S, sz, n = pg.num_shards, pg.shard_size, pg.n
    src, dst, w = (mesh.local(a) for a in (pg.src, pg.dst, pg.w))
    src, dst = src.long(), dst.long()
    x = torch.full((mesh.shards_per_rank, sz), 1.0 / n, dtype=torch.float32,
                   device=mesh.device)
    for _ in range(num_iters):
        # the dense mirror synchronization: every shard needs every
        # predecessor's rank, so the whole vector is gathered
        x_full = mesh.all_gather(x)
        contrib = torch.gather(x_full, 1, src) * w
        px = torch.zeros_like(x).scatter_add_(1, dst, contrib)
        x = (1.0 - p_T) * px + p_T / n
    return mesh.all_gather(x)[0][:n]
