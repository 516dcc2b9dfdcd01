"""Range partitioning of vertices (port of ``repro/graph/partition.py``;
``to_ell`` comes with the SpMV slice)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass(frozen=True)
class VertexPartition:
    """Range partition of vertices over ``num_shards`` shards; vertices are
    padded to a multiple of ``num_shards``."""

    num_shards: int
    n: int                 # original vertex count
    n_padded: int          # padded to a multiple of num_shards
    shard_size: int        # n_padded // num_shards

    def bounds(self, s: int) -> Tuple[int, int]:
        return s * self.shard_size, (s + 1) * self.shard_size


def partition_graph(g: CSRGraph, num_shards: int
                    ) -> Tuple[CSRGraph, VertexPartition]:
    """Pads ``g`` so ``n`` divides ``num_shards``; padding vertices get one
    self-loop and are never visited. Stays on ``g``'s device."""
    n = g.n
    n_padded = ((n + num_shards - 1) // num_shards) * num_shards
    part = VertexPartition(num_shards=num_shards, n=n, n_padded=n_padded,
                           shard_size=n_padded // num_shards)
    if n_padded == n:
        return g, part
    pad = n_padded - n
    i32 = dict(dtype=torch.int32, device=g.device)
    row_ptr = torch.cat([g.row_ptr,
                         g.row_ptr[-1:] + 1 + torch.arange(pad, **i32)])
    col_idx = torch.cat([g.col_idx, torch.arange(n, n_padded, **i32)])
    out_deg = torch.cat([g.out_deg, torch.ones(pad, **i32)])
    return CSRGraph(n=n_padded, row_ptr=row_ptr, col_idx=col_idx,
                    out_deg=out_deg), part
