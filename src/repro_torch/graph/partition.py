"""Range partitioning of vertices and the hybrid ELL layout of the SpMV
(port of ``repro/graph/partition.py``)."""
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


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Hybrid ELL + COO-spill layout for the SpMV kernel, pull-oriented:
    row ``i`` of the slab lists the predecessors of vertex ``i``, so
    ``y = P @ x`` with ``P[i, j] = A[i, j] / d_out(j)``.

    Attributes:
      idx:    int32[n_rows, K] — source ids; 0 on padded lanes.
      valid:  bool [n_rows, K]
      weight: f32  [n_rows, K] — ``1/d_out(src)``; 0 on padded lanes.
      spill_src / spill_dst / spill_w: the COO tail of rows with more than
        ``K`` in-edges (their edges beyond the first ``K``).
      row_len: int32[n_rows] — live lanes per row, ``valid.sum(1)``
        (``min(in_deg, K)`` under ``to_ell``; 0 on padding rows). Derived
        from ``valid`` when the graph is made, not one of the reference's
        fields. The slab kernel reads only each row's first ``row_len``
        lanes.
    """

    n_rows: int
    K: int
    idx: torch.Tensor
    valid: torch.Tensor
    weight: torch.Tensor
    spill_src: torch.Tensor
    spill_dst: torch.Tensor
    spill_w: torch.Tensor
    row_len: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "row_len",
                           self.valid.sum(1, dtype=torch.int32))

    @property
    def spill_nnz(self) -> int:
        return int(self.spill_src.shape[0])

    @property
    def nbytes(self) -> int:
        """Bytes of the reference's fields (``row_len`` not counted)."""
        return sum(t.numel() * t.element_size() for t in (
            self.idx, self.valid, self.weight, self.spill_src,
            self.spill_dst, self.spill_w))


def to_ell(g: CSRGraph, K: int = 32, row_pad: int = 8) -> EllGraph:
    """``g`` in pull-oriented hybrid ELL on ``g``'s device. ``K`` is
    rounded up to a multiple of 8 and the rows to a multiple of
    ``row_pad``. Each row keeps its first ``K`` in-edges in the order of a
    stable sort of the edges by destination; the rest go to the spill, in
    that order. The same bytes as the reference's per-vertex loop, built
    with a sort and one scatter: an edge's lane is its position in the
    sorted order minus the row's first position."""
    K = -(-int(K) // 8) * 8
    n, dev = g.n, g.device
    src = g.edge_src.long()
    dst = g.col_idx.long()
    w = (1.0 / g.out_deg[src].double()).float()
    order = torch.sort(dst, stable=True).indices
    src_s, dst_s, w_s = src[order], dst[order], w[order]
    in_deg = torch.bincount(dst, minlength=n)
    in_ptr = torch.cumsum(in_deg, 0) - in_deg
    lane = torch.arange(g.nnz, device=dev) - in_ptr[dst_s]
    slab = lane < K
    n_rows = -(-n // row_pad) * row_pad
    flat = dst_s[slab] * K + lane[slab]
    idx = torch.zeros(n_rows * K, dtype=torch.int32, device=dev)
    idx[flat] = src_s[slab].to(torch.int32)
    valid = torch.zeros(n_rows * K, dtype=torch.bool, device=dev)
    valid[flat] = True
    weight = torch.zeros(n_rows * K, dtype=torch.float32, device=dev)
    weight[flat] = w_s[slab]
    spill = ~slab
    return EllGraph(
        n_rows=n_rows, K=K, idx=idx.view(n_rows, K),
        valid=valid.view(n_rows, K), weight=weight.view(n_rows, K),
        spill_src=src_s[spill].to(torch.int32),
        spill_dst=dst_s[spill].to(torch.int32), spill_w=w_s[spill])
