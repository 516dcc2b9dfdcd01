"""Compressed-sparse-row storage for directed graphs (port of
``repro/graph/csr.py``).

Conventions (paper §2.1): ``A[i, j] = 1`` iff there is an edge ``j -> i``;
``P[i, j] = A[i, j] / d_out(j)``. Out-edges are stored in CSR by source
vertex: ``col_idx[row_ptr[v] : row_ptr[v + 1]]`` are the successors of
``v``. Arrays are int32 tensors on one device; graphs are built on the host
(CPU tensors) and moved with :meth:`CSRGraph.to`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, on_device, resolve_device


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """A directed graph in CSR (by source vertex) form.

    Attributes:
      n:        number of vertices.
      row_ptr:  int32[n + 1] — CSR offsets into ``col_idx``.
      col_idx:  int32[nnz]   — destination vertex of each out-edge.
      out_deg:  int32[n]     — ``row_ptr[1:] - row_ptr[:-1]``.
      epoch / mutation_offset: mutation provenance (0 = never mutated).

    The derived per-edge arrays (``edge_src``, ``edge_dst_shard``,
    ``channel_layout``) are computed on the graph's device at first use
    and memoized on the instance; :meth:`to` starts a new, empty cache.
    """

    n: int
    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    out_deg: torch.Tensor
    epoch: int = 0
    mutation_offset: int = 0
    _derived: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    @property
    def nnz(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def edge_src(self) -> torch.Tensor:
        """int32[nnz] — source vertex of each edge (memoized)."""
        if "edge_src" not in self._derived:
            self._derived["edge_src"] = torch.repeat_interleave(
                torch.arange(self.n, dtype=torch.int32, device=self.device),
                self.out_deg, output_size=self.nnz)
        return self._derived["edge_src"]

    def shard_size(self, num_shards: int) -> int:
        """Vertices per range shard (ceil division)."""
        return max(1, -(-self.n // num_shards))

    def edge_dst_shard(self, num_shards: int) -> torch.Tensor:
        """int32[nnz] — destination range shard of each edge (memoized per
        shard count): the channel granularity of the channel erasure."""
        key = ("edge_dst_shard", num_shards)
        if key not in self._derived:
            self._derived[key] = torch.div(
                self.col_idx, self.shard_size(num_shards),
                rounding_mode="floor")
        return self._derived[key]

    def channel_layout(self, num_shards: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Channel-grouped edge layout for the exact channel draw
        (memoized per shard count): ``(col_sorted int32[nnz], chan_cnt
        int32[n, S], chan_off int32[n, S])`` — ``col_idx`` with each
        vertex's edges stably reordered by destination shard, the edges of
        ``v`` into shard ``d``, and the offset of ``(v, d)``'s first edge
        within ``v``'s segment. The reference sorts on the host with
        ``np.lexsort((dst_shard, src))``; a stable sort by ``src·S +
        dst_shard`` on the graph's device gives the same bytes."""
        key = ("channel_layout", num_shards)
        if key not in self._derived:
            S = num_shards
            chan = (self.edge_src.long() * S
                    + self.edge_dst_shard(S).long())
            order = torch.sort(chan, stable=True).indices
            cnt = torch.bincount(chan, minlength=self.n * S).view(self.n, S)
            off = torch.cumsum(cnt, 1) - cnt
            self._derived[key] = (self.col_idx[order], cnt.to(torch.int32),
                                  off.to(torch.int32))
        return self._derived[key]

    def edge_range(self, v: int) -> Tuple[int, int]:
        """``(row_ptr[v], row_ptr[v + 1])``: ``v``'s out-edges in
        ``col_idx``."""
        lo, hi = self.row_ptr[v:v + 2].tolist()
        return int(lo), int(hi)

    def successors(self, v: int) -> np.ndarray:
        """``v``'s out-neighbours in stored order (int32, on the host)."""
        lo, hi = self.edge_range(v)
        return self.col_idx[lo:hi].cpu().numpy()

    def to(self, device: DeviceLike) -> "CSRGraph":
        """The same graph on ``device`` (itself when already there)."""
        dev = resolve_device(device)
        if on_device(self.row_ptr, dev):
            return self
        return dataclasses.replace(
            self, row_ptr=self.row_ptr.to(dev), col_idx=self.col_idx.to(dev),
            out_deg=self.out_deg.to(dev))


def _from_arrays(n: int, row_ptr: np.ndarray, col_idx: np.ndarray,
                 epoch: int = 0, mutation_offset: int = 0) -> CSRGraph:
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    deg = row_ptr[1:] - row_ptr[:-1]
    return CSRGraph(
        n=int(n),
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)),
        col_idx=torch.from_numpy(np.asarray(col_idx).astype(np.int32)),
        out_deg=torch.from_numpy(deg.astype(np.int32)),
        epoch=int(epoch), mutation_offset=int(mutation_offset),
    )


def build_csr(n: int, src: np.ndarray, dst: np.ndarray,
              dangling: str = "hash") -> CSRGraph:
    """Builds a host-side CSRGraph from an edge list, fixing dangling
    vertices (``"hash"``: one out-edge to a deterministic pseudo-random
    target; ``"self_loop"``: one self-loop). Duplicate edges are kept."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    if src.size and (src.min() < 0 or src.max() >= n or dst.min() < 0
                     or dst.max() >= n):
        raise ValueError("edge endpoints out of range")

    deg = np.bincount(src, minlength=n)
    dangling_v = np.nonzero(deg == 0)[0]
    if dangling_v.size:
        if dangling == "hash":
            fix_dst = (dangling_v * 2654435761 + 12345) % n
            fix_dst = np.where(fix_dst == dangling_v, (fix_dst + 1) % n,
                               fix_dst)
        elif dangling == "self_loop":
            fix_dst = dangling_v
        else:
            raise ValueError(f"unknown dangling policy {dangling!r}")
        src = np.concatenate([src, dangling_v])
        dst = np.concatenate([dst, fix_dst])
        deg = np.bincount(src, minlength=n)

    order = np.argsort(src, kind="stable")
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    return _from_arrays(n, row_ptr, dst[order])


def save_graph(path: str, g: CSRGraph) -> str:
    """Writes ``g`` as one ``.npz`` in the reference's format (``n``,
    ``row_ptr``, ``col_idx``, ``epoch``, ``mutation_offset``), so each
    package loads what the other saved."""
    np.savez_compressed(path, n=np.int64(g.n),
                        row_ptr=g.row_ptr.cpu().numpy(),
                        col_idx=g.col_idx.cpu().numpy(),
                        epoch=np.int64(g.epoch),
                        mutation_offset=np.int64(g.mutation_offset))
    return path if path.endswith(".npz") else path + ".npz"


def load_graph(path: str) -> CSRGraph:
    """Reads a :func:`save_graph` ``.npz`` into a host-side graph (degrees
    re-derived; files without epochs load at epoch 0)."""
    with np.load(path) as z:
        n = int(z["n"])
        row_ptr = np.asarray(z["row_ptr"], dtype=np.int64)
        col_idx = np.asarray(z["col_idx"], dtype=np.int64)
        epoch = int(z["epoch"]) if "epoch" in z else 0
        offset = int(z["mutation_offset"]) if "mutation_offset" in z else 0
    if row_ptr.shape != (n + 1,):
        raise ValueError(
            f"{path!r}: row_ptr has shape {row_ptr.shape}, wanted ({n + 1},)")
    return _from_arrays(n, row_ptr, col_idx, epoch, offset)


def uniform_successor(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                      deg: torch.Tensor, pos: torch.Tensor,
                      bits: torch.Tensor) -> torch.Tensor:
    """One uniform out-edge hop per walker:
    ``next = col_idx[row_ptr[pos] + bits % d_out(pos)]``, and a walker on a
    vertex with ``d_out == 0`` stays put. int32 in, int32 out."""
    pos_l = pos.long()
    d = deg[pos_l]
    slot = torch.remainder(bits, torch.clamp_min(d, 1))
    has = d > 0
    if col_idx.numel() == 0:
        return pos.to(torch.int32)
    edge = torch.where(has, row_ptr[pos_l].long() + slot.long(), 0)
    return torch.where(has, col_idx[edge], pos).to(torch.int32)


def transition_edges(g: CSRGraph
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(src, dst, weight)`` per edge with ``weight = 1/d_out(src)``
    (computed in float64, stored as float32 like the reference): matrix
    ``P`` in COO form."""
    src = torch.repeat_interleave(
        torch.arange(g.n, dtype=torch.int64, device=g.device),
        g.out_deg.long(), output_size=g.nnz)
    w = (1.0 / g.out_deg[src].double()).float()
    return src, g.col_idx.long(), w
