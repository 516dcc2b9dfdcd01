"""Batched edge mutations on :class:`~repro_torch.graph.csr.CSRGraph`
(port of ``repro/dynamic/mutations.py``).

A :class:`MutationBatch` is one atomic set of edge inserts and deletes.
Applying it compacts the deltas into a new CSR at ``epoch + 1``; the old
graph object is never modified and keeps serving its pinned queries (the
two-epoch contract, see the package docstring). The compaction runs in
host numpy, as the reference's does, and the new graph is placed on the
old graph's device.

**Successor order is part of the sampling function.** A walk picks
``col_idx[row_ptr[v] + bits % d_out(v)]``, so reordering an untouched
vertex's list would change its segments' bytes and break the invalidation
argument. :func:`apply_mutations` edits per-vertex successor lists in
place (a delete removes the first matching occurrence, an insert appends
at the end) and carries every untouched vertex's list over verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph, _from_arrays


def _edge_arrays(edges: Iterable[Tuple[int, int]]):
    pairs = list(edges)
    if not pairs:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    a = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    return a[:, 0].copy(), a[:, 1].copy()


@dataclasses.dataclass(frozen=True)
class MutationBatch:
    """One atomic batch of edge inserts/deletes (the epoch increment unit).

    Attributes:
      insert_src / insert_dst: int64[k_i] — edges to add (duplicates are
        legal: a multi-edge carries proportionally more transition mass).
      delete_src / delete_dst: int64[k_d] — edges to remove; each delete
        consumes the *first* remaining occurrence of ``(src, dst)`` in
        ``src``'s successor list. Deleting an absent edge raises.
    """

    insert_src: np.ndarray
    insert_dst: np.ndarray
    delete_src: np.ndarray
    delete_dst: np.ndarray

    @classmethod
    def edges(cls, insert: Iterable[Tuple[int, int]] = (),
              delete: Iterable[Tuple[int, int]] = ()) -> "MutationBatch":
        isrc, idst = _edge_arrays(insert)
        dsrc, ddst = _edge_arrays(delete)
        return cls(insert_src=isrc, insert_dst=idst,
                   delete_src=dsrc, delete_dst=ddst)

    @property
    def size(self) -> int:
        """Total mutations in the batch (the mutation-log offset delta)."""
        return int(self.insert_src.size + self.delete_src.size)


def _dangling_target(v: int, n: int, dangling: str) -> int:
    """``build_csr``'s repair edge for a vertex left with no out-edge."""
    if dangling == "hash":
        t = (v * 2654435761 + 12345) % n
        return (t + 1) % n if t == v else t
    if dangling == "self_loop":
        return v
    raise ValueError(f"unknown dangling policy {dangling!r}")


def apply_mutations(g: CSRGraph, batch: MutationBatch,
                    dangling: str = "hash") -> Tuple[CSRGraph, np.ndarray]:
    """Compacts ``batch`` into a new CSR at ``g.epoch + 1`` on ``g``'s
    device.

    Returns ``(new_graph, changed)``: ``changed`` is the sorted int64
    array of vertices whose successor list differs from the old graph's,
    the input :func:`~repro_torch.dynamic.refresh.invalidate_segments`
    needs. A vertex left with no out-edge gets ``build_csr``'s dangling
    repair (policy ``dangling``), so every vertex keeps ``d_out > 0``
    across epochs; the repaired vertex counts as changed.

    Raises ``ValueError`` on endpoints outside ``[0, n)`` and on deletes
    of absent edges: a mutation stream that disagrees with the graph it
    mutates is refused loudly.
    """
    n = g.n
    for name, arr in (("insert_src", batch.insert_src),
                      ("insert_dst", batch.insert_dst),
                      ("delete_src", batch.delete_src),
                      ("delete_dst", batch.delete_dst)):
        if arr.size and (arr.min() < 0 or arr.max() >= n):
            raise ValueError(f"{name} has endpoints outside [0, {n})")

    rp = g.row_ptr.cpu().numpy().astype(np.int64)
    col = g.col_idx.cpu().numpy().astype(np.int64)

    touched = np.union1d(batch.insert_src, batch.delete_src).astype(np.int64)
    segs = {int(v): list(col[rp[v]:rp[v + 1]]) for v in touched}

    for s, d in zip(batch.delete_src, batch.delete_dst):
        try:
            segs[int(s)].remove(int(d))
        except ValueError:
            raise ValueError(
                f"delete of absent edge ({int(s)}, {int(d)}) — the "
                f"mutation stream disagrees with epoch {g.epoch}'s graph")
    for s, d in zip(batch.insert_src, batch.insert_dst):
        segs[int(s)].append(int(d))

    changed: List[int] = []
    for v, lst in segs.items():
        old = col[rp[v]:rp[v + 1]]
        if len(lst) != old.size or not np.array_equal(
                np.asarray(lst, np.int64), old):
            changed.append(v)
        if not lst:
            lst.append(_dangling_target(v, n, dangling))

    # splice the edited lists between the untouched contiguous runs: O(nnz)
    # copies, no Python loop over the untouched vertices
    parts: List[np.ndarray] = []
    prev = 0
    for v in touched:
        parts.append(col[rp[prev]:rp[v]])
        parts.append(np.asarray(segs[int(v)], dtype=np.int64))
        prev = int(v) + 1
    parts.append(col[rp[prev]:rp[n]])
    col_new = np.concatenate(parts)

    deg_new = rp[1:] - rp[:-1]
    for v in touched:
        deg_new[v] = len(segs[int(v)])
    rp_new = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg_new, out=rp_new[1:])

    new_g = _from_arrays(n, rp_new, col_new, epoch=g.epoch + 1,
                         mutation_offset=g.mutation_offset + batch.size)
    return new_g.to(g.device), np.asarray(sorted(changed), dtype=np.int64)


@dataclasses.dataclass
class MutationLog:
    """An append-only stream of mutation batches with offset bookkeeping.

    ``base_epoch`` / ``base_offset`` anchor the log to the graph snapshot
    it extends; ``epoch`` / ``offset`` are where a full replay lands, the
    provenance graph files and walk-index checkpoints carry, so a (graph,
    slab, log) triple can be cross-checked on load.
    """

    base_epoch: int = 0
    base_offset: int = 0
    batches: List[MutationBatch] = dataclasses.field(default_factory=list)

    def append(self, batch: MutationBatch) -> int:
        """Appends one batch; returns the epoch a replay-through lands on."""
        self.batches.append(batch)
        return self.epoch

    @property
    def epoch(self) -> int:
        return self.base_epoch + len(self.batches)

    @property
    def offset(self) -> int:
        return self.base_offset + sum(b.size for b in self.batches)

    def replay(self, g: CSRGraph) -> Tuple[CSRGraph, np.ndarray]:
        """Applies every batch after ``g``'s epoch, in order (a graph at
        ``base_epoch + k`` skips the first ``k``). Returns the final graph
        and the union of the changed vertices of the replayed batches."""
        if not (self.base_epoch <= g.epoch <= self.epoch):
            raise ValueError(
                f"graph epoch {g.epoch} outside log range "
                f"[{self.base_epoch}, {self.epoch}]")
        changed = np.zeros(0, dtype=np.int64)
        for batch in self.batches[g.epoch - self.base_epoch:]:
            g, ch = apply_mutations(g, batch)
            changed = np.union1d(changed, ch)
        return g, changed
