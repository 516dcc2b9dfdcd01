"""Segment invalidation and incremental walk-index refresh (port of
``repro/dynamic/refresh.py``).

The invalidation rule (sound by construction, see the package docstring):
a segment ``(v, r)`` is stale iff

* ``v``'s own successor list changed (the segment's first hop samples it),
  or
* the segment's recorded trajectory passed through a vertex-id block
  holding a changed vertex: one bitwise AND of the segment's
  ``visited_blocks`` mask against the batch's dirty-block mask. The mask
  records the intermediate hops only (the start is the first rule, exact
  per vertex; the endpoint consumes no edge). Blocks make the test
  conservative (a block-mate's change can flag an innocent segment) but
  never unsound: a segment whose consumed vertices all kept their
  successor lists verbatim replays byte for byte under the new graph,
  because its bits depend only on ``(seed, v, step)``.

:func:`refresh_walk_index` re-walks the rows holding stale segments
through the index build's own segment walk (``query/index.py:
_segment_walk_rows``, one ``frog_segment_walk`` launch a chunk that
records the masks) and writes back exactly the invalidated cells, on the index's
device: the result equals a from-scratch build at the new epoch, byte
for byte. The reference pads its last chunk of rows to a power of two so
that JAX does not re-trace; nothing here traces, so the port walks the
rows as they are, at most ``chunk`` rows (``chunk · R`` walks) a launch.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import DeviceLike
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels.frog_step_stream import BlockedCSR, blocked_csr_of
from repro_torch.query.index import (_MASK_WORDS, ShardedWalkIndex,
                                     WalkIndex, _segment_walk_rows,
                                     load_walk_index, save_walk_index,
                                     save_walk_index_shard,
                                     segment_mask_block_size,
                                     shard_walk_index)


@dataclasses.dataclass(frozen=True)
class RefreshReport:
    """What one incremental refresh did.

    ``segments_rebuilt == stale_segments`` always: the refresh writes the
    invalidated cells and nothing else (it walks all R slots of each of
    the ``stale_rows`` distinct vertices holding them, since a row's
    ``(R,)`` bit draw costs the same as one slot's).
    """

    epoch: int
    n: int
    changed_vertices: int
    stale_rows: int
    stale_segments: int
    segments_rebuilt: int
    total_segments: int


def dirty_block_mask(changed: np.ndarray, n: int) -> np.ndarray:
    """uint32[_MASK_WORDS] — the visited-block bits covering ``changed``."""
    dirty = np.zeros(_MASK_WORDS, dtype=np.uint32)
    changed = np.asarray(changed, np.int64)
    if changed.size:
        blk = changed // segment_mask_block_size(n)
        np.bitwise_or.at(dirty, blk >> 5,
                         np.uint32(1) << (blk & 31).astype(np.uint32))
    return dirty


def _mask_words(index: Union[WalkIndex, ShardedWalkIndex]) -> torch.Tensor:
    """The index's masks as int32[n, R, _MASK_WORDS] words (a view)."""
    vb = index.visited_blocks
    if vb is None:
        raise ValueError(
            "index has no visited_blocks (built before per-segment "
            "trajectory masks existed) — incremental invalidation is "
            "impossible; rebuild the slab from scratch")
    vb = vb.view(torch.int32)
    return vb.reshape(-1, *vb.shape[-2:])[: index.n]


def invalidate_segments(index: Union[WalkIndex, ShardedWalkIndex],
                        changed) -> torch.Tensor:
    """bool[n, R] on the index's device — True where segment ``(v, r)``
    must be re-walked. Only the dirty mask words are tested (a batch
    touches few blocks).

    Requires the index's ``visited_blocks``: an index from a pre-epoch
    checkpoint has no trajectory record and cannot be invalidated
    incrementally.
    """
    vb = _mask_words(index)
    n = index.n
    changed = np.asarray(changed, dtype=np.int64)
    if changed.size and (changed.min() < 0 or changed.max() >= n):
        raise ValueError(f"changed vertices outside [0, {n})")
    dirty = dirty_block_mask(changed, n).view(np.int32)
    stale = torch.zeros(vb.shape[:2], dtype=torch.bool, device=vb.device)
    for word in np.nonzero(dirty)[0]:
        stale |= (vb[:, :, word] & int(dirty[word])) != 0
    stale[torch.from_numpy(changed).to(vb.device)] = True   # source rule
    return stale


def _dense_views(index: Union[WalkIndex, ShardedWalkIndex]):
    """(endpoints int32[n, R], masks int32[n, R, W]) copies of either
    form, the masks as int32 words."""
    if isinstance(index, ShardedWalkIndex):
        S, sz, R = index.blocks.shape
        ep = index.blocks.reshape(S * sz, R)[: index.n].clone()
    else:
        ep = index.endpoints.clone()
    return ep, _mask_words(index).clone()


def refresh_walk_index(
    index: Union[WalkIndex, ShardedWalkIndex],
    new_graph: CSRGraph,
    changed,
    *,
    step_impl: str = "auto",
    chunk: int = 4096,
    blocked: Optional[BlockedCSR] = None,
):
    """Re-walks exactly the invalidated segments on ``new_graph``, on the
    index's device.

    Returns ``(new_index, report)``: ``new_index`` has ``index``'s
    container type (and shard count), is stamped with ``new_graph``'s
    epoch and offset, and is byte-equal to a from-scratch build at the new
    epoch, endpoints and masks.

    The distinct stale rows are walked, at most ``chunk`` rows a launch,
    through the index build's segment walk with the build's key streams
    (``fold_in(PRNGKey(seed), v)``), and only the invalidated cells are
    written back. ``step_impl`` picks the hop kernel as for a build;
    ``"stream"`` walks over ``new_graph``'s :class:`BlockedCSR`
    (``blocked``, built here when not given).
    """
    if new_graph.n != index.n:
        raise ValueError(
            f"graph n={new_graph.n} vs index n={index.n}: refresh cannot "
            f"change the vertex count")
    if new_graph.epoch <= index.graph_epoch:
        raise ValueError(
            f"graph epoch {new_graph.epoch} is not ahead of the slab's "
            f"{index.graph_epoch} — nothing to refresh (or the pair is "
            f"mismatched)")
    if chunk < 1:
        raise ValueError(f"chunk must be ≥ 1, got {chunk}")
    stale = invalidate_segments(index, changed)
    ep, vb = _dense_views(index)
    dev = ep.device
    g = new_graph.to(dev)
    n, R, L = index.n, ep.shape[1], index.segment_len
    if step_impl == "stream" and blocked is None:
        blocked = blocked_csr_of(g)

    rows = torch.nonzero(stale.any(dim=1)).flatten()
    total = int(stale.sum())
    key = prng.PRNGKey(index.seed, dev)
    for lo in range(0, rows.numel(), chunk):
        sel = rows[lo:lo + chunk]
        e, m = _segment_walk_rows(g.row_ptr, g.col_idx, g.out_deg, n,
                                  step_impl, R, L, sel.to(torch.int32), key,
                                  blocked)
        keep = stale[sel]                      # write only the stale cells
        ep[sel] = torch.where(keep, e, ep[sel])
        vb[sel] = torch.where(keep[..., None], m.view(torch.int32), vb[sel])

    dense = WalkIndex(endpoints=ep, segment_len=L, seed=index.seed,
                      visited_blocks=vb.view(torch.uint32),
                      graph_epoch=new_graph.epoch,
                      mutation_offset=new_graph.mutation_offset)
    out = (shard_walk_index(dense, index.num_shards)
           if isinstance(index, ShardedWalkIndex) else dense)
    report = RefreshReport(
        epoch=new_graph.epoch, n=n,
        changed_vertices=int(np.asarray(changed).size),
        stale_rows=int(rows.numel()), stale_segments=total,
        segments_rebuilt=total, total_segments=n * R)
    return out, report


# --- epoch'd checkpoint directories ------------------------------------------


def epoch_dir(directory: str, epoch: int) -> str:
    """``<directory>/epoch_<e>`` — one walk-index checkpoint layout per
    epoch, invisible to the base layout's shard and step scanners (they
    match only ``shard_*`` / ``step_*`` names)."""
    return os.path.join(directory, f"epoch_{epoch:06d}")


def save_epoch_index(directory: str,
                     index: Union[WalkIndex, ShardedWalkIndex],
                     step: int = 0) -> str:
    """Persists ``index`` under its own epoch directory through the
    checkpoint layout (dense: one step dir; sharded: one atomic dir a
    shard), in the reference's format."""
    d = epoch_dir(directory, index.graph_epoch)
    if isinstance(index, ShardedWalkIndex):
        S = index.num_shards
        for s in range(S):
            save_walk_index_shard(
                d, s, S, index.n, index.blocks[s], index.segment_len,
                index.seed, step=step,
                visited_blocks=(None if index.visited_blocks is None
                                else index.visited_blocks[s]),
                graph_epoch=index.graph_epoch,
                mutation_offset=index.mutation_offset)
    else:
        save_walk_index(d, index, step=step)
    return d


def load_epoch_index(directory: str, epoch: int, step: Optional[int] = None,
                     reassemble: bool = True, device: DeviceLike = None
                     ) -> Union[WalkIndex, ShardedWalkIndex]:
    """Loads the slab saved for ``epoch`` onto ``device`` (default: the
    card) and checks that its manifest agrees: a directory whose contents
    claim another epoch is refused."""
    idx = load_walk_index(epoch_dir(directory, epoch), step=step,
                          reassemble=reassemble, device=device)
    if idx.graph_epoch != epoch:
        raise ValueError(
            f"{epoch_dir(directory, epoch)!r} claims graph_epoch="
            f"{idx.graph_epoch}, expected {epoch} — refusing to serve a "
            f"mislabelled slab")
    return idx


def list_epochs(directory: str):
    """Sorted epochs with a saved slab under ``directory``."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("epoch_") and os.path.isdir(
                os.path.join(directory, name)):
            try:
                out.append(int(name[len("epoch_"):]))
            except ValueError:
                continue
    return sorted(out)
