"""Offline walk-segment index (port of ``repro/query/index.py``,
single-device build and persistence).

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
reference's. The build walks one range shard of ``build_shards`` at a time
through :func:`_walk_shard_rows`, which bounds the walkers (and the key
streams) alive per step to ``R · n / build_shards``;
:func:`rebuild_shard_blocks` re-walks single shards through the same
function. A segment walk is one ``ops.frog_segment_walk`` launch that
takes all L hops and draws the rows' bits itself; with
``step_impl="stream"`` it runs L launches of the streamed hop kernel over
the graph's :class:`BlockedCSR` (the service's cached one) and one of the
mask pass.
(The reference documents ``"stream"`` for its build but its jitted row
walker passes the graph as traced operands, which its ``ops.frog_step``
refuses; the port's slab equals the reference's slab built with any other
step backend.)

Persistence goes through ``checkpoint/`` atomic step directories in the
reference's layout, so an index either package wrote loads into the
other: a dense checkpoint (:func:`save_walk_index`) or one checkpoint dir
per shard (:func:`save_walk_index_shard`, ``<dir>/shard_<s>/step_<k>/``).
:func:`load_walk_index` reads both; :func:`load_or_repair_walk_index`
quarantines a corrupt, torn or missing shard and rebuilds it byte-equal
to the original build's block.

Every build also records, per segment, a bitmask over ``32 ·
_MASK_WORDS`` vertex-id blocks of ``segment_mask_block_size(n)`` ids: the
blocks of the segment's intermediate vertices (``p_1 … p_{L-1}``), stored
as ``visited_blocks`` (uint32[n, R, _MASK_WORDS] on the slab's device), so
staleness under a mutation batch (``repro_torch.dynamic``) is one bitwise
test, not a re-walk. The segment-walk kernel builds them in registers
as it walks and writes each once, byte-equal to the reference's masks,
which it builds in XLA around its step. Masks travel with the
slab: :meth:`ShardedWalkIndex.reassemble`, :func:`shard_walk_index`
(zero rows past ``n``), the savers and the loaders; an index from a
pre-epoch checkpoint has ``None``. A repaired shard carries the masks its
re-walk recorded. The ``shard_map`` build comes with the mesh (item 8c).
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import (CheckpointCorruptError, latest_step,
                                    save_checkpoint)
from repro_torch.config import WalkIndexConfig
from repro_torch.device import DeviceLike
from repro_torch.distributed.runtime import (list_shard_dirs,
                                             load_checkpoint_tree,
                                             load_shard_checkpoints,
                                             quarantine_shard_dir,
                                             save_shard_checkpoint, shard_dir)
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.frog_step_stream import BlockedCSR, blocked_csr_of
from repro_torch.kernels.ref import MASK_WORDS as _MASK_WORDS
from repro_torch.kernels.ref import segment_mask_block_size


@dataclasses.dataclass(frozen=True)
class WalkIndex:
    """Dense per-vertex walk-segment endpoints.

    Attributes:
      endpoints:   int32[n, R] — ``endpoints[v, r] ~ P^L(· | v)``.
      segment_len: L, the number of steps each stored segment advanced.
      seed:        build seed (provenance; queries use their own keys).
      visited_blocks: uint32[n, R, _MASK_WORDS] — per-segment bitmask of
                   the vertex-id blocks whose out-edges the segment
                   consumed (``None`` on indexes from pre-epoch
                   checkpoints; see the module docstring).
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
                   rows are never gathered, since walk positions are graph
                   vertices).
      segment_len: L, steps per precomputed segment.
      seed:        build seed (provenance).
      visited_blocks: uint32[S, shard_size, R, W] masks, or ``None`` (see
                   :class:`WalkIndex`).
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
        vb = self.visited_blocks
        if vb is not None:
            vb = vb.reshape(S * sz, R, vb.shape[-1])[: self.n]
        return WalkIndex(
            endpoints=self.blocks.reshape(S * sz, R)[: self.n].clone(),
            segment_len=self.segment_len, seed=self.seed, visited_blocks=vb,
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
    vb = index.visited_blocks
    if vb is not None:
        padded = torch.zeros(num_shards * sz, *vb.shape[1:], dtype=vb.dtype,
                             device=vb.device)
        padded[:n] = vb
        vb = padded.reshape(num_shards, sz, *vb.shape[1:])
    return ShardedWalkIndex(
        blocks=ep.reshape(num_shards, sz, R), n=n,
        segment_len=index.segment_len, seed=index.seed, visited_blocks=vb,
        graph_epoch=index.graph_epoch,
        mutation_offset=index.mutation_offset)


def _segment_walk_rows(row_ptr, col_idx, deg, n, step_impl, R, L, vertices,
                       key, blocked=None, out=None):
    """The one segment-walk program under every build, repair and refresh:
    walks the L-step segments of ``vertices`` (all ``R`` slots per row)
    with the per-vertex key streams ``fold_in(fold_in(key, v), l)`` →
    ``(endpoints int32[C, R], visited_blocks uint32[C, R, _MASK_WORDS])``.
    The walk is one ``ops.frog_segment_walk``, which draws the rows' bits
    and records the masks of hops ``0 … L − 2`` itself (blocks of
    ``segment_mask_block_size(n)`` ids). ``out`` is an optional pair of
    contiguous tensors of those shapes to walk in."""
    return ops.frog_segment_walk(vertices, prng.fold_in(key, vertices), R, L,
                                 row_ptr, col_idx, deg, n, impl=step_impl,
                                 out=out, blocked=blocked)


def _walk_shard_rows(g: CSRGraph, cfg: WalkIndexConfig, shard: int, sz: int,
                     key: torch.Tensor, blocked: Optional[BlockedCSR],
                     out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one per-shard program under the build and the repair: the rows
    of range shard ``shard`` (``[shard · sz, (shard + 1) · sz)``, cut at
    ``n``) → ``(int32[rows, R], uint32[rows, R, _MASK_WORDS])`` on ``g``'s
    device (or in ``out``).

    The reference walks the rows of its graph padded to a multiple of
    ``num_shards``; a padding vertex has no in-edge, so walks from the
    real vertices never reach one and walking ``g`` itself gives the same
    rows, masks included (the mask blocks are ``g.n``'s in both)."""
    lo = min(shard * sz, g.n)
    vs = torch.arange(lo, min(lo + sz, g.n), dtype=torch.int32,
                      device=g.device)
    return _segment_walk_rows(
        g.row_ptr, g.col_idx, g.out_deg, g.n, cfg.step_impl,
        cfg.segments_per_vertex, cfg.segment_len, vs, key, blocked, out)


def _check_build(g: CSRGraph, cfg: WalkIndexConfig,
                 blocked: Optional[BlockedCSR]) -> Optional[BlockedCSR]:
    if cfg.segment_len < 1:
        raise ValueError(f"segment_len must be ≥ 1, got {cfg.segment_len}")
    if cfg.step_impl == "stream" and blocked is None:
        return blocked_csr_of(g)
    return blocked


def _build_walk_index(g: CSRGraph, cfg: WalkIndexConfig,
                      key: Optional[torch.Tensor] = None,
                      blocked: Optional[BlockedCSR] = None) -> WalkIndex:
    """Builds the ``int32[n, R]`` slab on ``g``'s device, one range shard at
    a time; ``key`` defaults to ``PRNGKey(cfg.seed)`` there. ``blocked``
    is ``g``'s slab layout for ``step_impl="stream"`` (built here when not
    given)."""
    blocked = _check_build(g, cfg, blocked)
    if key is None:
        key = prng.PRNGKey(cfg.seed, g.device)
    n, R = g.n, cfg.segments_per_vertex
    sz = -(-n // cfg.num_shards)
    endpoints = torch.empty(n, R, dtype=torch.int32, device=g.device)
    masks = torch.empty(n, R, _MASK_WORDS, dtype=torch.uint32,
                        device=g.device)
    for s in range(cfg.num_shards):     # each shard walks in its rows
        lo, hi = min(s * sz, n), min((s + 1) * sz, n)
        _walk_shard_rows(g, cfg, s, sz, key, blocked,
                         out=(endpoints[lo:hi], masks[lo:hi]))
    return WalkIndex(
        endpoints=endpoints,
        segment_len=cfg.segment_len,
        seed=cfg.seed,
        visited_blocks=masks,
        graph_epoch=g.epoch,
        mutation_offset=g.mutation_offset,
    )


# --- persistence (checkpoint/ atomic step directories) ----------------------


def _i32(v: int) -> np.ndarray:
    """A scalar leaf (``int32``, shape ``[]``), as the reference's
    ``jnp.int32(v)``."""
    return np.asarray(v, np.int32)


def _index_tree(index: WalkIndex) -> dict:
    tree = {
        "endpoints": index.endpoints,
        "segment_len": _i32(index.segment_len),
        "seed": _i32(index.seed),
        "graph_epoch": _i32(index.graph_epoch),
        "mutation_offset": _i32(index.mutation_offset),
    }
    if index.visited_blocks is not None:
        tree["visited_blocks"] = index.visited_blocks
    return tree


def save_walk_index_shard(
    directory: str,
    shard: int,
    num_shards: int,
    n: int,
    block: torch.Tensor,          # int32[shard_size, R] — this shard's slab
    segment_len: int,
    seed: int,
    step: int = 0,
    *,
    visited_blocks: Optional[torch.Tensor] = None,
    graph_epoch: int = 0,
    mutation_offset: int = 0,
) -> str:
    """Atomic save of one shard's slab block through the runtime's
    per-shard checkpoint layout (``<directory>/shard_<s>/step_<k>/``): each
    shard is an independent checkpoint dir, so a sharded index is
    persisted (and repaired) one shard at a time without ever exposing a
    torn slab. ``graph_epoch`` / ``mutation_offset`` stamp the graph's
    mutation provenance; ``visited_blocks`` rides along when given."""
    block = torch.as_tensor(block).to(torch.int32)
    tree = {
        "endpoints": block,
        "segment_len": _i32(segment_len),
        "seed": _i32(seed),
        "shard": _i32(shard),
        "num_shards": _i32(num_shards),
        "n": _i32(n),
        "segments_per_vertex": _i32(block.shape[1]),
        "graph_epoch": _i32(graph_epoch),
        "mutation_offset": _i32(mutation_offset),
    }
    if visited_blocks is not None:
        tree["visited_blocks"] = visited_blocks
    return save_shard_checkpoint(directory, shard, tree, step=step)


def save_walk_index(directory: str, index: WalkIndex, step: int = 0) -> str:
    """Atomic save under ``<directory>/step_<k>/`` (checkpoint layout)."""
    return save_checkpoint(directory, step, _index_tree(index))


def load_walk_index(directory: str, step: Optional[int] = None,
                    reassemble: bool = True, device: DeviceLike = None
                    ) -> Union[WalkIndex, ShardedWalkIndex]:
    """Restores the latest (or given) index build from ``directory`` onto
    ``device`` (default: the card).

    Handles both layouts: a dense :func:`save_walk_index` checkpoint, and
    the per-shard layout (``<directory>/shard_<s>/step_<k>/``), whose
    blocks are validated (all shards present, consistent metadata).
    ``reassemble=True`` returns the dense slab; ``reassemble=False`` a
    :class:`ShardedWalkIndex` (a dense checkpoint as a single shard).
    """
    shard_dirs = list_shard_dirs(directory)
    if not shard_dirs:
        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no walk index under {directory!r}")
        tree = load_checkpoint_tree(directory, step, device)
        index = WalkIndex(
            endpoints=tree["endpoints"].to(torch.int32),
            segment_len=int(tree["segment_len"]),
            seed=int(tree["seed"]),
            visited_blocks=tree.get("visited_blocks"),
            graph_epoch=int(tree.get("graph_epoch", 0)),
            mutation_offset=int(tree.get("mutation_offset", 0)),
        )
        return index if reassemble else shard_walk_index(index, 1)

    trees = load_shard_checkpoints(directory, step, on_error="collect",
                                   device=device)
    good, bad = _split_shard_trees(directory, trees)
    meta = _shard_meta_consensus(directory, good, bad)
    if bad:
        R, L = (meta.R, meta.L) if meta is not None else ("?", "?")
        detail = "; ".join(f"{shard_dir(directory, s)}: {e}"
                           for s, e in sorted(bad.items()))
        raise CheckpointCorruptError(
            f"walk index under {directory!r} has corrupt or partial shard "
            f"checkpoints (expected int32[shard_size, R={R}] blocks of "
            f"L={L}-step segments): {detail} — quarantine and rebuild "
            f"them (load_or_repair_walk_index does both)")
    missing = sorted(set(range(meta.num_shards)) - set(good))
    if missing:
        raise FileNotFoundError(
            f"walk index under {directory!r} is missing shards {missing} "
            f"(expected {meta.num_shards} shard dirs of "
            f"int32[shard_size, R={meta.R}] blocks, L={meta.L})")
    return _assemble_sharded(good, meta, reassemble)


_ShardMeta = collections.namedtuple(
    "_ShardMeta",
    ["num_shards", "n", "L", "seed", "R", "graph_epoch", "mutation_offset"])


def _split_shard_trees(directory, trees):
    """Separates healthy shard trees from failed loads; a tree whose
    payload shape contradicts its own metadata counts as corrupt."""
    good: Dict[int, dict] = {}
    bad: Dict[int, Exception] = {}
    for s, tree in trees.items():
        if isinstance(tree, Exception):
            bad[s] = tree
            continue
        try:
            R = int(tree["segments_per_vertex"])
            ep = tree["endpoints"]
            if ep.dim() != 2 or ep.shape[1] != R:
                raise CheckpointCorruptError(
                    f"shard block has shape {tuple(ep.shape)}, metadata "
                    f"says R={R}")
            good[s] = tree
        except (KeyError, CheckpointCorruptError) as e:
            bad[s] = e if isinstance(e, CheckpointCorruptError) else (
                CheckpointCorruptError(
                    f"shard checkpoint is missing leaf {e}"))
    return good, bad


def _shard_meta_consensus(directory, good, bad):
    """Majority metadata across healthy shards; dissenting shards are
    reclassified as corrupt (moved to ``bad``). None when no healthy
    shard survives."""
    metas = {
        s: _ShardMeta(int(t["num_shards"]), int(t["n"]),
                      int(t["segment_len"]), int(t["seed"]),
                      int(t["segments_per_vertex"]),
                      int(t.get("graph_epoch", 0)),
                      int(t.get("mutation_offset", 0)))
        for s, t in good.items()
    }
    if not metas:
        return None
    consensus, _ = collections.Counter(metas.values()).most_common(1)[0]
    for s, m in metas.items():
        if m != consensus:
            bad[s] = CheckpointCorruptError(
                f"shard metadata {tuple(m)} disagrees with the "
                f"{tuple(consensus)} consensus under {directory!r}")
            del good[s]
    return consensus


def _assemble_sharded(good, meta, reassemble):
    shards = range(meta.num_shards)
    vb = None
    if all("visited_blocks" in good[s] for s in shards):
        vb = torch.stack([good[s]["visited_blocks"] for s in shards])
    sharded = ShardedWalkIndex(
        blocks=torch.stack([good[s]["endpoints"].to(torch.int32)
                            for s in shards]),
        n=meta.n, segment_len=meta.L, seed=meta.seed, visited_blocks=vb,
        graph_epoch=meta.graph_epoch, mutation_offset=meta.mutation_offset)
    return sharded.reassemble() if reassemble else sharded


def _padding_rows(g: CSRGraph, cfg: WalkIndexConfig, lo: int, hi: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's rows ``lo … hi − 1`` past ``n``: its padded graph's
    vertices, whose self-loop walks stay where they start; their masks
    hold that vertex's block bit for each recorded hop (none when ``L =
    1``, none for a block past the mask's 256)."""
    R, L = cfg.segments_per_vertex, cfg.segment_len
    pad = torch.arange(lo, hi, dtype=torch.int32, device=g.device)
    walks = torch.repeat_interleave(pad, R)
    masks = kref.hop_visits(None, walks, 0, L > 1,
                            segment_mask_block_size(g.n))
    return (walks.view(-1, R),
            masks.view(torch.uint32).view(-1, R, _MASK_WORDS))


def rebuild_shard_blocks(g: CSRGraph, cfg: WalkIndexConfig,
                         shards: List[int],
                         blocked: Optional[BlockedCSR] = None
                         ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """Re-walks just the named shards' blocks of the ``cfg.num_shards``
    range shards of ``g`` with the build's own per-shard program and key
    streams (``fold_in(PRNGKey(cfg.seed), v)``), on ``g``'s device: each
    shard one ``ops.frog_segment_walk`` launch. Returns ``{shard:
    (endpoints int32[sz, R], visited uint32[sz, R, _MASK_WORDS])}``,
    byte-equal to the reference's ``rebuild_shard_blocks``. Rows past
    ``n`` are, as there, the padded graph's vertices
    (:func:`_padding_rows`), which :func:`shard_walk_index` leaves zero
    instead; no walk reads them."""
    blocked = _check_build(g, cfg, blocked)
    sz = -(-g.n // cfg.num_shards)
    key = prng.PRNGKey(cfg.seed, g.device)
    out = {}
    for s in shards:
        ep, mk = _walk_shard_rows(g, cfg, s, sz, key, blocked)
        pad_ep, pad_mk = _padding_rows(g, cfg, s * sz + ep.shape[0],
                                       (s + 1) * sz)
        out[s] = (torch.cat([ep, pad_ep]), torch.cat([mk, pad_mk]))
    return out


def load_or_repair_walk_index(
    directory: str,
    g: CSRGraph,
    cfg: WalkIndexConfig,
    step: Optional[int] = None,
    reassemble: bool = True,
    blocked: Optional[BlockedCSR] = None,
) -> Union[WalkIndex, ShardedWalkIndex]:
    """Like :func:`load_walk_index` onto ``g``'s device, but self-healing
    for the per-shard layout: a corrupt, torn, or missing shard checkpoint
    is quarantined (``quarantine.shard_<s>``, kept for forensics,
    invisible to loaders) and its block rebuilt by
    :func:`rebuild_shard_blocks` with the original build's key stream,
    then persisted and served. Only the broken shards are re-walked.

    The dense layout has no sub-unit to repair: corruption there raises
    :class:`~repro_torch.checkpoint.CheckpointCorruptError` and the caller
    rebuilds the whole index.
    """
    if not list_shard_dirs(directory):
        return load_walk_index(directory, step, reassemble, g.device)

    trees = load_shard_checkpoints(directory, step, on_error="collect",
                                   device=g.device)
    good, bad = _split_shard_trees(directory, trees)
    meta = _shard_meta_consensus(directory, good, bad)
    if meta is None:
        # every shard is broken: fall back to the caller's config geometry
        meta = _ShardMeta(cfg.num_shards, g.n, cfg.segment_len, cfg.seed,
                          cfg.segments_per_vertex, g.epoch,
                          g.mutation_offset)
    if meta.n != g.n:
        raise ValueError(
            f"walk index under {directory!r} was built for n={meta.n} but "
            f"the service graph has n={g.n}; refusing to repair across "
            f"graphs — point checkpoint_dir elsewhere or rebuild")
    if meta.graph_epoch != g.epoch:
        raise ValueError(
            f"walk index under {directory!r} was built at graph epoch "
            f"{meta.graph_epoch} but the service graph is at epoch "
            f"{g.epoch}; a repair would mix epochs — refresh the slab "
            f"(repro_torch.dynamic.refresh_walk_index) or rebuild at the "
            f"current epoch")
    missing = sorted(set(range(meta.num_shards)) - set(good))
    broken = sorted(set(bad) | set(missing))
    if not broken:
        return _assemble_sharded(good, meta, reassemble)

    build_cfg = dataclasses.replace(
        cfg, num_shards=meta.num_shards, segments_per_vertex=meta.R,
        segment_len=meta.L, seed=meta.seed)
    rebuilt = rebuild_shard_blocks(g, build_cfg, broken, blocked)
    healthy_step = step
    if healthy_step is None:
        steps = [latest_step(shard_dir(directory, s)) for s in good]
        healthy_step = next((s for s in steps if s is not None), 0)
    for s in broken:
        if os.path.isdir(shard_dir(directory, s)):
            quarantine_shard_dir(directory, s)
        ep, mk = rebuilt[s]
        save_walk_index_shard(
            directory, s, meta.num_shards, g.n, ep, meta.L,
            meta.seed, step=healthy_step, visited_blocks=mk,
            graph_epoch=meta.graph_epoch,
            mutation_offset=meta.mutation_offset)
        good[s] = {"endpoints": ep, "visited_blocks": mk}
    return _assemble_sharded(good, meta, reassemble)
