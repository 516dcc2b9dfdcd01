"""Distributed FrogWild! over a :class:`~repro_torch.distributed.runtime.
ShardMesh`, the PowerGraph role (port of ``repro/engine/gas.py``).

Vertices are range-sharded over the mesh; each shard owns the CSR row
block of its vertices' out-edges. One superstep:

  init     frogs arrive from the previous exchange (fixed-capacity buffers);
  apply    each frog dies w.p. p_T and is tallied in its owner's counter;
  sync     each (vertex, destination-shard) channel opens w.p. p_s (the
           paper's randomized mirror synchronization, Definition 8's
           erasure at the granularity of the GraphLab patch);
  scatter  survivors redraw uniformly among the edges on open channels
           (the blocking walk, Process 19, with Example 10's repair), are
           bucketed by destination shard and exchanged in one all-to-all.

The all-to-all buffers hold a fixed number of frogs a channel; a frog past
it is dropped and counted (``overflow``). Frogs have no identity: the
payload is the destination vertex id. At p_s = 1 the death tally and the
move are one ``ops.frog_step`` launch a shard and superstep with the
caller's bits (``frog_step``, or ``frog_step_stream_sorted`` over the
shard's slabs under ``step_impl="stream"``; ``"torch"`` runs the
reference's unfused ``"xla"`` program instead); the coins, the blocking
draw, the packing and the exchange are torch ops, as the reference runs
them in XLA. Every key is the reference's (``fold_in(key, shard)``, split into
init and run keys, ``split(run, t)``), so counts and per-step statistics
equal the reference engine's byte for byte, on any spread of the shards
over ranks.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.config import EngineConfig
from repro_torch.core.blocking import (channel_enum_draw, coin_uniform,
                                       rejection_is_profitable)
from repro_torch.distributed.runtime import ShardMesh, ShardRuntime
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.partition import partition_graph
from repro_torch.kernels import ops
from repro_torch.kernels.frog_step_stream import (BlockedCSR, block_csr,
                                                  max_block_nnz, round_e_blk)

_SLOT = 1 << 30          # the slot bits' span, randint(·, 0, 2**30)


@dataclasses.dataclass(frozen=True)
class DistributedGraph:
    """Stacked per-shard CSR blocks (leading axis = shard), on the graph's
    device; the engine moves each rank's shards to its mesh's device.

    ``chan_cnt[s, v, d]`` counts vertex ``v``'s (on shard ``s``) out-edges
    into shard ``d``, the mirror structure: a (v, d) sync message is owed
    when ``v`` is active and the channel opened. ``col_sorted`` is each
    vertex's CSR segment reordered by destination shard, which the exact
    channel draw indexes through ``chan_cnt``'s prefix offsets. The slab
    fields hold the streamed step's layout (a
    :class:`~repro_torch.kernels.frog_step_stream.BlockedCSR` a shard, one
    ``E_blk`` across shards) when the graph was built with a
    ``vertex_block``.
    """

    num_shards: int
    shard_size: int                      # vertices per shard (padded)
    n: int                               # original vertex count
    nnz_max: int                         # padded edges per shard
    row_ptr: torch.Tensor                # int32[S, shard_size + 1]
    col_idx: torch.Tensor                # int32[S, nnz_max] (global dest)
    deg: torch.Tensor                    # int32[S, shard_size]
    edge_src: torch.Tensor               # int32[S, nnz_max] (local source)
    edge_dst_shard: torch.Tensor         # int32[S, nnz_max]
    chan_cnt: torch.Tensor               # int32[S, shard_size, S]
    col_sorted: torch.Tensor             # int32[S, nnz_max] (channel-sorted)
    vertex_block: int = 0                # BV (0 = no blocked layout)
    nnz_blk_max: int = 0                 # E_blk
    blk_row_off: Optional[torch.Tensor] = None  # int32[S, num_vb, BV]
    blk_deg: Optional[torch.Tensor] = None      # int32[S, num_vb, BV]
    blk_col: Optional[torch.Tensor] = None      # int32[S, num_vb, E_blk]

    @property
    def has_blocked(self) -> bool:
        return self.vertex_block > 0

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        base = (self.row_ptr, self.col_idx, self.deg, self.edge_src,
                self.edge_dst_shard, self.chan_cnt, self.col_sorted)
        if self.has_blocked:
            return base + (self.blk_row_off, self.blk_deg, self.blk_col)
        return base

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays())


@dataclasses.dataclass
class EngineResult:
    counts: torch.Tensor                # int32[n] — stop tallies (global)
    pi_hat: torch.Tensor                # f32[n]
    sent_per_step: np.ndarray           # int64[t] — frogs exchanged a step
    open_channels_per_step: np.ndarray  # int64[t] — (shard→shard) pairs used
    sync_msgs_per_step: np.ndarray      # int64[t] — (active vertex, mirror)
    overflow: int                       # frogs dropped by capacity (want 0)
    config: EngineConfig


def build_distributed_graph(g: CSRGraph, num_shards: int,
                            vertex_block: Optional[int] = None
                            ) -> DistributedGraph:
    """Splits the CSR rows into per-shard blocks of uniform padded shapes,
    on ``g``'s device. With ``vertex_block`` each shard's block is also
    laid out as the streamed step's slabs (needed by
    ``EngineConfig(step_impl="stream")``)."""
    if int(g.out_deg.min()) < 1:
        # both step paths index col_idx[row_ptr[v] + slot] unguarded: a
        # vertex of degree 0 would read a neighbour's edge
        raise ValueError(
            "engine graphs need d_out ≥ 1 everywhere; repair dangling "
            "vertices first (graph/csr.py:build_csr dangling= policy)")
    gp, part = partition_graph(g, num_shards)
    S, sz = num_shards, part.shard_size
    dev = gp.device
    rp = gp.row_ptr.long()
    bounds = rp[torch.arange(S + 1, device=dev) * sz]
    nnz_per = bounds[1:] - bounds[:-1]
    nnz_max = max(8, -(-int(nnz_per.max()) // 8) * 8)

    rows = (torch.arange(S, device=dev)[:, None] * sz
            + torch.arange(sz + 1, device=dev)[None, :])
    row_ptr = (rp[rows] - bounds[:-1, None]).to(torch.int32)
    # edge e of shard s lands at [s, e - row_ptr_global[s·sz]]
    es = gp.edge_src
    shard = es.long() // sz
    slot = shard * nnz_max + torch.arange(gp.nnz, device=dev) \
        - bounds[shard]
    col_sorted_g, cnt, _ = gp.channel_layout(S)

    def stacked(values: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(S * nnz_max, dtype=torch.int32, device=dev)
        out[slot] = values.to(torch.int32)
        return out.view(S, nnz_max)

    col_idx = stacked(gp.col_idx)
    deg = gp.out_deg.view(S, sz).clone()
    blocked = {}
    if vertex_block is not None:
        # one slab layout a shard through block_csr itself, one
        # slab width across shards
        e_blk = round_e_blk(max(max_block_nnz(row_ptr[s], sz, vertex_block)
                                for s in range(S)))
        per_shard = [block_csr(row_ptr[s], col_idx[s], deg[s], sz,
                               vertex_block=vertex_block, e_blk=e_blk)
                     for s in range(S)]
        blocked = dict(
            vertex_block=per_shard[0].vertex_block, nnz_blk_max=e_blk,
            blk_row_off=torch.stack([b.row_off for b in per_shard]),
            blk_deg=torch.stack([b.deg for b in per_shard]),
            blk_col=torch.stack([b.col for b in per_shard]))
    return DistributedGraph(
        num_shards=S, shard_size=sz, n=g.n, nnz_max=nnz_max,
        row_ptr=row_ptr, col_idx=col_idx, deg=deg,
        edge_src=stacked(es.long() - shard * sz),
        edge_dst_shard=stacked(gp.edge_dst_shard(S)),
        chan_cnt=cnt.view(S, sz, S).to(torch.int32),
        col_sorted=stacked(col_sorted_g), **blocked)


def channel_capacity(cfg: EngineConfig, S: int) -> int:
    """Expected frogs a (shard → shard) channel is N/S²; the blocking walk
    concentrates them into the open p_s fraction, hence the 1/p_s term."""
    expected = cfg.num_frogs / (S * S * max(cfg.p_s, 1e-3))
    cap = int(math.ceil(cfg.capacity_factor * max(expected, 1.0)))
    return max(8, int(math.ceil(cap / 8) * 8))


def _pack_by_shard(dest: torch.Tensor, S: int, shard_size: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Buckets frogs (global destination ids, -1 = empty; ``[..., B]``)
    into ``[..., S, cap]`` buffers → ``(buf, sent, overflow)``.

    A stable sort by destination shard, each frog's rank in its group by
    index arithmetic, frogs past ``cap`` dropped and counted: the
    reference's fixed-capacity dispatch, whose rows past ``S`` a scatter
    with ``mode="drop"`` discards; here they land in a trash row that is
    cut off."""
    lead, B = tuple(dest.shape[:-1]), dest.shape[-1]
    dev = dest.device
    valid = dest >= 0
    ds = torch.where(valid, torch.div(dest, shard_size,
                                      rounding_mode="floor"), S)
    order = torch.argsort(ds, dim=-1, stable=True)
    ds_s = torch.gather(ds, -1, order)
    dv_s = torch.gather(dest, -1, order)
    groups = torch.arange(S, dtype=ds.dtype, device=dev).expand(
        lead + (S,)).contiguous()
    first = torch.searchsorted(ds_s.contiguous(), groups, side="left")
    rank = torch.arange(B, device=dev) - torch.gather(
        first, -1, torch.clamp(ds_s, 0, S - 1).long())
    ok = (ds_s < S) & (rank < cap)
    row = torch.where(ok, ds_s.long(), S)
    col = torch.where(ok, rank, 0)
    buf = torch.full(lead + ((S + 1) * cap,), -1, dtype=torch.int32,
                     device=dev)
    buf.scatter_(-1, row * cap + col, dv_s.to(torch.int32))
    buf = buf[..., :S * cap].reshape(lead + (S, cap))
    sent = ok.sum(-1)
    return buf, sent, valid.sum(-1) - sent


def _blocking_draw_cumsum(pos_local: torch.Tensor, row_ptr: torch.Tensor,
                          col_idx: torch.Tensor, deg: torch.Tensor,
                          edge_src: torch.Tensor,
                          edge_dst_shard: torch.Tensor, coins: torch.Tensor,
                          key: torch.Tensor) -> torch.Tensor:
    """The O(nnz) reference scatter draw (per-edge mask, cumsum,
    searchsorted) over one shard's block."""
    B, sz, nnz_max = pos_local.shape[0], deg.shape[0], col_idx.shape[0]
    dev = pos_local.device
    k_force, k_draw = prng.split(key)
    rp = row_ptr.long()
    pos = pos_local.long()
    real_edge = torch.arange(nnz_max, device=dev) < rp[-1]
    kept = coins[edge_src.long(), edge_dst_shard.long()] & real_edge
    csum = torch.cumsum(kept.to(torch.int32), 0)
    kb = torch.cat([csum.new_zeros(1), csum])
    kv = kb[rp[pos + 1]] - kb[rp[pos]]
    # Example 10 repair: one uniformly chosen edge a fully blocked vertex
    forced_slot = torch.remainder(prng.randint(k_force, (sz,), 0, _SLOT),
                                  torch.clamp_min(deg, 1))
    forced_edge = rp[:-1] + forced_slot
    u = torch.remainder(prng.randint(k_draw, (B,), 0, _SLOT),
                        torch.clamp_min(kv, 1))
    target = kb[rp[pos]] + u + 1
    edge = torch.searchsorted(csum, target, side="left")
    edge = torch.where(kv > 0, edge, forced_edge[pos])
    return col_idx[edge]


def _blocking_draw(pos_local: torch.Tensor, row_ptr: torch.Tensor,
                   col_idx: torch.Tensor, deg: torch.Tensor,
                   edge_src: torch.Tensor, edge_dst_shard: torch.Tensor,
                   chan_cnt: torch.Tensor, chan_off: torch.Tensor,
                   col_sorted: torch.Tensor, coins: Optional[torch.Tensor],
                   p_s: float, key: torch.Tensor, draw: str = "rejection",
                   alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One scatter draw a frog among the edges on open channels (Process
    19), over one shard's block.

    ``rejection`` (the default) never touches per-edge state: each frog
    enumerates its ≤ S (vertex, mirror) channels against the superstep's
    coin grid (the grid the sync accounting charges, so draw and wire cost
    agree on which channels opened) and samples a kept edge exactly, O(B ·
    S) (``core/blocking.py:channel_enum_draw``)."""
    pos = pos_local.long()
    if p_s >= 1.0:
        u = prng.randint(key, (pos.shape[0],), 0, _SLOT)
        slot = torch.remainder(u, torch.clamp_min(deg[pos], 1))
        return col_idx[row_ptr[pos].long() + slot]
    if draw == "cumsum":
        return _blocking_draw_cumsum(pos_local, row_ptr, col_idx, deg,
                                     edge_src, edge_dst_shard, coins, key)
    if draw != "rejection":
        raise ValueError(f"unknown draw impl {draw!r}")
    edge = channel_enum_draw(
        key, pos_local, row_ptr[pos], deg[pos], chan_cnt[pos],
        chan_off[pos], coins[pos], skip=None if alive is None else ~alive)
    return col_sorted[edge]


def _tally(counts: torch.Tensor, idx: torch.Tensor) -> None:
    """``counts[s, idx[s, i]] += 1`` for every shard row ``s``, in place."""
    rows = torch.arange(counts.shape[0], device=counts.device)[:, None]
    flat = (idx.long() + rows * counts.shape[1]).reshape(-1)
    counts.view(-1).index_add_(0, flat, torch.ones_like(
        flat, dtype=counts.dtype))


def make_shard_body(dg: DistributedGraph, cfg: EngineConfig
                    ) -> Callable[[ShardMesh, torch.Tensor],
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """The superstep program over a rank's stacked shards: ``body(mesh,
    key)`` → ``(counts int32[S_local, shard_size], stats int64[S_local, t,
    4])``, the stats a step (frogs sent, channels used, overflow, sync
    messages)."""
    S, sz, n = dg.num_shards, dg.shard_size, dg.n
    cap = channel_capacity(cfg, S)
    B = S * cap
    t = cfg.num_steps
    f0 = cfg.num_frogs // S
    if f0 > B:
        raise ValueError(f"buffer too small: {f0} initial frogs > B={B}")
    draw_mode = cfg.draw
    if draw_mode == "auto":
        draw_mode = ("rejection"
                     if rejection_is_profitable(B, dg.nnz_max, cfg.p_s,
                                                num_channels=S)
                     else "cumsum")
    # at p_s = 1 the tally and the move are one ops.frog_step a shard;
    # "torch" keeps the reference's unfused XLA program (a scatter tally,
    # then the draw)
    use_fused = cfg.p_s >= 1.0 and cfg.step_impl != "torch"
    if cfg.step_impl in ("cuda", "stream") and cfg.p_s < 1.0:
        raise ValueError(
            f"step_impl={cfg.step_impl!r} fuses the plain (p_s = 1) step; "
            f"the blocking walk at p_s={cfg.p_s} uses the draw paths")
    if cfg.step_impl == "stream" and not dg.has_blocked:
        raise ValueError(
            "step_impl='stream' needs the blocked slab layout — build the "
            "graph with build_distributed_graph(g, S, vertex_block=...)")

    def body(mesh: ShardMesh, key: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        dev, Sl = mesh.device, mesh.shards_per_rank
        (row_ptr, col_idx, deg, edge_src, edge_dst_shard, chan_cnt,
         col_sorted, *blk) = [mesh.local(a) for a in dg.arrays()]
        blocked: List[Optional[BlockedCSR]] = [
            BlockedCSR(vertex_block=dg.vertex_block, row_off=blk[0][s],
                       deg=blk[1][s], col=blk[2][s]) if blk else None
            for s in range(Sl)]
        has_edge_to = chan_cnt > 0
        chan_off = torch.cumsum(chan_cnt, -1, dtype=torch.int32) - chan_cnt
        base = mesh.axis_index() * sz                        # int32[Sl]
        n_local = torch.clamp(n - base, 1, sz)
        k = mesh.shard_key(prng.wrap_key_data(key, dev))
        ks = prng.split(k)
        k_init, k_run = ks[:, 0], ks[:, 1]
        pos0 = base[:, None] + torch.remainder(
            prng.randint(k_init, (B,), 0, _SLOT), n_local[:, None])
        frogs = torch.where(torch.arange(B, device=dev) < f0, pos0,
                            -1).to(torch.int32)
        counts = torch.zeros(Sl, sz + 1, dtype=torch.int32, device=dev)
        stats = torch.zeros(Sl, t, 4, dtype=torch.int64, device=dev)
        p_s = torch.tensor(cfg.p_s, dtype=torch.float32, device=dev)
        chan_grid = (torch.arange(sz, dtype=torch.int32, device=dev)[:, None]
                     * S + torch.arange(S, dtype=torch.int32,
                                        device=dev)[None, :])
        step_keys = prng.split(k_run, t)                     # [Sl, t, 2]
        for i in range(t):
            valid = frogs >= 0
            v_local = torch.clamp(frogs - base[:, None], 0, sz - 1)
            kk = prng.split(step_keys[:, i].contiguous(), 3)
            k_die, k_coin, k_draw = kk[:, 0], kk[:, 1], kk[:, 2]
            # apply(): deaths tallied where they happen
            die = prng.bernoulli(k_die.contiguous(), cfg.p_T, (B,)) & valid
            if use_fused:
                # one fused pass tallies the deaths and draws the
                # successors (col_idx holds global ids, so nxt is already
                # a global destination)
                bits = prng.randint(k_draw.contiguous(), (B,), 0, _SLOT)
                nxt = torch.empty_like(frogs)
                for s in range(Sl):
                    nxt[s], dc = ops.frog_step(
                        v_local[s], die[s].to(torch.int32), bits[s],
                        row_ptr[s], col_idx[s], deg[s], sz,
                        impl=cfg.step_impl, blocked=blocked[s])
                    counts[s, :-1] += dc
            else:
                _tally(counts, torch.where(die, v_local, sz))
            alive = valid & ~die
            # <sync>: one coin a (vertex, mirror shard), a pure hash of
            # (k_coin, v·S + d), so this grid and the draw's acceptance
            # checks see the same coins
            if cfg.p_s < 1.0:
                coins = coin_uniform(k_coin[:, None, None, :],
                                     chan_grid) < p_s
            else:
                coins = torch.ones(Sl, sz, S, dtype=torch.bool, device=dev)
            # a message is owed for every (active vertex, existing mirror)
            # pair whose channel opened
            occ = torch.zeros(Sl, sz + 1, dtype=torch.int32, device=dev)
            _tally(occ, torch.where(alive, v_local, sz))
            active = occ[:, :sz] > 0
            sync_msgs = (active[:, :, None] & coins & has_edge_to).sum((1, 2))
            if use_fused:
                dest = nxt
            else:
                dest = torch.stack([_blocking_draw(
                    v_local[s], row_ptr[s], col_idx[s], deg[s], edge_src[s],
                    edge_dst_shard[s], chan_cnt[s], chan_off[s],
                    col_sorted[s], coins[s], cfg.p_s, k_draw[s],
                    draw=draw_mode, alive=alive[s]).to(torch.int32)
                    for s in range(Sl)])
            dest = torch.where(alive, dest, -1)
            buf, sent, ovf = _pack_by_shard(dest, S, sz, cap)
            open_ch = (buf >= 0).any(-1).sum(-1)
            frogs = mesh.all_to_all(buf).reshape(Sl, B)
            stats[:, i] = torch.stack([sent, open_ch, ovf, sync_msgs], -1)
        # cut-off at t: survivors halt and are tallied (Process 15)
        v_local = torch.clamp(frogs - base[:, None], 0, sz - 1)
        _tally(counts, torch.where(frogs >= 0, v_local, sz))
        return counts[:, :sz], stats

    return body


def distributed_frogwild(dg: DistributedGraph, cfg: EngineConfig,
                         mesh: ShardMesh, seed: int = 0) -> EngineResult:
    """Deprecated entry point — use :meth:`repro_torch.service.
    FrogWildService.pagerank` with a mesh (or :func:`repro_torch.service.
    batch_pagerank`). Delegates through the service, so the answer is the
    same bytes."""
    warnings.warn("distributed_frogwild is deprecated; use "
                  "FrogWildService.pagerank (see repro_torch/service.py)",
                  DeprecationWarning, stacklevel=2)
    from repro_torch import service
    return service.batch_pagerank(dg, cfg, mesh=mesh, seed=seed)


def _distributed_frogwild(dg: DistributedGraph, cfg: EngineConfig,
                          mesh: ShardMesh, seed: int = 0) -> EngineResult:
    """Runs the whole FrogWild! process on ``mesh`` and returns π̂ and the
    statistics, the same on every rank."""
    rt = ShardRuntime.for_mesh(mesh)
    if rt.num_shards != dg.num_shards:
        raise ValueError(f"mesh has {rt.num_shards} shards, graph has "
                         f"{dg.num_shards} shards")
    counts, stats = make_shard_body(dg, cfg)(
        mesh, prng.PRNGKey(seed, mesh.device))
    counts = mesh.all_gather(counts)[0][:dg.n]
    stats = mesh.psum(stats)[0].cpu().numpy()              # [t, 4]
    total = (cfg.num_frogs // dg.num_shards) * dg.num_shards
    # a true division, as the reference's eager one: on the card a Python
    # scalar divisor becomes a multiply by its reciprocal, off by one ulp
    # for some counts, so the divisor is a tensor on the counts' device
    total_t = torch.tensor(float(total), dtype=torch.float32,
                           device=counts.device)
    return EngineResult(
        counts=counts, pi_hat=counts.to(torch.float32) / total_t,
        sent_per_step=stats[:, 0].astype(np.int64),
        open_channels_per_step=stats[:, 1].astype(np.int64),
        sync_msgs_per_step=stats[:, 3].astype(np.int64),
        overflow=int(stats[:, 2].sum()), config=cfg)
