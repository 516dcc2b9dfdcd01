"""FrogWild! walker estimator (port of ``repro/core/frogwild.py``).

N frogs start uniformly at random, take at most ``t`` steps along P, die
with probability ``p_T`` at each apply() and are tallied where they stop;
π̂ = c/N (Definition 5). The key stream is the reference's, so counts and
``pi_hat`` are byte-equal to ``repro.core.frogwild`` for the same key.

* p_s = 1 (or ``erasure="none"``): every superstep, its death coins and
  slot bits included, runs through ``ops.frog_superstep``: one CUDA
  launch that draws the reference's threefry streams itself, or with
  ``step_impl="stream"`` the streamed kernel over the graph's
  :class:`BlockedCSR` slabs (built once per run or passed in).
* p_s < 1, partial synchronization as edge erasures (Definition 8, the
  blocking walk of Process 19): ``"independent"`` (Example 9, one coin per
  edge) or ``"channel"`` (one coin per (vertex, destination shard), the
  engine's mirror granularity). Each superstep's deaths are tallied
  through ``ops.frog_count`` and the survivors move by :func:`draw_next`:
  ``draw="cumsum"`` (per-edge keep mask, cumsum and searchsorted, O(nnz)),
  ``"rejection"`` (per-frog probes, ``core/blocking.py``) or ``"auto"``
  (the probes when their budget undercuts the per-edge pass).

The cut-off tally at ``t`` runs through ``ops.frog_count``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.config import FrogWildConfig
from repro_torch.core.blocking import (channel_enum_draw, coin_uniform,
                                       rejection_blocking_draw,
                                       rejection_is_profitable)
from repro_torch.device import DeviceLike
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import ops
from repro_torch.kernels.frog_step_stream import BlockedCSR, blocked_csr_of


@dataclasses.dataclass
class FrogWildResult:
    counts: torch.Tensor              # int32[n] — c(i), frogs stopped at i
    pi_hat: torch.Tensor              # f32[n]   — counts / N (Definition 5)
    num_frogs: int


def _kept_mask(key: torch.Tensor, g: CSRGraph, dst_shard: torch.Tensor,
               cfg: FrogWildConfig) -> torch.Tensor:
    """Per-edge keep mask for one superstep (the cumsum draw only)."""
    if cfg.erasure == "independent":
        return prng.bernoulli(key, cfg.p_s, (g.nnz,))
    if cfg.erasure == "channel":
        # one coin per (source vertex, destination shard)
        coins = prng.bernoulli(key, cfg.p_s, (g.n, cfg.num_shards))
        return coins[g.edge_src.long(), dst_shard.long()]
    raise ValueError(f"unknown erasure model {cfg.erasure!r}")


def _successor(g: CSRGraph, col: torch.Tensor, edge: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """``col[edge]``, or ``pos`` for a frog on a vertex of degree 0 (whose
    edge may point one past the end; the reference's gather clamps it)."""
    has = g.out_deg[pos.long()] > 0
    edge = torch.where(has, edge, 0)
    if col.numel() == 0:
        return pos
    return torch.where(has, col[edge], pos)


def draw_next_cumsum(g: CSRGraph, cfg: FrogWildConfig, key: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """One blocking-walk draw, the O(nnz) reference: the rank
    ``u % kv`` among the vertex's kept edges, found by a searchsorted over
    the cumsum of the keep mask; ``kv = 0`` takes the forced edge."""
    n = g.n
    row_ptr, deg = g.row_ptr.long(), g.out_deg
    N = pos.shape[0]
    k_mask, k_force, k_draw = prng.split(key, 3)
    kept = _kept_mask(k_mask, g, g.edge_dst_shard(cfg.num_shards), cfg)
    csum = torch.cumsum(kept, 0)                          # inclusive
    kept_before = torch.cat([csum.new_zeros(1), csum])
    pos_l = pos.long()
    lo, hi = row_ptr[pos_l], row_ptr[pos_l + 1]
    kv = kept_before[hi] - kept_before[lo]
    forced_slot = torch.remainder(
        prng.randint(k_force, (n,), 0, 1 << 30),
        torch.clamp_min(deg, 1))
    forced_edge = row_ptr[:-1] + forced_slot
    u = torch.remainder(prng.randint(k_draw, (N,), 0, 1 << 30),
                        torch.clamp_min(kv, 1))
    target = kept_before[lo] + u + 1                      # 1-indexed rank
    edge = torch.searchsorted(csum, target)
    edge = torch.where(kv > 0, edge, forced_edge[pos_l])
    return _successor(g, g.col_idx, edge, pos)


def draw_next_rejection(g: CSRGraph, cfg: FrogWildConfig, key: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
    """One blocking-walk draw in O(N) probes, independent of nnz: edge
    rejection for the independent model, the exact channel enumeration
    for the channel model."""
    if cfg.erasure == "independent":
        edge = rejection_blocking_draw(key, pos, g.row_ptr, g.out_deg,
                                       cfg.p_s, lambda v, e: e)
        return _successor(g, g.col_idx, edge, pos)
    if cfg.erasure == "channel":
        S = cfg.num_shards
        col_sorted, chan_cnt, chan_off = g.channel_layout(S)
        k_coin, k_draw = prng.split(key)
        pos_l = pos.long()
        chan_ids = pos_l[:, None] * S + torch.arange(S, device=pos.device)
        coins_open = coin_uniform(k_coin, chan_ids) < torch.tensor(
            cfg.p_s, dtype=torch.float32, device=pos.device)
        edge = channel_enum_draw(k_draw, pos, g.row_ptr[pos_l],
                                 g.out_deg[pos_l], chan_cnt[pos_l],
                                 chan_off[pos_l], coins_open)
        return _successor(g, col_sorted, edge, pos)
    raise ValueError(f"unknown erasure model {cfg.erasure!r}")


def draw_next(g: CSRGraph, cfg: FrogWildConfig, key: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """One scatter draw under ``cfg`` (int32[N] next vertices), dispatched
    on ``cfg.draw``; ``"auto"`` picks the probe draw exactly when its
    budget undercuts the O(nnz) per-edge pass."""
    draw = cfg.draw
    if draw == "auto":
        nc = cfg.num_shards if cfg.erasure == "channel" else None
        draw = ("rejection"
                if rejection_is_profitable(pos.shape[0], g.nnz, cfg.p_s, nc)
                else "cumsum")
    if draw == "cumsum":
        return draw_next_cumsum(g, cfg, key, pos)
    if draw == "rejection":
        return draw_next_rejection(g, cfg, key, pos)
    raise ValueError(f"unknown draw impl {cfg.draw!r}")


def _frogwild_walks(g: CSRGraph, cfg: FrogWildConfig, key: torch.Tensor,
                    blocked: Optional[BlockedCSR] = None) -> FrogWildResult:
    """Runs the FrogWild! process on ``g``'s device with ``key`` (a key on
    the same device) and returns the stop-counter estimator. ``blocked``
    is ``g``'s slab layout for ``step_impl="stream"`` (built here when not
    given)."""
    n = g.n
    N, t = cfg.num_frogs, cfg.num_steps
    use_erasure = cfg.erasure != "none" and cfg.p_s < 1.0
    if cfg.step_impl == "stream" and blocked is None and not use_erasure:
        blocked = blocked_csr_of(g)
    k_init, k_loop = prng.split(key)
    pos = prng.randint(k_init, (N,), 0, n)
    alive = torch.ones(N, dtype=torch.bool, device=pos.device)
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    for step_key in prng.split(k_loop, t):
        if not use_erasure:
            # the whole superstep, its draws included, in place
            ops.frog_superstep(pos, alive, counts, step_key, cfg.p_T,
                               g.row_ptr, g.col_idx, g.out_deg, n,
                               impl=cfg.step_impl, blocked=blocked)
            continue
        k_die, k_move = prng.split(step_key)
        # apply(): each arriving frog dies w.p. p_T and is tallied here.
        die = prng.bernoulli(k_die, cfg.p_T, (N,)) & alive
        counts += ops.frog_count(torch.where(die, pos, -1), n,
                                 impl=cfg.tally_impl)
        # scatter(): survivors traverse one non-erased out-edge.
        nxt = draw_next(g, cfg, k_move, pos)
        alive &= ~die
        pos = torch.where(alive, nxt, pos)
    # cut-off at t: all surviving frogs halt and are tallied (Process 15).
    counts += ops.frog_count(torch.where(alive, pos, -1), n,
                             impl=cfg.tally_impl)
    pi_hat = counts.to(torch.float32) / N
    return FrogWildResult(counts=counts, pi_hat=pi_hat, num_frogs=N)


def compiled_estimate(res: FrogWildResult) -> FrogWildResult:
    """``res`` with ``pi_hat`` as the reference's jitted entry points
    (``frogwild``, ``FrogWildService.pagerank``) return it: XLA compiles
    ``counts / N`` into a multiply by the float32 reciprocal of ``N``, which
    differs from a true division in the last bit for some counts. The
    counts are the same either way."""
    inv = torch.tensor(1.0 / res.num_frogs, dtype=torch.float32,
                       device=res.counts.device)
    return dataclasses.replace(res, pi_hat=res.counts.to(torch.float32) * inv)


def frogwild(g: CSRGraph, cfg: FrogWildConfig, seed: int = 0,
             device: DeviceLike = None) -> FrogWildResult:
    """The estimator from ``PRNGKey(seed)`` on ``device`` (default: the
    card)."""
    key = prng.PRNGKey(seed, device)
    return compiled_estimate(_frogwild_walks(g.to(key.device), cfg, key))
