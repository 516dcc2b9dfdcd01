"""Online query engine: stitch precomputed walk segments into answers (port
of ``repro/query/engine.py``).

A walk truncated at ``t`` steps takes ``τ = min(G, t)`` moves,
``P(G = m) = p_T (1 − p_T)^m``. The engine samples ``τ`` per walk, takes
``r = τ mod L`` direct steps and then ``q = τ // L`` stitches, each
gathering a uniformly chosen precomputed endpoint of the walk's current
vertex (an exact sample of ``P^L``). Round ``j`` reads slot ``(s0 + j) mod
R`` (per-walk random ``s0``), so a walk never rereads a slab cell while
``q ≤ R``. Per-query planning inverts Theorem 1 at ``p_s = 1``.

The stitch rounds run in one launch: ``ops.stitch_gather_rounds`` for a
wave (over a dense slab or a sharded index's stacked blocks),
``ops.stitch_step_rounds`` for ``walk_wave`` / ``query_counts`` (the
rounds with their stop tally), and the wave's per-query histogram
through ``ops.frog_count``. The rounds kernels draw the slot offsets
``s0`` themselves from the wave's ``k_slot`` (``rng="device"``), and every
other draw is one ``prng`` launch on the card. Key streams are the
reference's, so positions and counts are byte-equal to ``repro.query``.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch import prng
from repro_torch.core import theory
from repro_torch.graph.csr import CSRGraph, uniform_successor
from repro_torch.kernels import ops
from repro_torch.query.index import WalkIndex


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """``(t, N)`` for one query from ``(ε, δ)``; ``epsilon_bound`` is the ε
    Theorem 1 certifies for the plan (above ``epsilon`` when a cap bound)."""

    num_walks: int
    num_steps: int
    epsilon: float               # requested
    delta: float
    k: int
    epsilon_bound: float = 0.0   # achieved (== requested iff no cap bound)

    def num_rounds(self, segment_len: int) -> int:
        """Stitch rounds needed: ``⌊t/L⌋`` (the residual covers ``t mod L``)."""
        return self.num_steps // segment_len


def plan_query(k: int, epsilon: float, delta: float = 0.1, p_T: float = 0.15,
               max_walks: Optional[int] = None, max_steps: int = 64,
               segments_per_vertex: Optional[int] = None,
               segment_len: Optional[int] = None) -> QueryPlan:
    """Inverts Theorem 1 into ``(t, N)`` at ``p_s = 1``: the mixing term
    bounds ``t`` and the ``1/N`` sampling term bounds ``N``, each at ε/2;
    with the index's ``(R, L)``, ``t`` is clamped to ``R·L + L − 1``."""
    if not (0.0 < epsilon):
        raise ValueError(f"epsilon must be positive, got {epsilon}")
    if (segments_per_vertex is None) != (segment_len is None):
        raise ValueError(
            "segments_per_vertex and segment_len come as a pair (the "
            "index's (R, L)); got only one of them")
    target = (epsilon / 2.0) ** 2 * p_T
    if target >= 1.0:
        t = 1
    else:
        t = max(1, math.ceil(math.log(target) / math.log(1.0 - p_T) - 1.0))
    t = min(t, max_steps)
    if segments_per_vertex is not None:
        t = min(t, segments_per_vertex * segment_len + segment_len - 1)
    n_walks = max(1, math.ceil(4.0 * k / (delta * epsilon**2)))
    if max_walks is not None:
        n_walks = min(n_walks, max_walks)
    achieved = theory.epsilon_bound(p_T, t, k, delta, n_walks, 1.0, 0.0)
    return QueryPlan(num_walks=n_walks, num_steps=t, epsilon=epsilon,
                     delta=delta, k=k, epsilon_bound=achieved)


def check_segment_budget(segments_per_vertex: int, num_rounds: int) -> None:
    """Warns when ``num_rounds > R``: walks may then reread slab cells and
    the stitched distribution is no longer exact."""
    if num_rounds > segments_per_vertex:
        warnings.warn(
            f"walk index has R={segments_per_vertex} segments/vertex but the "
            f"query plan needs up to {num_rounds} stitch rounds: walks may "
            f"reread segments and the stitched distribution is no longer "
            f"exact. Rebuild with segments_per_vertex ≥ {num_rounds}.",
            stacklevel=3,
        )


def sample_walk_lengths(key: torch.Tensor, num_walks: int, p_T: float,
                        max_steps: Union[int, torch.Tensor]
                        ) -> torch.Tensor:
    """``τ ~ min(Geometric(p_T), max_steps)`` per walk (int32[W])."""
    return lengths_from_uniform(prng.uniform(key, (num_walks,)), p_T,
                                max_steps)


def lengths_from_uniform(u: torch.Tensor, p_T: float,
                         max_steps: Union[int, torch.Tensor]
                         ) -> torch.Tensor:
    """``clip(floor(log u / log(1 − p_T)), 0, max_steps)`` in float32, as
    the reference computes it.

    Torch's and XLA's float32 ``log`` differ in the last bit for some
    inputs, but over all 2**23 values ``u`` can take, no length differs at
    ``p_T = 0.15`` (``tests/test_torch_query.py``). The divisor
    is a tensor on ``u``'s device so the division is a true IEEE division,
    never a multiply by a rounded reciprocal.
    """
    u = torch.maximum(u, torch.tensor(1e-12, dtype=torch.float32,
                                      device=u.device))
    c = torch.tensor(math.log(1.0 - p_T), dtype=torch.float32,
                     device=u.device)
    m = torch.floor(torch.log(u) / c).to(torch.int32)
    m = torch.clamp_min(m, 0)
    if isinstance(max_steps, torch.Tensor):
        return torch.minimum(m, max_steps.to(torch.int32))
    return torch.clamp_max(m, int(max_steps))


def _plain_steps(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                 deg: torch.Tensor, pos: torch.Tensor,
                 active_until: torch.Tensor, key: torch.Tensor,
                 num_steps: int) -> torch.Tensor:
    """``active_until[w]`` masked plain walker steps (the stitch residual)."""
    if num_steps == 0:
        return pos
    for s, k in enumerate(prng.split(key, num_steps)):
        bits = prng.randint(k, pos.shape, 0, 1 << 30)
        nxt = uniform_successor(row_ptr, col_idx, deg, pos, bits)
        pos = torch.where(s < active_until, nxt, pos)
    return pos


@dataclasses.dataclass(frozen=True)
class WaveSpec:
    """Geometry of one scheduler wave: ``(W, Q)`` are the bucket shapes
    (walk slots / query slots the operands are padded to), ``q_max`` the
    stitch-round budget, and ``(S, sz)`` the shard granularity of the
    eviction mask (``S = 1`` and ``sz = 0``, meaning ``n``, for a dense
    slab, whose mask never flips)."""

    n: int               # graph vertices (tally bins per query row)
    R: int               # segments per vertex
    L: int               # segment length
    q_max: int           # stitch rounds
    W: int               # walk-slot bucket
    Q: int               # query-slot bucket
    p_T: float           # geometric stop probability
    impl: str            # stitch backend: auto | cuda | torch
    tally_impl: str      # histogram backend: auto | cuda | torch
    S: int = 1           # shards (eviction-mask entries)
    sz: int = 0          # shard size (0: n, a dense slab)


def wave_prep(row_ptr: torch.Tensor, col_idx: torch.Tensor,
              deg: torch.Tensor, start: torch.Tensor, uniform: torch.Tensor,
              t_cap: torch.Tensor, key: torch.Tensor, *, n: int, L: int,
              p_T: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wave prologue: starts, lengths and residual steps → ``(pos
    int32[W], q int32[W], k_slot)``, ``k_slot`` the key of the slot
    offsets ``s0 = randint(k_slot, (W,), 0, 2**30)``, which the rounds
    kernel draws (``rng="device"``)."""
    W = start.shape[0]
    k_start, k_tau, k_walk = prng.split(key, 3)
    pos0 = torch.where(uniform, prng.randint(k_start, (W,), 0, n), start)
    tau = sample_walk_lengths(k_tau, W, p_T, t_cap)
    k_res, k_slot = prng.split(k_walk)
    q = tau // L
    pos = _plain_steps(row_ptr, col_idx, deg, pos0, tau % L, k_res, L)
    return pos, q, k_slot


def build_wave_program(spec: WaveSpec) -> Callable[..., torch.Tensor]:
    """The wave for ``spec``: prologue, ``q_max`` stitch rounds and one
    histogram over the wave's final positions.

    Signature of the returned function::

        wave(slab, row_ptr, col_idx, deg, start, uniform, qid, t_cap, key,
             lost=None) -> int32[Q, n]

    ``slab`` is the dense ``int32[n, R]`` slab, or a sharded index's
    stacked blocks viewed as ``int32[S·sz, R]`` (row-padded; walk positions
    are graph vertices < n ≤ S·sz, so the padding rows are never gathered,
    and gathering from the stacked blocks is byte-equal to the per-shard
    masked gather and sum of the loop wave). Walk ``w`` lands in row
    ``qid[w]`` of the tally; idle slots carry ``qid = Q`` and land in a
    discard row that is dropped.

    ``lost`` is the bool[S] eviction mask: a walk that still needs a gather
    while sitting in a lost shard's rows, or whose final vertex lies in
    one, dies (its position freezes and it lands in the discard row). An
    all-False mask leaves the counts unchanged; ``None`` (no shard lost)
    skips the mask altogether.
    """
    n, L, Q, S = spec.n, spec.L, spec.Q, spec.S
    sz = spec.sz or n

    def wave(slab, row_ptr, col_idx, deg, start, uniform, qid, t_cap, key,
             lost=None):
        pos, q, k_slot = wave_prep(row_ptr, col_idx, deg, start, uniform,
                                   t_cap, key, n=n, L=L, p_T=spec.p_T)

        # every stitch round in one launch, s0 drawn in it; the wave
        # histograms once, below
        pos, alive = ops.stitch_gather_rounds(pos, q, k_slot, slab,
                                              spec.q_max, lost, S, sz,
                                              impl=spec.impl, rng="device")
        if alive is not None:
            qid = torch.where(alive, qid, Q)     # dead walks → discard row
        counts = ops.frog_count(pos + qid * n, (Q + 1) * n,
                                impl=spec.tally_impl)
        return counts.reshape(Q + 1, n)[:Q]

    return wave


def walk_wave(row_ptr: torch.Tensor, col_idx: torch.Tensor,
              deg: torch.Tensor, endpoints: torch.Tensor, pos0: torch.Tensor,
              tau: torch.Tensor, key: torch.Tensor, segment_len: int,
              num_rounds: int, impl: str = "auto"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advances ``W`` walks by ``τ`` moves each via residual + stitching →
    ``(final_pos int32[W], stop_counts int32[n])``. Round ``j`` tallies the
    walks with ``q == j`` while gathering the next segment for the rest;
    round ``num_rounds`` only tallies. All ``num_rounds + 1`` rounds run in
    one ``ops.stitch_step_rounds`` call, which draws the slot offsets from
    ``k_slot`` itself."""
    L = segment_len
    n = deg.shape[0]
    k_res, k_slot = prng.split(key)
    q = tau // L
    pos = _plain_steps(row_ptr, col_idx, deg, pos0, tau % L, k_res, L)
    return ops.stitch_step_rounds(pos, q, k_slot, endpoints, n, num_rounds,
                                  impl=impl, rng="device")


def query_counts(g: CSRGraph, index: WalkIndex, plan: QueryPlan,
                 key: torch.Tensor, source: Optional[int] = None,
                 p_T: float = 0.15, impl: str = "auto") -> torch.Tensor:
    """Single-query stop-counter histogram ``int32[n]``: ``source=None`` →
    global top-k (uniform starts); ``source=v`` → PPR from ``v``."""
    W = plan.num_walks
    check_segment_budget(index.segments_per_vertex,
                         plan.num_rounds(index.segment_len))
    k_start, k_tau, k_walk = prng.split(key, 3)
    if source is None:
        pos0 = prng.randint(k_start, (W,), 0, g.n)
    else:
        if not 0 <= source < g.n:
            raise ValueError(f"ppr source {source} outside [0, {g.n})")
        pos0 = torch.full((W,), source, dtype=torch.int32, device=key.device)
    tau = sample_walk_lengths(k_tau, W, p_T, plan.num_steps)
    _, counts = walk_wave(
        g.row_ptr, g.col_idx, g.out_deg, index.endpoints, pos0, tau, k_walk,
        index.segment_len, plan.num_rounds(index.segment_len), impl=impl)
    return counts
