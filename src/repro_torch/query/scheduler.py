"""Host-side continuous-batching query scheduler on one device (port of
the single-device paths of ``repro/query/scheduler.py``).

Each wave: queued queries claim free query slots earliest deadline first
(admit); walk slots are split fairly among active queries, shares and
leftovers handed out in EDF order (allocate); one wave advances every walk
and histograms endpoints into per-query rows (execute); queries whose walk
budget completed, or whose anytime Theorem 1 bound reached ε with
``early_stop``, finalize their top-k and free their slot (retire).

Waves run at the smallest bucket of a ladder of shapes (walk slots × query
slots) that fits the allocation, as in the reference; query slots are
compacted into rows ``[0, Q_b)`` in EDF order. Admission is deadline- and
queue-depth-aware: a request with ``slo_s`` is checked against the measured
wave time, charged for the admitted walk demand that outranks it, and
rejected or (``allow_downgrade``) shrunk with the weaker guarantee recorded
in ``QueryPlan.epsilon_bound``.

The index is dense (:class:`WalkIndex`, dispatch ``"gathered"``) or
sharded (:class:`ShardedWalkIndex`), and a sharded one is served in one of
two ways, as the reference serves it on one device:

* ``"fused"`` — the gathered wave over the stacked blocks viewed as the
  row-padded ``[S·sz, R]`` slab (no copy): every stitch round in one
  ``stitch_gather_rounds`` launch;
* ``"loop"`` — every stitch round in one ``stitch_gather_local_rounds``
  launch that reads each shard's block as a tensor of its own, through a
  table of block pointers; per wave, one shard-local histogram per shard.
  The reference keeps it as the structural twin the fused wave is
  byte-compared against (there one ``stitch_gather_local`` call per shard
  per round, the contributions summed).

Every wave takes the bool[S] eviction mask ``lost``, ``None`` while no
shard is lost. The key stream, bucket choice and allocation are the
reference's, so results are byte-equal to ``repro.query.scheduler`` for
the same seed, on every dispatch.

**Supervision** (the reference's degradation contract, without its mesh):

* a **transient** fault or a wave over ``wave_timeout_s`` is retried, at
  most ``max_retries`` times after an exponential backoff with seeded
  jitter, from the *same* wave key, so a retry that succeeds is
  byte-equal to an unfaulted wave; a wave over its deadline is discarded,
  never interrupted (its time ends with the host copy of the counts, so
  it includes the device's work). Retries that run out raise
  :class:`WaveFailedError` with nothing tallied (the reference's
  behaviour off a mesh; its mesh → host-loop failover comes with the mesh,
  ``ROADMAP.md`` Queue 1 item 8c);
* a **permanent** shard fault evicts the shard: later waves drop the walks
  that need a gather from, or end in, its rows; scores renormalize by the
  walks that completed, and ``epsilon_bound`` widens to exactly the ε
  Theorem 1 certifies for them. Results carry ``degraded`` /
  ``shards_lost`` / ``walks_lost``, and queued SLO work is re-admitted
  against the shrunken capacity;
* faulted, stalled, retried and degraded waves never feed the admission
  wave-time EMA, and clean outliers are clamped.

The eviction mask lives on the host (``_lost``); its device copy and the
loop wave's block table (an evicted shard's entry null) are built once an
eviction, not once a wave, and no wave reads the mask back from the
device. With no shard lost the waves are those of an unsupervised
scheduler, byte for byte. :class:`~repro_torch.distributed.faults.
FaultPlan` drives all of it deterministically in-process.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import random
import time
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.config import SHARDED_DISPATCHES
from repro_torch.core import theory
from repro_torch.distributed.faults import (FaultEvent, FaultInjector,
                                            ShardFault, WaveFailedError,
                                            WaveTimeout)
from repro_torch.distributed.runtime import ShardRuntime
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import ops
from repro_torch.query.engine import (QueryPlan, WaveSpec, build_wave_program,
                                      plan_query, wave_prep)
from repro_torch.query.index import ShardedWalkIndex, WalkIndex

# A "clean" wave more than this factor above the EMA is clamped before the
# fold — one GC pause must not trip SLO rejections.
_EMA_OUTLIER_CLAMP = 4.0


def _topk_stable(scores: np.ndarray, k: int) -> np.ndarray:
    """First ``k`` indices of ``np.argsort(-scores, kind="stable")`` without
    sorting all ``n`` scores (sparse support: sort only the nonzeros; dense:
    ``np.partition`` to the k-th largest, then sort the candidates)."""
    n = scores.shape[0]
    if k >= n:
        return np.argsort(-scores, kind="stable")[:k]
    nz = np.flatnonzero(scores)
    if nz.size <= n >> 2 and (nz.size == 0 or scores[nz].min() > 0):
        top = nz[np.argsort(-scores[nz], kind="stable")][:k]
        if top.size == k:
            return top
        pad = np.setdiff1d(np.arange(min(n, k + nz.size)),
                           nz)[:k - top.size]
        return np.concatenate([top, pad])
    kth = np.partition(scores, n - k)[n - k]
    cand = np.flatnonzero(scores >= kth)
    return cand[np.argsort(-scores[cand], kind="stable")][:k]


@dataclasses.dataclass
class QueryRequest:
    rid: int
    kind: str = "topk"               # "topk" | "ppr"
    k: int = 10
    source: int = 0                  # PPR start vertex (ignored for topk)
    epsilon: float = 0.3
    delta: float = 0.1
    num_walks: Optional[int] = None  # override the (ε, δ) plan's walk count
    slo_s: Optional[float] = None    # latency SLO (deadline = submit + slo_s)
    allow_downgrade: bool = False    # shrink the plan to fit the SLO budget
    early_stop: bool = False         # finish once the anytime bound hits ε
    t_submit: Optional[float] = None  # stamped by submission


class RejectReason(str, enum.Enum):
    """Why admission refused a request (``SHARD_LOSS``: the re-check after
    a shard eviction shrank capacity)."""

    NONE = "none"
    INFEASIBLE_SLO = "infeasible_slo"
    CAPACITY = "capacity"
    SHARD_LOSS = "shard_loss"


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """What admission did with a request: dropped (``admitted=False``, the
    kind of refusal in ``reason_code``), or admitted, possibly with a
    clamped walk count recorded in ``plan.epsilon_bound``."""

    rid: int
    admitted: bool
    reason: str = ""
    reason_code: RejectReason = RejectReason.NONE
    downgraded: bool = False
    plan: Optional[QueryPlan] = None
    num_walks: int = 0


@dataclasses.dataclass
class QueryResult:
    rid: int
    kind: str
    vertices: np.ndarray             # int64[k] — estimated top-k
    scores: np.ndarray               # f64[k]  — π̂ / PPR estimates
    num_walks: int                   # walks actually executed (≤ budget)
    num_steps: int
    waves: int                       # device waves this query spanned
    latency_s: float
    epsilon_bound: float = 0.0       # the ε Theorem 1 certifies for (t, N)
    downgraded: bool = False
    met_slo: Optional[bool] = None   # None when no SLO was requested
    early_stopped: bool = False
    degraded: bool = False           # some walks died on evicted shards
    shards_lost: Tuple[int, ...] = ()  # shards evicted while this query ran
    walks_lost: int = 0              # allocated walks that never tallied
    epoch: int = 0


@dataclasses.dataclass(frozen=True)
class QueryPartial:
    """Anytime snapshot; ``epsilon_bound`` is the ε certified for the walks
    tallied so far (``inf`` before the first wave)."""

    rid: int
    kind: str
    k: int
    vertices: np.ndarray
    scores: np.ndarray
    walks_done: int
    waves: int
    epsilon_bound: float
    done: bool
    degraded: bool = False
    shards_lost: Tuple[int, ...] = ()
    walks_lost: int = 0


@dataclasses.dataclass(frozen=True)
class SchedulerStats:
    """One snapshot of serving and admission state."""

    queued: int
    active: int
    finished: int
    rejected: int
    cancelled: int
    backlog_walks: int               # queued + in-flight walk demand
    waves_run: int
    walks_executed: int
    wave_time_ema_s: Optional[float]
    wave_occupancy: float            # allocated walk slots / capacity
    lost_shards: Tuple[int, ...]
    max_walks: int
    max_queries: int
    t_last_wave: Optional[float] = None
    last_wave_s: Optional[float] = None
    epoch: int = 0


@dataclasses.dataclass
class _Queued:
    req: QueryRequest
    plan: QueryPlan
    walks: int
    deadline: float                  # math.inf when no SLO
    downgraded: bool


@dataclasses.dataclass
class _Active:
    req: QueryRequest
    plan: QueryPlan
    remaining: int
    counts: np.ndarray               # int64[n] accumulator
    waves: int
    t_submit: float
    deadline: float
    downgraded: bool
    executed: int = 0                # walks whose tallies have landed
    lost: int = 0                    # allocated walks that died on lost shards
    shards_lost: Tuple[int, ...] = ()  # evicted shards seen by this query


class QueryScheduler:
    """Fixed-slot continuous batching over a dense :class:`WalkIndex` or a
    :class:`ShardedWalkIndex` on the graph's device, each wave run under
    the fault supervisor (``fault_injector`` and the timeout, retry and
    backoff settings)."""

    def __init__(self, g: CSRGraph, index: Union[WalkIndex,
                                                 ShardedWalkIndex],
                 max_walks: int = 8192, max_queries: int = 8,
                 max_steps: int = 32, p_T: float = 0.15, impl: str = "auto",
                 tally_impl: str = "auto", seed: int = 0,
                 runtime: Optional[ShardRuntime] = None,
                 wave_time_estimate_s: Optional[float] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 wave_timeout_s: Optional[float] = None,
                 max_retries: int = 2, backoff_base_s: float = 0.02,
                 backoff_max_s: float = 0.5,
                 sharded_dispatch: str = "fused",
                 walk_buckets: Optional[Tuple[int, ...]] = None,
                 query_buckets: Optional[Tuple[int, ...]] = None):
        if sharded_dispatch not in SHARDED_DISPATCHES:
            raise ValueError(
                f"sharded_dispatch must be 'fused' or 'loop', got "
                f"{sharded_dispatch!r}")
        sharded = isinstance(index, ShardedWalkIndex)
        if not sharded and not isinstance(index, WalkIndex):
            raise TypeError(f"index must be a WalkIndex or a "
                            f"ShardedWalkIndex, got {type(index).__name__}")
        slab = index.blocks if sharded else index.endpoints
        if slab.device != g.device:
            raise ValueError(f"graph on {g.device}, slab on {slab.device}")
        self.g = g
        self.index = index
        self.epoch = g.epoch
        self.max_walks = max_walks
        self.max_queries = max_queries
        self.max_steps = max_steps
        self.p_T = p_T
        self.impl = impl
        self.tally_impl = tally_impl
        if sharded:
            self.runtime = (runtime if runtime is not None
                            else ShardRuntime.acquire(index.num_shards))
            if self.runtime.num_shards != index.num_shards:
                raise ValueError(
                    f"runtime has {self.runtime.num_shards} shards, index "
                    f"has {index.num_shards}")
            self._S, self._sz = index.num_shards, index.shard_size
            # the stacked blocks are the row-padded dense slab: a view
            self._slab = slab.view(self._S * self._sz,
                                   index.segments_per_vertex)
            self.dispatch = sharded_dispatch
        else:
            self.runtime = runtime
            self._S, self._sz = 1, g.n
            self._slab = slab
            self.dispatch = "gathered"   # the fused wave at S = 1
        # --- fault supervision ---
        self._injector = fault_injector
        self.wave_timeout_s = wave_timeout_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.lost_shards: Set[int] = set()
        self.fault_log: List[FaultEvent] = []
        self._backoff_rng = random.Random(seed)
        # the bool[S] eviction mask on the host (a dense slab's is 1 wide
        # and never flips), its device copy (None while no shard is lost)
        # and the loop wave's block table, both rebuilt at an eviction
        self._lost = np.zeros(self._S, bool)
        self._lost_dev: Optional[torch.Tensor] = None
        self._table: Optional[ops.BlockTable] = None
        self._walk_ladder = self._normalize_buckets(
            walk_buckets, max_walks, "walk_buckets",
            floor=max(1, max_walks // 8))
        self._query_ladder = self._normalize_buckets(
            query_buckets, max_queries, "query_buckets", floor=1)
        self._wave_fns: Dict[Tuple[int, int], object] = {}
        self.queue: List[_Queued] = []
        self.active: Dict[int, _Active] = {}
        self.finished: List[QueryResult] = []
        self.rejected: List[AdmissionDecision] = []
        self.cancelled: List[int] = []
        self._key = prng.PRNGKey(seed, g.device)
        self._wave_time = wave_time_estimate_s   # EMA of measured wave s
        self._waves_run = 0
        self._walks_allocated = 0
        self._walks_executed = 0
        self._t_last_wave: Optional[float] = None
        self._last_wave_s: Optional[float] = None

    # --- wave programs (one per ladder bucket) ---------------------------

    @property
    def _q_max(self) -> int:
        return self.max_steps // self.index.segment_len

    @staticmethod
    def _normalize_buckets(buckets: Optional[Tuple[int, ...]], cap: int,
                           name: str, floor: int) -> Tuple[int, ...]:
        """A user ladder, validated, or the default: ``cap`` and its
        halvings down to ``floor``. ``cap`` is always a member."""
        if buckets is None:
            out = {cap}
            b = cap
            while b // 2 >= floor:
                b //= 2
                out.add(b)
            return tuple(sorted(out))
        ladder = sorted(set(int(b) for b in buckets))
        if not ladder or ladder[0] < 1 or ladder[-1] > cap:
            raise ValueError(
                f"{name} must be within [1, {cap}], got {buckets!r}")
        if ladder[-1] != cap:
            ladder.append(cap)
        return tuple(ladder)

    @staticmethod
    def _bucket(ladder: Tuple[int, ...], demand: int) -> int:
        """Smallest ladder bucket ≥ demand (the ladder top bounds demand)."""
        for b in ladder:
            if b >= demand:
                return b
        return ladder[-1]

    def _spec(self, W_b: int, Q_b: int) -> WaveSpec:
        return WaveSpec(
            n=self.g.n, R=self.index.segments_per_vertex,
            L=self.index.segment_len, q_max=self._q_max, W=W_b, Q=Q_b,
            p_T=self.p_T, impl=self.impl, tally_impl=self.tally_impl,
            S=self._S, sz=self._sz)

    def _wave_for(self, W_b: int, Q_b: int):
        """The wave for one ladder bucket, ``wave(start, uniform, qid,
        t_cap, key, lost, lost_host=None) -> int32[Q_b, n]`` on the host;
        ``lost`` is the bool[S] eviction mask on the device, or ``None``
        when no shard is lost, and ``lost_host`` its values on the host
        (the loop wave reads ``lost`` back without them)."""
        fn = self._wave_fns.get((W_b, Q_b))
        if fn is None:
            if self.dispatch == "loop":
                fn = self._build_loop_wave(W_b, Q_b)
            else:
                fn = self._build_fused_wave(W_b, Q_b)
            self._wave_fns[(W_b, Q_b)] = fn
        return fn

    def _build_fused_wave(self, W_b: int, Q_b: int):
        """The gathered wave (dense slab, or the stacked blocks' view)."""
        prog = build_wave_program(self._spec(W_b, Q_b))
        g, slab = self.g, self._slab

        def wave(start, uniform, qid, t_cap, key, lost, lost_host=None):
            return prog(slab, g.row_ptr, g.col_idx, g.out_deg, start,
                        uniform, qid, t_cap, key, lost).cpu().numpy()

        return wave

    def _shard_tally(self, pos: torch.Tensor, qid: torch.Tensor, base: int,
                     Q: int) -> torch.Tensor:
        """Shard-local histogram ``int32[Q, sz]``: walks whose final vertex
        the shard owns land in their query row; other shards' walks and
        idle slots (``qid == Q``) go to a discard bin."""
        sz = self._sz
        local = pos.long() - base
        mine = (local >= 0) & (local < sz)
        bins = torch.where(mine, qid * sz + torch.clamp(local, 0, sz - 1),
                           (Q + 1) * sz).to(torch.int32)
        counts = ops.frog_count(bins, (Q + 1) * sz + 1,
                                impl=self.tally_impl)
        return counts[: (Q + 1) * sz].reshape(Q + 1, sz)[:Q]

    def _block_table(self) -> ops.BlockTable:
        """The loop wave's table of the shard blocks, an evicted shard's
        entry null (never read); built at the first loop wave and again
        after each eviction."""
        if self._table is None:
            self._table = ops.block_table(
                [None if s in self.lost_shards else b
                 for s, b in enumerate(self.index.blocks)])
        return self._table

    def _build_loop_wave(self, W_b: int, Q_b: int):
        """The per-shard wave on one device: one gather launch over the
        ``S`` blocks, each read as its own tensor through the scheduler's
        table of block pointers, and one shard-local histogram per shard
        that is not lost. Lost shards' blocks are never read: the walks
        that would need them are dead."""
        rt, g, index = self.runtime, self.g, self.index
        Q, sz = Q_b, self._sz

        def wave(start, uniform, qid, t_cap, key, lost, lost_host=None):
            pos, q, k_slot = wave_prep(g.row_ptr, g.col_idx, g.out_deg,
                                       start, uniform, t_cap, key, n=g.n,
                                       L=index.segment_len, p_T=self.p_T)
            if lost is not None and lost_host is None:
                lost_host = lost.tolist()
            pos, alive = ops.stitch_gather_local_rounds(
                pos, q, k_slot, self._block_table(), self._q_max, lost,
                impl=self.impl, lost_host=lost_host, rng="device")
            if alive is not None:
                qid = torch.where(alive, qid, Q)  # dead walks → discard bin
            parts = rt.map_shards(
                lambda s: (torch.zeros(Q, sz, dtype=torch.int32,
                                       device=pos.device)
                           if lost_host is not None and lost_host[s]
                           else self._shard_tally(pos, qid, s * sz, Q)))
            out = torch.stack(parts, dim=1).reshape(Q, -1)[:, : g.n]
            return out.cpu().numpy()

        return wave

    # --- admission (deadline-aware) --------------------------------------

    def _submit(self, req: QueryRequest) -> AdmissionDecision:
        """Validates, plans, and admission-checks a request. The latency
        clock starts here, so queue wait counts toward the SLO."""
        if req.num_walks is not None and req.num_walks <= 0:
            raise ValueError(
                f"request {req.rid}: num_walks must be positive, got "
                f"{req.num_walks}")
        if req.kind == "ppr" and not (0 <= req.source < self.g.n):
            raise ValueError(
                f"request {req.rid}: ppr source {req.source} outside "
                f"[0, {self.g.n})")
        if req.kind not in ("topk", "ppr"):
            raise ValueError(f"request {req.rid}: unknown kind {req.kind!r}")
        if req.slo_s is not None and req.slo_s <= 0:
            raise ValueError(
                f"request {req.rid}: slo_s must be positive, got {req.slo_s}")
        if req.t_submit is None:
            req.t_submit = time.perf_counter()

        plan = plan_query(
            req.k, req.epsilon, req.delta, p_T=self.p_T,
            max_steps=self.max_steps,
            segments_per_vertex=self.index.segments_per_vertex,
            segment_len=self.index.segment_len)
        walks = req.num_walks if req.num_walks is not None else plan.num_walks
        downgraded = False

        if req.slo_s is not None and self._wave_time is not None:
            # Remaining wave budget under the SLO at full throughput,
            # charged for the admitted demand whose deadline is at or
            # before this one's (EDF drains it first; no-SLO work is never
            # charged).
            deadline_new = req.t_submit + req.slo_s
            backlog = (sum(e.walks for e in self.queue
                           if e.deadline <= deadline_new)
                       + sum(a.remaining for a in self.active.values()
                             if a.deadline <= deadline_new))
            feasible = int(req.slo_s / self._wave_time)
            eff = self._effective_walks()
            needed = -(-(walks + backlog) // eff)
            if feasible < 1:
                return self._reject(
                    req, plan,
                    f"SLO {req.slo_s:.3g}s is shorter than one wave "
                    f"(≈{self._wave_time:.3g}s)",
                    RejectReason.INFEASIBLE_SLO)
            if needed > feasible:
                budget = feasible * eff - backlog
                if not req.allow_downgrade or budget < 1:
                    return self._reject(
                        req, plan,
                        f"plan needs {needed} waves ({backlog} walks "
                        f"queued ahead at earlier deadlines), only "
                        f"{feasible} fit the {req.slo_s:.3g}s SLO",
                        RejectReason.CAPACITY)
                plan = plan_query(
                    req.k, req.epsilon, req.delta, p_T=self.p_T,
                    max_walks=budget, max_steps=self.max_steps,
                    segments_per_vertex=self.index.segments_per_vertex,
                    segment_len=self.index.segment_len)
                walks = min(budget, plan.num_walks if req.num_walks is None
                            else req.num_walks)
                downgraded = True

        deadline = (math.inf if req.slo_s is None
                    else req.t_submit + req.slo_s)
        self.queue.append(_Queued(req=req, plan=plan, walks=walks,
                                  deadline=deadline, downgraded=downgraded))
        return AdmissionDecision(rid=req.rid, admitted=True,
                                 downgraded=downgraded, plan=plan,
                                 num_walks=walks)

    def _reject(self, req: QueryRequest, plan: QueryPlan, reason: str,
                code: RejectReason) -> AdmissionDecision:
        decision = AdmissionDecision(rid=req.rid, admitted=False,
                                     reason=reason, reason_code=code,
                                     plan=plan)
        self.rejected.append(decision)
        return decision

    # --- host scheduling --------------------------------------------------

    def _admit(self) -> None:
        """Queued queries claim free slots, earliest deadline first."""
        free = [s for s in range(self.max_queries) if s not in self.active]
        self.queue.sort(key=lambda e: (e.deadline, e.req.t_submit))
        while self.queue and free:
            e = self.queue.pop(0)
            self.active[free.pop(0)] = _Active(
                req=e.req, plan=e.plan, remaining=e.walks,
                counts=np.zeros(self.g.n, np.int64),
                waves=0, t_submit=e.req.t_submit, deadline=e.deadline,
                downgraded=e.downgraded,
            )

    def _edf_order(self) -> List[int]:
        return sorted(self.active,
                      key=lambda s: (self.active[s].deadline, s))

    def _allocate(self) -> Dict[int, int]:
        """Walk-slot split: equal shares, handed out (and topped up from
        the leftovers) in earliest-deadline-first order."""
        slots = {}
        budget = self.max_walks
        order = self._edf_order()
        share = max(1, budget // max(1, len(order)))
        for s in order:
            take = min(self.active[s].remaining, share, budget)
            slots[s] = take
            budget -= take
        for s in order:                      # leftovers, EDF-greedy
            if budget == 0:
                break
            extra = min(self.active[s].remaining - slots[s], budget)
            slots[s] += extra
            budget -= extra
        return {s: w for s, w in slots.items() if w > 0}

    def step_wave(self) -> bool:
        """Runs one wave; returns False when nothing is in flight. The wave
        runs at the smallest ladder bucket that fits the allocation."""
        self._admit()
        if not self.active:
            return False
        alloc = self._allocate()
        W_b = self._bucket(self._walk_ladder, sum(alloc.values()))
        Q_b = self._bucket(self._query_ladder, len(alloc))
        start = np.zeros(W_b, np.int32)
        uniform = np.zeros(W_b, bool)
        qid = np.full(W_b, Q_b, np.int32)    # default: discard row
        t_cap = np.zeros(W_b, np.int32)
        cursor = 0
        for ci, (s, w) in enumerate(alloc.items()):
            a = self.active[s]
            sl = slice(cursor, cursor + w)
            qid[sl] = ci
            t_cap[sl] = a.plan.num_steps
            if a.req.kind == "ppr":
                start[sl] = a.req.source
            else:
                uniform[sl] = True
            cursor += w

        self._key, k_wave = prng.split(self._key)
        counts, clean, dt = self._run_wave(start, uniform, qid, t_cap,
                                           k_wave, W_b, Q_b)
        now = time.perf_counter()
        self._walks_allocated += sum(alloc.values())
        # EMA of measured wave time for admission. The first wave includes
        # the kernel build and is never folded in, nor is a wave that saw a
        # fault, stall, retry or eviction; clean outliers are clamped.
        self._waves_run += 1
        self._t_last_wave = time.monotonic()
        self._last_wave_s = dt
        if self._waves_run > 1 and clean:
            if self._wave_time is not None:
                dt = min(dt, _EMA_OUTLIER_CLAMP * self._wave_time)
            self._wave_time = (dt if self._wave_time is None
                               else 0.5 * self._wave_time + 0.5 * dt)

        for ci, (s, w) in enumerate(alloc.items()):
            a = self.active[s]
            row = counts[ci]
            # every surviving walk lands in one bin, so the row sum is the
            # slot's landed count; the rest died on a lost shard
            landed = int(row.sum())
            a.counts += row
            a.remaining -= w
            a.executed += landed
            self._walks_executed += landed
            a.waves += 1
            if landed < w:
                a.lost += w - landed
                a.shards_lost = tuple(sorted(self.lost_shards))
            early = (a.remaining > 0 and a.req.early_stop
                     and self.anytime_bound(a.plan.num_steps, a.req.k,
                                            a.req.delta, a.executed)
                     <= a.req.epsilon)
            if a.remaining == 0 or early:
                self.finished.append(self._finalize(a, now, early=early))
                del self.active[s]
        return True

    # --- wave supervision (fault tolerance) -------------------------------

    def _run_wave(self, start, uniform, qid, t_cap, k_wave, W_b, Q_b):
        """Runs one wave from host operands under supervision → ``(counts
        int[Q_b, n], clean, wall seconds)``; the host copy of the counts
        ends the timed region.

        The injector's hooks fire first. A transient fault or a timeout is
        retried from the same key (a retry that succeeds is byte-equal),
        after a backoff; a permanent shard fault evicts the shard and
        re-runs degraded (not a retry). ``clean`` is False for a wave that
        saw a fault, stall, retry or eviction."""
        wave_no = self._waves_run
        attempt = 0
        clean = True
        if self._injector is not None:
            for shard in self._injector.shard_losses_at(wave_no):
                clean = False
                self._evict_shard(shard, wave_no)
        dev = self.g.device
        while True:
            t0 = time.perf_counter()
            try:
                if self._injector is not None:
                    stall = self._injector.stall_s(wave_no)
                    if stall:
                        clean = False
                        time.sleep(stall)
                    kind = self._injector.fail_attempt(wave_no, attempt)
                    if kind == "timeout":
                        raise WaveTimeout(
                            f"injected hang (wave {wave_no}, attempt "
                            f"{attempt})")
                    if kind == "transient":
                        raise ShardFault(
                            f"injected transient fault (wave {wave_no}, "
                            f"attempt {attempt})", transient=True)
                counts = self._wave_for(W_b, Q_b)(
                    *(torch.from_numpy(a).to(dev)
                      for a in (start, uniform, qid, t_cap)), k_wave,
                    self._lost_dev, self._lost if self.lost_shards else None)
                dt = time.perf_counter() - t0
                if (self.wave_timeout_s is not None
                        and dt > self.wave_timeout_s):
                    raise WaveTimeout(
                        f"wave {wave_no} took {dt:.3g}s > wave_timeout_s="
                        f"{self.wave_timeout_s:.3g}s — result discarded")
                return counts, clean, dt
            except ShardFault as e:
                clean = False
                if not e.transient:
                    if e.shard is None:
                        raise WaveFailedError(
                            f"wave {wave_no}: permanent fault named no "
                            f"shard to evict: {e}") from e
                    self._evict_shard(e.shard, wave_no)
                    continue        # degraded re-run, not a retry
                attempt = self._count_retry(wave_no, attempt, e)
            except WaveTimeout as e:
                clean = False
                attempt = self._count_retry(wave_no, attempt, e)

    def _count_retry(self, wave_no: int, attempt: int,
                     err: Exception) -> int:
        """Charges one retry; past ``max_retries`` gives up with
        :class:`WaveFailedError` (one device: no failover path)."""
        attempt += 1
        self.fault_log.append(FaultEvent(
            kind="retry", wave=wave_no, attempt=attempt, detail=str(err)))
        if attempt > self.max_retries:
            raise WaveFailedError(
                f"wave {wave_no} failed after {attempt} attempts "
                f"(max_retries={self.max_retries}, no failover path left): "
                f"{err}") from err
        time.sleep(self._backoff_s(attempt))
        return attempt

    def _backoff_s(self, attempt: int) -> float:
        """Exponential backoff with ×[0.5, 1.5) seeded jitter."""
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2 ** (attempt - 1)))
        return base * (0.5 + self._backoff_rng.random())

    def _evict_shard(self, shard: int, wave_no: int) -> None:
        """Permanently removes a shard from serving: flips its bit of the
        host mask, builds the mask's device copy and drops the loop wave's
        block table (later waves drop walks touching its rows), and re-runs
        admission for queued SLO work against the shrunken capacity.
        Evicting the last shard is unservable and raises."""
        if not isinstance(self.index, ShardedWalkIndex):
            raise WaveFailedError(
                f"shard {shard} reported lost but the slab is dense — "
                f"gathered serving has no shard granularity to degrade to; "
                f"rebuild the index")
        S = self.index.num_shards
        if not (0 <= shard < S):
            raise ValueError(f"lost shard {shard} outside [0, {S})")
        if shard in self.lost_shards:
            return
        if len(self.lost_shards) + 1 >= S:
            raise WaveFailedError(
                f"shard {shard} lost but shards "
                f"{sorted(self.lost_shards)} are already evicted — no "
                f"shard left to serve from; rebuild the index")
        self.lost_shards.add(shard)
        self._lost[shard] = True
        self._lost_dev = torch.tensor(self._lost, device=self.g.device)
        self._table = None
        self.fault_log.append(FaultEvent(
            kind="shard_loss", wave=wave_no, shard=shard))
        self._readmit_queued(wave_no)

    def _effective_walks(self) -> int:
        """Walks the admission model charges per wave: losing shards kills
        the walks that land in their ranges, so full-machine throughput
        shrinks by the surviving-shard fraction (first-order — endpoint
        mass is roughly balanced across range shards)."""
        if isinstance(self.index, ShardedWalkIndex) and self.lost_shards:
            S = self.index.num_shards
            return max(1, int(self.max_walks * (S - len(self.lost_shards))
                              / S))
        return self.max_walks

    def _readmit_queued(self, wave_no: int) -> None:
        """Re-runs admission for queued SLO work after capacity shrank.

        Every queued deadline entry is re-checked (EDF order) against the
        post-eviction effective throughput: still-feasible work stays,
        downgradable work is re-clamped, and the rest moves to
        ``rejected`` — an honest late rejection instead of a silent SLO
        miss discovered at the deadline. No-SLO work is untouched."""
        if self._wave_time is None or not self.queue:
            return
        now = time.perf_counter()
        eff = self._effective_walks()
        keep: List[_Queued] = []
        for e in sorted(self.queue,
                        key=lambda e: (e.deadline, e.req.t_submit)):
            if e.deadline == math.inf:
                keep.append(e)
                continue
            feasible = int((e.deadline - now) / self._wave_time)
            backlog = (sum(q.walks for q in keep
                           if q.deadline <= e.deadline)
                       + sum(a.remaining for a in self.active.values()
                             if a.deadline <= e.deadline))
            needed = -(-(e.walks + backlog) // eff)
            if feasible >= needed:
                keep.append(e)
                continue
            budget = feasible * eff - backlog
            if e.req.allow_downgrade and budget >= 1:
                e.walks = min(e.walks, budget)
                e.downgraded = True
                keep.append(e)
                self.fault_log.append(FaultEvent(
                    kind="readmit", wave=wave_no,
                    detail=f"rid={e.req.rid} downgraded to {e.walks} walks"))
            else:
                self.rejected.append(AdmissionDecision(
                    rid=e.req.rid, admitted=False,
                    reason=(f"re-admission after shard loss (shards "
                            f"{sorted(self.lost_shards)} evicted): plan "
                            f"needs {needed} waves, {feasible} fit the "
                            f"SLO at degraded throughput"),
                    reason_code=RejectReason.SHARD_LOSS,
                    plan=e.plan))
                self.fault_log.append(FaultEvent(
                    kind="readmit", wave=wave_no,
                    detail=f"rid={e.req.rid} rejected"))
        self.queue = keep

    # --- introspection ----------------------------------------------------

    def stats(self) -> SchedulerStats:
        backlog = (sum(e.walks for e in self.queue)
                   + sum(a.remaining for a in self.active.values()))
        capacity = self._waves_run * self.max_walks
        return SchedulerStats(
            queued=len(self.queue), active=len(self.active),
            finished=len(self.finished), rejected=len(self.rejected),
            cancelled=len(self.cancelled), backlog_walks=backlog,
            waves_run=self._waves_run, walks_executed=self._walks_executed,
            wave_time_ema_s=self._wave_time,
            wave_occupancy=(self._walks_allocated / capacity
                            if capacity else 0.0),
            lost_shards=tuple(sorted(self.lost_shards)),
            max_walks=self.max_walks,
            max_queries=self.max_queries, t_last_wave=self._t_last_wave,
            last_wave_s=self._last_wave_s, epoch=self.epoch)

    # --- anytime (ε, δ) refinement ---------------------------------------

    def anytime_bound(self, num_steps: int, k: int, delta: float,
                      executed: int) -> float:
        """The ε Theorem 1 certifies for the walks tallied so far; ``inf``
        before the first wave."""
        if executed < 1:
            return math.inf
        return theory.epsilon_bound(self.p_T, num_steps, k, delta,
                                    executed, 1.0, 0.0)

    def _finalize(self, a: _Active, now: float,
                  early: bool = False) -> QueryResult:
        # rank the integer counts (a positive divide keeps ranks and ties)
        # and divide only the selected head.
        k = min(a.req.k, self.g.n)
        top = _topk_stable(a.counts, k)
        scores_top = a.counts[top] / float(max(1, a.executed))
        latency = now - a.t_submit
        # an early-stopped query carries the bound its executed walks
        # certify, a degraded one (walks died on evicted shards) widens to
        # exactly Theorem 1 at N = executed; a drained one keeps its plan's
        degraded = a.lost > 0
        bound = (self.anytime_bound(a.plan.num_steps, a.req.k, a.req.delta,
                                    a.executed)
                 if (a.req.early_stop or degraded)
                 else a.plan.epsilon_bound)
        return QueryResult(
            rid=a.req.rid, kind=a.req.kind, vertices=top,
            scores=scores_top, num_walks=a.executed,
            num_steps=a.plan.num_steps, waves=a.waves, latency_s=latency,
            epsilon_bound=bound, downgraded=a.downgraded,
            met_slo=(None if a.req.slo_s is None
                     else bool(latency <= a.req.slo_s)),
            early_stopped=early, degraded=degraded,
            shards_lost=a.shards_lost, walks_lost=a.lost, epoch=self.epoch)

    def query_state(self, rid: int) -> str:
        """``queued`` | ``active`` | ``finished`` | ``rejected`` |
        ``cancelled`` | ``unknown``."""
        if any(r.rid == rid for r in self.finished):
            return "finished"
        if any(a.req.rid == rid for a in self.active.values()):
            return "active"
        if any(e.req.rid == rid for e in self.queue):
            return "queued"
        if rid in self.cancelled:
            return "cancelled"
        if any(d.rid == rid for d in self.rejected):
            return "rejected"
        return "unknown"

    def result_for(self, rid: int) -> QueryResult:
        for r in self.finished:
            if r.rid == rid:
                return r
        raise KeyError(f"query {rid} has no finished result "
                       f"(state: {self.query_state(rid)})")

    def partial(self, rid: int) -> QueryPartial:
        """Anytime snapshot: current top-k plus the ε certified so far."""
        for r in self.finished:
            if r.rid == rid:
                return QueryPartial(
                    rid=rid, kind=r.kind, k=len(r.vertices),
                    vertices=r.vertices, scores=r.scores,
                    walks_done=r.num_walks, waves=r.waves,
                    epsilon_bound=r.epsilon_bound, done=True,
                    degraded=r.degraded, shards_lost=r.shards_lost,
                    walks_lost=r.walks_lost)
        for a in self.active.values():
            if a.req.rid != rid:
                continue
            k = min(a.req.k, self.g.n)
            if a.executed:
                vertices = _topk_stable(a.counts, k)
                top_scores = a.counts[vertices] / float(a.executed)
            else:
                vertices = np.zeros(0, np.int64)
                top_scores = np.zeros(0, np.float64)
            return QueryPartial(
                rid=rid, kind=a.req.kind, k=k, vertices=vertices,
                scores=top_scores, walks_done=a.executed, waves=a.waves,
                epsilon_bound=self.anytime_bound(
                    a.plan.num_steps, a.req.k, a.req.delta, a.executed),
                done=False, degraded=a.lost > 0, shards_lost=a.shards_lost,
                walks_lost=a.lost)
        for e in self.queue:
            if e.req.rid == rid:
                return QueryPartial(
                    rid=rid, kind=e.req.kind, k=min(e.req.k, self.g.n),
                    vertices=np.zeros(0, np.int64),
                    scores=np.zeros(0, np.float64), walks_done=0, waves=0,
                    epsilon_bound=math.inf, done=False)
        raise KeyError(f"no in-flight query {rid} "
                       f"(state: {self.query_state(rid)})")

    def cancel(self, rid: int) -> bool:
        """Drops a queued or in-flight query (its tallies are discarded)."""
        for i, e in enumerate(self.queue):
            if e.req.rid == rid:
                del self.queue[i]
                self.cancelled.append(rid)
                return True
        for s, a in list(self.active.items()):
            if a.req.rid == rid:
                del self.active[s]
                self.cancelled.append(rid)
                return True
        return False

    def _drain(self) -> List[QueryResult]:
        """Drains queue + in-flight queries; results in finish order."""
        while self.step_wave():
            pass
        return self.finished
