"""The gateway facade (port of ``repro/gateway/gateway.py``): cache →
in-flight join → supervised replica routing, on one device.

One :class:`Gateway` fronts a :class:`~repro_torch.gateway.pool.
ReplicaPool` behind a single submit path shared by ``topk`` / ``ppr`` /
``pagerank``:

1. **Result cache** — if a cached certificate dominates the request
   (ε′ ≤ ε, δ′ ≤ δ), the answer is served immediately with zero walks
   executed, byte-identical to the originally certified answer.
2. **In-flight dedup** — if an identical key is already being computed and
   its target dominates the request, the request joins the live
   :class:`~repro_torch.service.QueryHandle` (via :meth:`~repro_torch.
   service.QueryHandle.join`): it is fed monotone ``partial()`` snapshots and
   completes the wave the weaker of the two bounds certifies.
3. **Replica routing** — otherwise the request lands on the *routable*
   replica (breakers closed, or half-open probes) with the lowest
   EDF-charged queue depth; its completed (undegraded) result is inserted
   into the cache for everyone after.

Every request returns a :class:`GatewayHandle` whose ``source`` records
which path served it (``"cache"`` | ``"joined"`` | ``"live"``).

Fault tolerance. All wave driving goes through the pool's supervised
:meth:`~repro_torch.gateway.pool.ReplicaPool.step_replica`, and the
gateway reacts to what it reports:

* **Failover** — a replica that crashes or misses its heartbeat under a
  live query gets that query *replayed* on a healthy replica via
  :meth:`~repro_torch.service.FrogWildService.resubmit` (same plan
  parameters,
  fresh rid). Joined handles migrate with their parent — re-joined onto
  the replacement, still zero walks of their own — or, when there is
  nowhere left to route, settle with a classified
  :class:`~repro_torch.distributed.faults.WaveFailedError`; never a
  hang.
  Because every replica is seeded identically and a freshly (re)started
  replica's key stream begins at wave 0, a failover that lands on a cold
  replica returns an answer **byte-identical** to the fault-free run.
* **Hedging** — with ``hedge_after_s`` set, a live query whose wall time
  exceeds ``max(hedge_after_s, 4·p99)`` fires one duplicate submission on
  a different routable replica. First certified answer wins, the loser is
  cancelled, and the dominance cache sees exactly one insert (the settle
  path is idempotent).
* **Load shedding** — :meth:`topk`/:meth:`ppr`/:meth:`pagerank` raise
  :class:`GatewayOverloadError` (carrying ``retry_after_s``) instead of
  queueing when every breaker is open, when the routable backlog exceeds
  the shed threshold, or while draining. The HTTP layer maps this to
  ``503`` + ``Retry-After``.
* **Drain** — :meth:`drain` stops admitting, drives every in-flight
  handle to completion (fault handling included), then closes the tier.

The device is threaded from :meth:`Gateway.open` through the pool into
every replica's ``FrogWildService.open``: ``device=None`` is the card
(raising without one), ``device="cpu"`` the plain PyTorch path. A gateway
over a mesh comes with ``ROADMAP.md`` Queue 1 item 8d.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.config import RuntimeConfig
from repro_torch.device import DeviceLike
from repro_torch.distributed.faults import ReplicaFault, WaveFailedError
from repro_torch.gateway.cache import CacheKey, ResultCache
from repro_torch.gateway.metrics import GatewayMetrics
from repro_torch.gateway.pool import NoReplicaAvailable, ReplicaPool
from repro_torch.graph.csr import CSRGraph
from repro_torch.query.engine import plan_query
from repro_torch.query.scheduler import (QueryPartial, QueryResult,
                                         _topk_stable)
from repro_torch.service import JoinedQueryHandle, QueryHandle

__all__ = ["Gateway", "GatewayHandle", "GatewayOverloadError"]


class GatewayOverloadError(RuntimeError):
    """The tier refused to admit this request — structured backpressure,
    not a failure: retry after ``retry_after_s``. ``reason`` is one of
    ``overload`` (routable backlog past the shed threshold),
    ``no_replica`` (every breaker open), or ``draining``."""

    def __init__(self, message: str, retry_after_s: float,
                 reason: str = "overload"):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.reason = reason


class GatewayHandle:
    """Uniform future for a gateway request, whatever path served it.

    ``source`` is ``"cache"`` (settled at submit, zero walks), ``"joined"``
    (riding another user's in-flight query), or ``"live"`` (a fresh query
    on ``replica``). The interface mirrors :class:`~repro_torch.service.
    QueryHandle`: ``done()`` / ``poll()`` / ``partial()`` / ``result()`` —
    but waves are driven through the gateway's supervised path, so a
    handle transparently survives its replica dying (``replica`` then
    points at the replacement and ``failovers`` counts the migrations).
    """

    def __init__(self, gateway: "Gateway", source: str,
                 replica: Optional[int], *, key: CacheKey,
                 epsilon: float, delta: float,
                 inner: Union[QueryHandle, JoinedQueryHandle, None] = None,
                 result: Optional[QueryResult] = None):
        self._gateway = gateway
        self.source = source
        self.replica = replica
        self.key = key
        self.epsilon = epsilon
        self.delta = delta
        self._inner = inner
        self._result: Optional[QueryResult] = None
        self._t0 = time.perf_counter()
        self.failovers = 0
        self._parent: Optional["GatewayHandle"] = None   # set on joins
        self._joiners: List["GatewayHandle"] = []        # set on parents
        self._hedge: Optional[Tuple[int, QueryHandle]] = None
        self._hedge_won = False
        if result is not None:           # cache hit: settled at birth
            self._result = result
            gateway._record_done(self, result, latency_s=0.0)

    @property
    def admitted(self) -> bool:
        return self._result is not None or self._inner.admitted

    @property
    def decision(self):
        """The replica's AdmissionDecision (None off the live path)."""
        return (self._inner.decision
                if isinstance(self._inner, QueryHandle) else None)

    def done(self) -> bool:
        return self._result is not None or self._maybe_settle()

    def poll(self) -> bool:
        """Advances the serving replica by at most one wave (supervised:
        a dead replica triggers failover here, not an exception)."""
        if self._result is None:
            self._gateway._drive(self, step=True)
        return self.done()

    def partial(self) -> QueryPartial:
        """Anytime snapshot (for a settled handle, the final state)."""
        if self._result is not None:
            r = self._result
            return QueryPartial(
                rid=r.rid, kind=r.kind, k=len(r.vertices),
                vertices=r.vertices, scores=r.scores,
                walks_done=r.num_walks, waves=r.waves,
                epsilon_bound=r.epsilon_bound, done=True,
                degraded=r.degraded, shards_lost=r.shards_lost,
                walks_lost=r.walks_lost)
        return self._inner.partial()

    def result(self, max_waves: Optional[int] = None,
               timeout_s: Optional[float] = None) -> QueryResult:
        """Drives supervised waves until this request settles.

        ``max_waves`` bounds the number of waves driven; ``timeout_s``
        bounds wall time — both raise ``TimeoutError`` (the HTTP layer
        maps the latter to 504). A request that can never settle (replica
        dead with nowhere to fail over, parent cancelled under a join)
        raises a classified error instead of hanging.
        """
        deadline = (None if timeout_s is None
                    else time.perf_counter() + timeout_s)
        waves = 0
        while self._result is None:
            if self.done():
                break                    # terminal without a result
            if max_waves is not None and waves >= max_waves:
                raise TimeoutError(
                    f"gateway request on key {self.key} not settled after "
                    f"{waves} waves")
            if deadline is not None and time.perf_counter() > deadline:
                self._gateway.metrics.timeouts += 1
                raise TimeoutError(
                    f"gateway request on key {self.key} not settled within "
                    f"{timeout_s:g}s")
            self._gateway._drive(self, step=True)
            waves += 1
        if self._result is None:
            # terminal (rejected / cancelled with no failover possible):
            # surface the inner handle's classified error.
            self._inner.result(max_waves=0)
            raise RuntimeError(          # pragma: no cover — result raises
                f"request on key {self.key} terminal without a result")
        return self._result

    def _maybe_settle(self) -> bool:
        """Settles without driving waves when the inner future finished.

        Rejected / cancelled queries are terminal (True) but never settle
        a result — ``result()`` surfaces the inner handle's error instead.
        A handle whose replica *died* (rather than being cancelled by its
        caller) is not terminal: the gateway migrates it on the next
        drive, so this reports not-done and lets failover run.
        """
        inner = self._inner
        gw = self._gateway
        if isinstance(inner, QueryHandle):
            st = inner.status() if inner.admitted else "rejected"
            if st == "finished":
                self._settle(inner.result(max_waves=0))
                return True
            if st == "cancelled" and gw._failover_eligible(self):
                return False             # migrates on the next drive
            return st in ("rejected", "cancelled")
        if inner.done():
            if inner._result is not None:
                self._settle(inner.result(max_waves=0))
                return True
            if gw._failover_eligible(self):
                return False             # parent died: migrate, not settle
            return True                  # cancelled parent: classified error
        return False

    def _settle(self, result: QueryResult) -> None:
        if self._result is None:
            self._result = result
            self._gateway._record_done(
                self, result, latency_s=time.perf_counter() - self._t0)


class Gateway:
    """Serving tier over a supervised replica pool with an (ε, δ)-aware
    cache.

    Build one with :meth:`open`; submit with :meth:`topk` / :meth:`ppr`
    (async :class:`GatewayHandle`) or :meth:`pagerank` (synchronous batch);
    observe with :meth:`stats`; shut down with :meth:`drain` (graceful) or
    :meth:`close` (immediate); mount the stdlib HTTP front-end with
    :func:`~repro_torch.gateway.http.serve_http`.
    """

    def __init__(self, pool: ReplicaPool, cache: Optional[ResultCache],
                 metrics: Optional[GatewayMetrics] = None, *,
                 hedge_after_s: Optional[float] = None,
                 shed_backlog_walks: Optional[int] = None):
        self.pool = pool
        self.cache = cache
        self.metrics = metrics if metrics is not None else GatewayMetrics()
        # cache/join keys carry the graph's mutation epoch: a gateway
        # opened over an already-mutated graph starts there, and
        # apply_mutations() keeps the two in lock-step.
        self.epoch = int(getattr(pool.graph, "epoch", 0))
        self.hedge_after_s = hedge_after_s
        # shed when the total backlog across routable replicas exceeds
        # this many walks (default: 8 full waves per replica — deep enough
        # that EDF admission, not the gateway, is the normal gate).
        if shed_backlog_walks is None:
            shed_backlog_walks = (8 * pool.config.serving.max_walks
                                  * len(pool))
        self.shed_backlog_walks = shed_backlog_walks
        self._inflight: Dict[CacheKey, GatewayHandle] = {}
        self._pending: List[GatewayHandle] = []   # unsettled live handles
        self._lock = threading.RLock()            # host-state mutations only
        self._draining = False
        self._closed = False

    @classmethod
    def open(
        cls,
        graph_or_path: Union[CSRGraph, str, os.PathLike],
        config: Optional[RuntimeConfig] = None,
        *,
        replicas: int = 2,
        cache: bool = True,
        cache_capacity: int = 256,
        device: DeviceLike = None,
        hedge_after_s: Optional[float] = None,
        shed_backlog_walks: Optional[int] = None,
        heartbeat_timeout_s: Optional[float] = None,
        breaker_failure_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
    ) -> "Gateway":
        """Opens a gateway: one shared graph/index on ``device`` (default:
        the card; raises without one), ``replicas`` supervised services,
        and (unless ``cache=False``) the dominance-checked result cache.
        ``heartbeat_timeout_s`` / ``breaker_*`` configure the pool's
        supervisor; ``hedge_after_s`` enables hedged retries (None = off);
        ``shed_backlog_walks`` sets the overload shed threshold. The
        wall-clock settings are in seconds: size them to the device's wave
        time."""
        pool = ReplicaPool(graph_or_path, config, num_replicas=replicas,
                           device=device,
                           heartbeat_timeout_s=heartbeat_timeout_s,
                           breaker_failure_threshold=breaker_failure_threshold,
                           breaker_cooldown_s=breaker_cooldown_s)
        return cls(pool, ResultCache(cache_capacity) if cache else None,
                   hedge_after_s=hedge_after_s,
                   shed_backlog_walks=shed_backlog_walks)

    # --- lifecycle -------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def draining(self) -> bool:
        return self._draining

    def close(self) -> None:
        """Closes the pool and drops gateway state (idempotent)."""
        if self._closed:
            return
        self._inflight.clear()
        self._pending.clear()
        if self.cache is not None:
            self.cache.clear()
        self.pool.close()
        self._closed = True

    def drain(self) -> List[QueryResult]:
        """Graceful shutdown: stop admitting, finish in-flight, close.

        New submits raise :class:`GatewayOverloadError` (``reason=
        "draining"``) the moment this is called; every outstanding live
        handle is then driven to completion through the supervised path
        (failover included — a replica dying mid-drain still settles its
        queries elsewhere), joined handles settle with their parents, and
        finally the pool is closed. Returns the results settled during the
        drain, in completion order. Idempotent with :meth:`close`.
        """
        if self._closed:
            return []
        with self._lock:
            self._draining = True
            pending = list(self._pending)
        results: List[QueryResult] = []
        for h in pending:
            if h._result is None:
                try:
                    h.result()
                except (WaveFailedError, RuntimeError, TimeoutError):
                    # classified terminal (rejected / cancelled / nowhere
                    # to fail over) — the caller's handle already says so;
                    # drain's job is just to not leave work running.
                    pass
            if h._result is not None:
                results.append(h._result)
        self.close()
        return results

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def bump_epoch(self) -> int:
        """Advances the graph epoch: every cached certificate and in-flight
        join key from older epochs stops matching (the dynamic-graph
        refresh hook; each query is pinned to its admission epoch).
        Queries already in flight keep running, but their certificates are
        refused at insert time (``min_epoch`` guard in the cache) — a
        stale-epoch answer can never land after the epoch moved on.
        Orphaned certificates are counted in ``metrics.epoch_orphaned``."""
        with self._lock:
            self.epoch += 1
            self._inflight.clear()
            if self.cache is not None:
                self.metrics.epoch_orphaned += (
                    self.cache.drop_epochs_before(self.epoch))
            return self.epoch

    def apply_mutations(self, batch, *, chunk: int = 1024):
        """One mutation batch through the whole tier: compact the CSR at
        the next epoch, incrementally refresh exactly the invalidated walk
        segments, persist the slab under its epoch directory (when a
        checkpoint dir is configured), commit the two-epoch swap on every
        replica, and bump the gateway epoch so stale cached certificates
        are orphaned (counted in ``metrics.epoch_orphaned``). In-flight
        queries finish on their pinned old-epoch slabs, byte-identical to
        a never-mutated run. The refresh runs once, on the pool's shared
        index; every replica receives its result. Returns the
        :class:`repro_torch.dynamic.RefreshReport`.
        """
        from repro_torch.dynamic import (apply_mutations as _apply,
                                         refresh_walk_index,
                                         save_epoch_index)

        self._check_open()
        with self.pool.on_device():
            new_graph, changed = _apply(self.pool.graph, batch)
            new_index, report = refresh_walk_index(
                self.pool.index, new_graph, changed,
                step_impl=self.pool.config.walk_index().step_impl,
                chunk=chunk)
        directory = self.pool.config.serving.checkpoint_dir
        if directory is not None:
            save_epoch_index(directory, new_index)
        self.pool.commit_epoch(new_graph, new_index)
        self.bump_epoch()
        return report

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("Gateway is closed")

    # --- the async query surface -----------------------------------------

    def topk(self, k: int = 10, epsilon: float = 0.3, delta: float = 0.1,
             *, slo_s: Optional[float] = None,
             allow_downgrade: bool = False) -> GatewayHandle:
        """Global top-k through the tier (cache → join → replica)."""
        return self._submit("topk", k, 0, epsilon, delta, slo_s=slo_s,
                            allow_downgrade=allow_downgrade)

    def ppr(self, source: int, k: int = 10, epsilon: float = 0.3,
            delta: float = 0.1, *, slo_s: Optional[float] = None,
            allow_downgrade: bool = False) -> GatewayHandle:
        """Personalized PageRank through the tier."""
        return self._submit("ppr", k, source, epsilon, delta, slo_s=slo_s,
                            allow_downgrade=allow_downgrade)

    def _submit(self, kind: str, k: int, source: int, epsilon: float,
                delta: float, *, slo_s: Optional[float],
                allow_downgrade: bool) -> GatewayHandle:
        self._check_open()
        with self._lock:
            self.metrics.requests += 1
            if self._draining:
                self.metrics.sheds += 1
                raise GatewayOverloadError(
                    "gateway is draining — not admitting new work",
                    retry_after_s=5.0, reason="draining")
            key = ResultCache.key(kind, k, source, self.epoch)

            # 1. cache: a dominating certificate answers for free.
            if self.cache is not None:
                entry = self.cache.lookup(key, epsilon, delta)
                if entry is not None:
                    self.metrics.cache_hits += 1
                    return GatewayHandle(self, "cache", None, key=key,
                                         epsilon=epsilon, delta=delta,
                                         result=entry.result)

            # 2. in-flight dedup: ride a live duplicate that dominates.
            live = self._inflight.get(key)
            if live is not None:
                if live.done():          # finished since last touched —
                    live = None          # its settle cached it already;
                    self._inflight.pop(key, None)  # fall through, re-lookup
                    if self.cache is not None:
                        entry = self.cache.lookup(key, epsilon, delta)
                        if entry is not None:
                            self.metrics.cache_hits += 1
                            return GatewayHandle(
                                self, "cache", None, key=key,
                                epsilon=epsilon, delta=delta,
                                result=entry.result)
                elif live.epsilon <= epsilon and live.delta <= delta:
                    self.metrics.joins += 1
                    joined = live._inner.join(epsilon, delta)
                    handle = GatewayHandle(self, "joined", live.replica,
                                           key=key, epsilon=epsilon,
                                           delta=delta, inner=joined)
                    handle._parent = live
                    live._joiners.append(handle)
                    return handle

            # 3. route to the least-loaded *routable* replica — or shed.
            ridx = self._route_or_shed()
            svc = self.pool.replicas[ridx]
            if kind == "ppr":
                qh = svc.ppr(source, k=k, epsilon=epsilon, delta=delta,
                             slo_s=slo_s, allow_downgrade=allow_downgrade)
            else:
                qh = svc.topk(k=k, epsilon=epsilon, delta=delta, slo_s=slo_s,
                              allow_downgrade=allow_downgrade)
            self.metrics.record_admission(qh.decision)
            handle = GatewayHandle(self, "live", ridx, key=key,
                                   epsilon=epsilon, delta=delta, inner=qh)
            if qh.admitted:
                self.metrics.live += 1
                self._pending.append(handle)
                prev = self._inflight.get(key)
                # register for joins; a strictly stronger target displaces
                # a weaker registrant (it serves strictly more duplicates).
                if (prev is None or prev.done()
                        or (epsilon <= prev.epsilon and delta <= prev.delta)):
                    self._inflight[key] = handle
            return handle

    def _route_or_shed(self) -> int:
        """Routes, translating supervision state into structured
        backpressure: every breaker open → ``no_replica`` shed; routable
        backlog past the threshold → ``overload`` shed with a Retry-After
        derived from how long that backlog takes to drain at the pool's
        observed wave rate."""
        try:
            ridx = self.pool.route()
        except NoReplicaAvailable as e:
            self.metrics.sheds += 1
            raise GatewayOverloadError(str(e), e.retry_after_s,
                                       reason="no_replica") from e
        backlog = 0
        for i in self.pool.routable():
            st = self.pool.replicas[i].serving_stats()
            if st is not None:
                backlog += st.backlog_walks
        if backlog >= self.shed_backlog_walks:
            self.metrics.sheds += 1
            retry = self._retry_after_s(backlog)
            raise GatewayOverloadError(
                f"routable backlog {backlog} walks ≥ shed threshold "
                f"{self.shed_backlog_walks} — retry in {retry:.2g}s",
                retry_after_s=retry, reason="overload")
        return ridx

    def _retry_after_s(self, backlog_walks: int) -> float:
        """Time for the current backlog to drain at the observed wave
        rate — the honest Retry-After. Falls back to 1s before any wave
        has been timed."""
        emas = [st.wave_time_ema_s for st in
                (r.serving_stats() for r in self.pool.replicas)
                if st is not None and st.wave_time_ema_s]
        if not emas:
            return 1.0
        per_wave = sum(emas) / len(emas)
        waves = backlog_walks / max(1, self.pool.config.serving.max_walks)
        return max(0.05, min(60.0, waves * per_wave))

    # --- supervised driving: failover + hedging ---------------------------

    def _failover_eligible(self, handle: GatewayHandle) -> bool:
        """A handle migrates (rather than settling terminal) iff its
        serving replica actually died — crashed or closed under it — the
        gateway is still open, and its failover budget (one attempt per
        replica) is not exhausted. A query its *caller* cancelled is not
        eligible: that cancellation is an answer, not a fault."""
        if self._closed or self.pool.closed or handle.replica is None:
            return False
        root = handle._parent if handle._parent is not None else handle
        if root.failovers >= len(self.pool):
            return False
        st = self.pool.states[handle.replica]
        return st.crashed or self.pool.replicas[handle.replica].closed

    def _failover(self, handle: GatewayHandle, reason: str) -> None:
        """Migrates a query off a dead replica: replay on a healthy one
        (same plan parameters — byte-identical on a cold replica), then
        re-join every unsettled joiner onto the replacement. With nowhere
        to route, raises a classified :class:`WaveFailedError` so callers
        get a resubmittable error, never a hang."""
        with self._lock:
            parent = handle._parent if handle._parent is not None else handle
            if parent._result is not None:
                parent = handle          # orphaned joiner: go live itself
            if parent._hedge is not None:
                # a hedge is already replaying this exact plan on a healthy
                # replica: promote it to primary instead of submitting a
                # third copy. The hedge "won" by outliving the primary.
                hridx, hqh = parent._hedge
                parent._hedge = None
                parent._inner = hqh
                parent.replica = hridx
                parent.failovers += 1
                self.metrics.failovers += 1
                self.metrics.hedges_won += 1
                for j in parent._joiners:
                    if j._result is None:
                        j._inner = hqh.join(j.epsilon, j.delta)
                        j.replica = hridx
                return
            try:
                ridx = self.pool.route()
            except NoReplicaAvailable as e:
                raise WaveFailedError(
                    f"failover impossible for key {handle.key}: {e} "
                    f"(original fault: {reason})") from e
            svc = self.pool.replicas[ridx]
            self.metrics.failovers += 1
            parent.failovers += 1
            if parent.source == "joined":
                # orphaned joiner whose parent settled before the replica
                # died: promote it to a live query at its own target.
                req = parent._inner.parent.request
                if req.kind == "ppr":
                    new_qh = svc.ppr(req.source, k=req.k,
                                     epsilon=parent.epsilon,
                                     delta=parent.delta, slo_s=req.slo_s,
                                     allow_downgrade=req.allow_downgrade)
                else:
                    new_qh = svc.topk(k=req.k, epsilon=parent.epsilon,
                                      delta=parent.delta, slo_s=req.slo_s,
                                      allow_downgrade=req.allow_downgrade)
                parent.source = "live"
                self._pending.append(parent)
            else:
                new_qh = svc.resubmit(parent._inner.request)
            parent._inner = new_qh
            parent.replica = ridx
            parent._hedge = None         # a hedge raced the dead primary
            for j in parent._joiners:    # joiners migrate with the parent
                if j._result is None:
                    j._inner = new_qh.join(j.epsilon, j.delta)
                    j.replica = ridx

    def _drive(self, handle: GatewayHandle, step: bool = True) -> bool:
        """One supervised wave on behalf of ``handle``: runs hedge logic,
        steps the serving replica through the pool supervisor, and turns
        replica faults into failover. Returns ``handle.done()``."""
        if handle._result is not None:
            return True
        if handle.done():                # settles, or flags dead replica
            return True
        root = handle._parent if handle._parent is not None else handle
        if root._result is None and self._hedge_step(root):
            pass                         # hedge certified: root settled
        elif step:
            try:
                progressed = self.pool.step_replica(handle.replica)
            except ReplicaFault as e:
                self._failover(handle, str(e))
                progressed = True        # migration is progress
            except WaveFailedError as e:
                # the wave supervisor exhausted retries on this replica:
                # charge its breaker; the query itself migrates only if
                # the replica actually died, else the error is terminal.
                self.pool.record_failure(handle.replica, str(e))
                raise
            else:
                self._maybe_hedge(root)
            if not progressed and not handle.done():
                raise RuntimeError(
                    f"replica {handle.replica} idle but request on key "
                    f"{handle.key} is not done")
        return handle.done()

    def _hedge_threshold_s(self) -> Optional[float]:
        """Hedge when a query's wall time exceeds ``max(hedge_after_s,
        4·p99)`` — the floor keeps cold starts from hedging on the
        kernels' build; the p99 term adapts to the workload once the latency window
        has data. None disables hedging."""
        if self.hedge_after_s is None:
            return None
        _, p99 = self.metrics.latency_percentiles()
        if p99 is None:
            return self.hedge_after_s
        return max(self.hedge_after_s, 4.0 * p99)

    def _maybe_hedge(self, root: GatewayHandle) -> None:
        if (root._hedge is not None or root.source != "live"
                or root._result is not None):
            return
        threshold = self._hedge_threshold_s()
        if threshold is None:
            return
        if time.perf_counter() - root._t0 < threshold:
            return
        others = [i for i in self.pool.routable() if i != root.replica]
        if not others:
            return
        with self._lock:
            if root._hedge is not None or root._result is not None:
                return
            hridx = min(others, key=lambda i: (
                (lambda st: (0, 0) if st is None
                 else (st.backlog_walks, st.waves_run))(
                    self.pool.replicas[i].serving_stats())))
            hqh = self.pool.replicas[hridx].resubmit(root._inner.request)
            if hqh.admitted:
                root._hedge = (hridx, hqh)
                self.metrics.hedges_fired += 1

    def _hedge_step(self, root: GatewayHandle) -> bool:
        """Advances an active hedge one wave; True iff the hedge certified
        first and settled ``root`` (and its joiners — directly, since the
        winner's certificate dominates every joiner's target)."""
        if root._hedge is None:
            return False
        hridx, hqh = root._hedge
        try:
            self.pool.step_replica(hridx)
        except (ReplicaFault, WaveFailedError):
            root._hedge = None           # the hedge died; primary goes on
            return False
        if hqh.status() != "finished":
            return False
        result = hqh.result(max_waves=0)
        with self._lock:
            if root._result is not None:
                return False             # primary won the race after all
            root._hedge_won = True
            self.metrics.hedges_won += 1
            root._settle(result)         # exactly one cache insert
            for j in root._joiners:
                if j._result is None:
                    j._settle(result)
        # the loser is cancelled — its walks stop charging the replica.
        if isinstance(root._inner, QueryHandle):
            root._inner.cancel()
        return True

    # --- batch -----------------------------------------------------------

    def pagerank(self, epsilon: float = 0.3, delta: float = 0.1,
                 k: int = 10) -> QueryResult:
        """Batch full-vector PageRank, reduced to its top-k and cached.

        The Theorem-1 plan meets the requested (ε, δ) by construction, so
        the certificate is the plan's recorded ``epsilon_bound`` (which
        also honestly widens when a cap binds the plan).
        """
        self._check_open()
        with self._lock:
            self.metrics.requests += 1
            if self._draining:
                self.metrics.sheds += 1
                raise GatewayOverloadError(
                    "gateway is draining — not admitting new work",
                    retry_after_s=5.0, reason="draining")
            epoch = self.epoch
            key = ResultCache.key("pagerank", k, 0, epoch)
            if self.cache is not None:
                entry = self.cache.lookup(key, epsilon, delta)
                if entry is not None:
                    self.metrics.cache_hits += 1
                    self.metrics.record_completion(0.0)
                    return entry.result
            ridx = self._route_or_shed()
        svc = self.pool.replicas[ridx]
        plan = plan_query(k, epsilon, delta, p_T=svc.config.p_T,
                          max_steps=svc.config.serving.max_steps)
        t0 = time.perf_counter()
        with self.pool.on_device():
            res = svc.pagerank(epsilon=epsilon, delta=delta, k=k)
            pi = res.pi_hat.cpu().numpy()
        # the first k of a stable argsort of -π̂, as the reference ranks
        top = _topk_stable(pi, min(k, pi.shape[0]))
        qr = QueryResult(
            rid=-1, kind="pagerank", vertices=top, scores=pi[top],
            num_walks=int(getattr(res, "num_frogs", plan.num_walks)),
            num_steps=plan.num_steps, waves=0,
            latency_s=time.perf_counter() - t0,
            epsilon_bound=plan.epsilon_bound)
        with self._lock:
            self.metrics.live += 1
            self.metrics.record_completion(qr.latency_s)
            if self.cache is not None:
                self.cache.insert(key, qr, delta, min_epoch=self.epoch)
        return qr

    # --- completion hook --------------------------------------------------

    def _record_done(self, handle: GatewayHandle, result: QueryResult,
                     latency_s: float) -> None:
        with self._lock:
            self.metrics.record_completion(latency_s)
            if handle in self._pending:
                self._pending.remove(handle)
            if handle.source != "live":
                return
            if handle._hedge is not None and not handle._hedge_won:
                handle._hedge[1].cancel()    # primary won: cancel the hedge
                handle._hedge = None
            if self._inflight.get(handle.key) is handle:
                del self._inflight[handle.key]
            if self.cache is not None and not self._closed:
                # degraded answers are refused inside insert(); the
                # certificate's δ is the δ the bound was certified at; the
                # min_epoch guard refuses certificates from before a
                # bump_epoch() that raced this query.
                self.cache.insert(handle.key, result, handle.delta,
                                  min_epoch=self.epoch)

    # --- drive + observe --------------------------------------------------

    def step(self) -> bool:
        """One supervised wave across the pool: advances every replica
        with in-flight work; False when the whole tier is idle. Replica
        faults are absorbed here (breaker bookkeeping happens; the
        affected handles migrate on their next drive)."""
        self._check_open()
        progressed = False
        for i, r in enumerate(self.pool.replicas):
            if r.serving_stats() is not None:
                try:
                    progressed |= self.pool.step_replica(i)
                except ReplicaFault:
                    progressed = True    # quarantine happened: not idle
                except WaveFailedError as e:
                    self.pool.record_failure(i, str(e))
        return progressed

    def healthy(self) -> bool:
        """Liveness: open, at least one routable replica, and no routable
        replica lost a serving shard."""
        if self._closed or self.pool.closed:
            return False
        routable = self.pool.routable()
        return bool(routable) and all(
            not self.pool.replicas[i].lost_shards for i in routable)

    def stats(self) -> Dict[str, object]:
        """One structured snapshot of the whole tier (what ``/metrics``
        serves): gateway counters + per-replica scheduler **and
        supervision** state + cache."""
        snap = self.metrics.snapshot()
        snap["epoch"] = self.epoch
        snap["graph_epoch"] = int(getattr(self.pool.graph, "epoch", 0))
        snap["retiring_epochs"] = sorted({
            e for r in self.pool.replicas if not r.closed
            for e in getattr(r, "retiring_epochs", [])})
        snap["inflight_keys"] = len(self._inflight)
        snap["closed"] = self._closed
        snap["draining"] = self._draining
        snap["shed_backlog_walks"] = self.shed_backlog_walks
        snap["cache"] = (self.cache.stats() if self.cache is not None
                         else None)
        replicas = []
        for i, r in enumerate(self.pool.replicas):
            st = r.serving_stats()
            ps = self.pool.states[i]
            replicas.append({
                "replica": i,
                "queue_depth_walks": 0 if st is None else st.backlog_walks,
                "queued": 0 if st is None else st.queued,
                "active": 0 if st is None else st.active,
                "finished": 0 if st is None else st.finished,
                "rejected": 0 if st is None else st.rejected,
                "waves_run": 0 if st is None else st.waves_run,
                "walks_executed": 0 if st is None else st.walks_executed,
                "wave_occupancy": (0.0 if st is None
                                   else round(st.wave_occupancy, 4)),
                "wave_time_ema_s": None if st is None else st.wave_time_ema_s,
                "lost_shards": [] if st is None else list(st.lost_shards),
                # supervision
                "breaker": self.pool.breaker_state(i),
                "health": round(self.pool.health_score(i), 4),
                "crashed": ps.crashed,
                "consecutive_failures": ps.consecutive_failures,
                "restarts": ps.restarts,
                "pool_wave_time_ema_s": ps.wave_time_ema_s,
                "last_fault": ps.last_fault,
            })
        snap["replicas"] = replicas
        return snap
