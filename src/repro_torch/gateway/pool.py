"""Supervised replica pool (port of ``repro/gateway/pool.py``): N
``FrogWildService`` replicas over ONE shared graph and walk index on one
device, with per-replica health, circuit breakers, and deterministic
restart.

The expensive state — the CSR graph and the ``int32[n, R]`` walk-index
slab with its visited-block masks (or the per-shard blocks) — is built or
loaded exactly once on the pool's device and the *same tensors* are handed
to every replica, so an N-replica pool costs N schedulers (host state and
a key each), not N slabs: ``ensure_index()`` returns one object on every
replica, whose tensors share their storage. Replicas are seeded
identically, which keeps the cold-replica contract from the rest of the
stack: the first query on any fresh replica is byte-identical to the first
query on a fresh standalone service with the same config — and that is
also what makes **restart deterministic**: a crashed replica is re-opened
as a new service over the *same* slab (object identity re-asserted, zero
index rebuild) whose scheduler makes its key anew from the config's seed,
so its stream starts at wave 0 like any cold replica's.

Supervision. The pool is the fault boundary between the gateway and its
replicas:

* **Wave driving** goes through :meth:`step_replica`, never
  ``service.step()`` directly: the pool consults the replica-level fault
  injector (``replica_crash`` / ``replica_stall`` / ``replica_slow``
  from the shared :class:`~repro_torch.distributed.faults.FaultPlan`),
  holds a per-replica lock (two HTTP threads driving the same scheduler
  would corrupt host state; different replicas drive concurrently),
  launches on the pool's device whatever the calling thread's current
  device, measures wall time against the **heartbeat deadline**, and
  folds clean waves into a per-replica wave-time EMA.
* **Breaker states** per replica — ``closed`` (routable), ``open``
  (quarantined out of :meth:`route`), ``half_open`` (cooldown elapsed;
  routable as a probe — first clean wave closes the breaker, first fault
  re-opens it). A crash or missed heartbeat opens the breaker
  immediately; repeated :class:`~repro_torch.distributed.faults.
  WaveFailedError` opens it after ``breaker_failure_threshold``
  consecutive failures.
* **Health score** in [0, 1] per replica (:meth:`health_score`):
  0 when open/crashed, 0.5 while half-open, else
  ``max(0.1, 1 − 0.25·consecutive_failures) · min(1, median_ema/own_ema)``
  — a straggler (own EMA above the pool median) scores below its peers
  even before any fault fires, which is what the gateway's hedging keys
  on.
* **Restart** (:meth:`restart_replica`): a crashed replica's slot gets a
  fresh ``FrogWildService`` opened over the same graph / config / device
  / shared index — ``ensure_index() is`` the pool's slab, asserted — with
  the breaker left ``open`` until the cooldown elapses (the restarted
  replica re-enters rotation through the half-open probe like any other
  recovered replica).

Routing (:meth:`route`) is queue-depth-aware over **routable** replicas
only: smallest EDF-charged ``backlog_walks`` from each scheduler's own
admission accounting, ties toward fewest waves run. With every breaker
open, :meth:`route` raises :class:`NoReplicaAvailable` — the gateway
turns that into load shedding, never a hang.

The pool runs on one device; a pool over a mesh comes with ``ROADMAP.md``
Queue 1 item 8d (``FrogWildService.open(mesh=)`` runs only the batch
estimate through the engine so far).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, Optional, Union

import torch

from repro_torch.config import RuntimeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.faults import (FaultEvent, FaultInjector,
                                            ReplicaCrashed, ReplicaStalled)
from repro_torch.graph.csr import CSRGraph
from repro_torch.service import FrogWildService

__all__ = ["NoReplicaAvailable", "ReplicaPool", "ReplicaState"]


class NoReplicaAvailable(RuntimeError):
    """Every replica's breaker is open (or the pool is closed) — there is
    nowhere to route. The gateway maps this to structured load shedding
    (HTTP 503 + Retry-After), never a blocked caller."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ReplicaState:
    """Mutable supervision record for one replica slot."""

    def __init__(self):
        self.breaker = "closed"          # closed | open | half_open
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.last_fault = ""             # why the breaker last opened
        self.wave_time_ema_s: Optional[float] = None
        self.waves_driven = 0            # pool drives (fault addressing)
        self.restarts = 0
        self.crashed = False             # service closed, awaiting restart


class ReplicaPool:
    def __init__(
        self,
        graph_or_path: Union[CSRGraph, str, os.PathLike],
        config: Optional[RuntimeConfig] = None,
        *,
        num_replicas: int = 2,
        device: DeviceLike = None,
        heartbeat_timeout_s: Optional[float] = None,
        breaker_failure_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
    ):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be ≥ 1, got {num_replicas}")
        self.device = _pinned(resolve_device(device))
        with self.on_device():
            primary = FrogWildService.open(graph_or_path, config,
                                           device=self.device)
            # one build/load; every replica serves the same slab tensors
            # (and, for a sharded layout, the same per-shard blocks) — no
            # N-fold duplication, asserted via object identity.
            self._index = index = primary.ensure_index()
        self._graph = primary.graph
        self.replicas: List[FrogWildService] = [primary]
        for _ in range(num_replicas - 1):
            self.replicas.append(FrogWildService.open(
                primary.graph, primary.config, device=self.device,
                index=index))
        self._closed = False
        # --- supervision ---
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.breaker_failure_threshold = breaker_failure_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.states: List[ReplicaState] = [ReplicaState()
                                           for _ in range(num_replicas)]
        self.fault_log: List[FaultEvent] = []
        # replica-level faults come from the SAME FaultPlan as the
        # scheduler-level ones, but through the pool's own injector — the
        # per-service injectors never see pool-wave indices.
        cfg = primary.config
        self._injector = (FaultInjector(cfg.faults)
                          if cfg.faults is not None else None)
        # one step lock per replica: waves on one scheduler serialize,
        # different replicas (and /healthz, /metrics) never contend.
        self._step_locks = [threading.Lock() for _ in range(num_replicas)]
        self._state_lock = threading.RLock()

    def __len__(self) -> int:
        return len(self.replicas)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def graph(self) -> CSRGraph:
        return self._graph

    @property
    def config(self) -> RuntimeConfig:
        return self.replicas[0].config

    @property
    def index(self):
        """The ONE shared walk-index slab every replica serves from."""
        return self._index

    def on_device(self):
        """Context in which the calling thread launches on the pool's
        device (HTTP handler threads start on card 0, whichever card the
        pool holds)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def commit_epoch(self, graph: CSRGraph, index) -> int:
        """Commits a new (graph, slab) epoch to every live replica.

        Replica 0 commits first and its ``ensure_index()`` result — the
        slab normalized to the serving layout (re-sharded at most once) —
        is what every other replica receives, so all replicas keep sharing
        ONE set of slab arrays and :meth:`restart_replica`'s object-
        identity assertion stays true across epochs. In-flight queries on
        any replica keep draining on their pinned old-epoch schedulers.
        """
        self._check_open()
        with self._state_lock, self.on_device():
            epoch = self.replicas[0].commit_epoch(graph, index)
            shared = self.replicas[0].ensure_index()
            for r in self.replicas[1:]:
                if not r.closed:
                    r.commit_epoch(graph, shared)
            self._index = shared
            self._graph = graph
            return epoch

    # --- supervised wave driving -----------------------------------------

    def step_replica(self, ridx: int) -> bool:
        """Drives one wave on replica ``ridx`` under supervision.

        The pool-boundary contract: injected replica faults fire here
        (crash → service closed + :class:`ReplicaCrashed`; stall past the
        heartbeat deadline → :class:`ReplicaStalled`; slow → added
        latency, no exception), the wave's wall time is checked against
        ``heartbeat_timeout_s`` and folded into the replica's EMA, and
        breaker bookkeeping happens on both success and failure. Returns
        the scheduler's "did anything run" bool.
        """
        self._check_open()
        st = self.states[ridx]
        if st.crashed:
            raise ReplicaCrashed(
                f"replica {ridx} is crashed (restart pending)", ridx)
        wave_no = st.waves_driven
        st.waves_driven += 1
        stall_s = slow_s = 0.0
        if self._injector is not None:
            if self._injector.replica_crash_at(ridx, wave_no):
                self._on_crash(ridx, f"injected crash at pool wave {wave_no}")
                raise ReplicaCrashed(
                    f"replica {ridx} crashed at pool wave {wave_no}", ridx)
            stall_s = self._injector.replica_stall_s(ridx, wave_no)
            slow_s = self._injector.replica_slow_s(ridx)
        t0 = time.monotonic()
        hb = self.heartbeat_timeout_s
        if stall_s or slow_s:
            # simulate the stall/straggler before the wave body; a stall
            # already past the deadline means the wave never returns in
            # time — don't run it (a real stalled worker produced nothing).
            if hb is not None and stall_s + slow_s > hb:
                time.sleep(min(stall_s + slow_s, hb))
                self._on_stall(ridx, time.monotonic() - t0)
                raise ReplicaStalled(
                    f"replica {ridx} missed its heartbeat deadline "
                    f"({stall_s + slow_s:.3g}s stall > {hb:.3g}s)", ridx)
            time.sleep(stall_s + slow_s)
        with self._step_locks[ridx], self.on_device():
            progressed = self.replicas[ridx].step()
        dt = time.monotonic() - t0
        # the wall-time heartbeat only arms once an EMA exists — the first
        # timed waves include the kernels' build, which must never read as
        # a stall (injected stalls above fire regardless; they are
        # deterministic and machine-independent).
        if hb is not None and dt > hb and st.wave_time_ema_s is not None:
            self._on_stall(ridx, dt)
            raise ReplicaStalled(
                f"replica {ridx} wave took {dt:.3g}s > heartbeat deadline "
                f"{hb:.3g}s", ridx)
        # one-shot stalls are faults, not throughput, and stay out of the
        # EMA; persistent slowness IS the machine — it belongs in it (the
        # straggler term of the health score keys on exactly that).
        self._on_success(ridx, dt, clean=stall_s == 0.0)
        return progressed

    def record_failure(self, ridx: int, reason: str) -> None:
        """Charges a wave-level failure (e.g. ``WaveFailedError`` out of
        the scheduler) against the replica's breaker: past
        ``breaker_failure_threshold`` consecutive failures it opens."""
        with self._state_lock:
            st = self.states[ridx]
            st.consecutive_failures += 1
            if (st.breaker == "half_open"
                    or st.consecutive_failures
                    >= self.breaker_failure_threshold):
                self._open_breaker(ridx, reason)

    def _on_success(self, ridx: int, dt: float, clean: bool) -> None:
        with self._state_lock:
            st = self.states[ridx]
            st.consecutive_failures = 0
            if st.breaker == "half_open":
                st.breaker = "closed"       # probe succeeded
                st.opened_at = None
                self.fault_log.append(FaultEvent(
                    "breaker_close", st.waves_driven,
                    detail=f"replica={ridx} probe wave clean"))
            # EMA over clean waves only (injected latency measures the
            # fault, not the machine); the first wave includes the kernels'
            # build and is skipped like the scheduler's own EMA.
            if clean and st.waves_driven > 1:
                st.wave_time_ema_s = (
                    dt if st.wave_time_ema_s is None
                    else 0.5 * st.wave_time_ema_s + 0.5 * dt)

    def _on_crash(self, ridx: int, reason: str) -> None:
        with self._state_lock:
            st = self.states[ridx]
            st.crashed = True
            # the crashed service is closed so its in-flight handles
            # settle as "cancelled" (never a hang) while the gateway
            # migrates them to a healthy replica.
            self.replicas[ridx].close()
            self._open_breaker(ridx, reason)

    def _on_stall(self, ridx: int, dt: float) -> None:
        with self._state_lock:
            self.states[ridx].consecutive_failures += 1
            self._open_breaker(
                ridx, f"heartbeat missed ({dt:.3g}s wave)")

    def _open_breaker(self, ridx: int, reason: str) -> None:
        st = self.states[ridx]
        if st.breaker != "open":
            st.breaker = "open"
            st.opened_at = time.monotonic()
            self.fault_log.append(FaultEvent(
                "breaker_open", st.waves_driven,
                detail=f"replica={ridx}: {reason}"))
        st.last_fault = reason

    def restart_replica(self, ridx: int) -> FrogWildService:
        """Deterministically restarts replica ``ridx``: a fresh
        ``FrogWildService`` over the *same* graph / config / device and
        the *same* shared slab — object identity asserted, zero index
        rebuild; its scheduler makes its key anew from the config's seed. The breaker stays ``open`` until the cooldown elapses,
        so the restarted replica re-enters rotation through the standard
        half-open probe."""
        with self._state_lock:
            old = self.replicas[ridx]
            if not old.closed:
                old.close()
            fresh = FrogWildService.open(self.graph, self.config,
                                         device=self.device,
                                         index=self._index)
            assert fresh.ensure_index() is self._index, (
                "restarted replica must share the pool's slab")
            self.replicas[ridx] = fresh
            st = self.states[ridx]
            st.crashed = False
            st.restarts += 1
            st.waves_driven = 0          # cold again: key stream at wave 0
            st.wave_time_ema_s = None
            self.fault_log.append(FaultEvent(
                "replica_restart", 0,
                detail=f"replica={ridx} restart #{st.restarts} over the "
                       f"shared slab"))
            return fresh

    # --- breaker / health introspection ----------------------------------

    def _tick_breakers(self) -> None:
        """Moves cooled-down open breakers to half-open (probe-ready)."""
        now = time.monotonic()
        for i, st in enumerate(self.states):
            if (st.breaker == "open" and not st.crashed
                    and st.opened_at is not None
                    and now - st.opened_at >= self.breaker_cooldown_s):
                st.breaker = "half_open"
                self.fault_log.append(FaultEvent(
                    "breaker_half_open", st.waves_driven,
                    detail=f"replica={i} cooldown elapsed"))

    def breaker_state(self, ridx: int) -> str:
        """``closed`` | ``open`` | ``half_open`` (cooldowns applied)."""
        with self._state_lock:
            self._tick_breakers()
            return self.states[ridx].breaker

    def routable(self) -> List[int]:
        """Replica indices :meth:`route` may currently pick: closed
        breakers plus half-open probes. Half-open replicas stay routable
        alongside healthy peers — otherwise a recovered replica would
        never receive the probe wave that closes its breaker — and one
        failure in the probe re-opens immediately
        (:meth:`record_failure`)."""
        with self._state_lock:
            self._tick_breakers()
            return [i for i, st in enumerate(self.states)
                    if st.breaker in ("closed", "half_open")
                    and not st.crashed]

    def health_score(self, ridx: int) -> float:
        """Replica health in [0, 1] — the breaker's drive signal.

        0.0 open/crashed; 0.5 half-open; else a closed replica starts at
        1.0, loses 0.25 per consecutive wave failure (floor 0.1), and is
        scaled by ``min(1, median_ema / own_ema)`` so a straggler scores
        below its peers before any fault ever fires.
        """
        with self._state_lock:
            self._tick_breakers()
            st = self.states[ridx]
            if st.crashed or st.breaker == "open":
                return 0.0
            if st.breaker == "half_open":
                return 0.5
            score = max(0.1, 1.0 - 0.25 * st.consecutive_failures)
            emas = sorted(s.wave_time_ema_s for s in self.states
                          if s.wave_time_ema_s is not None)
            if emas and st.wave_time_ema_s:
                median = emas[len(emas) // 2]
                score *= min(1.0, median / st.wave_time_ema_s)
            return score

    def route(self) -> int:
        """Index of the replica a new request should land on.

        Orders the **routable** replicas (open breakers are quarantined
        out) by (EDF-charged backlog walks, waves run, replica index):
        the backlog is the scheduler's own admission charge — queued plus
        in-flight walk demand — so routing and admission agree about what
        "loaded" means. A replica whose scheduler does not exist yet is
        unloaded by definition (depth 0, zero waves). With nothing
        routable, raises :class:`NoReplicaAvailable` with the remaining
        breaker cooldown as the suggested retry-after.
        """
        if self._closed:
            raise RuntimeError("ReplicaPool is closed")
        candidates = self.routable()
        if not candidates:
            now = time.monotonic()
            waits = [self.breaker_cooldown_s - (now - st.opened_at)
                     for st in self.states if st.opened_at is not None]
            retry = max(0.05, min(waits) if waits else 1.0)
            raise NoReplicaAvailable(
                f"all {len(self.replicas)} replicas quarantined "
                f"(breakers open) — retry in {retry:.2g}s",
                retry_after_s=retry)

        def load(i: int):
            st = self.replicas[i].serving_stats()
            if st is None:
                return (0, 0, i)
            return (st.backlog_walks, st.waves_run, i)

        return min(candidates, key=load)

    def total_waves_run(self) -> int:
        """Waves executed across the pool — the cache tests' "zero new
        walks" witness (a dominated hit must not move this)."""
        return sum(st.waves_run for st in
                   (r.serving_stats() for r in self.replicas)
                   if st is not None)

    def close(self) -> None:
        """Closes every replica (idempotent — replica close is too)."""
        if self._closed:
            return
        for r in self.replicas:
            r.close()
        self._closed = True

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("ReplicaPool is closed")

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _pinned(device: torch.device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` becomes the card current
    at open, so every replica and every thread launches on that card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
