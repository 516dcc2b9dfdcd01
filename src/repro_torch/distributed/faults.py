"""Fault-injection harness and fault taxonomy for the serving stack (port
of ``repro/distributed/faults.py``, copied whole: it is pure Python).

FrogWild tolerates missing contributions by design: partial
synchronization drops a fraction of mirror updates and Theorem 1 prices the
loss. The serving runtime inherits that property: a shard that dies
mid-wave widens the answer's certified ``epsilon_bound`` instead of failing
the query. This module makes every failure mode testable in-process,
deterministically:

* :class:`FaultPlan` — a frozen, seed-driven schedule of faults (permanent
  shard losses, transient wave failures, injected stalls, simulated hangs,
  corrupt / truncated checkpoint payloads). The same plan replayed against
  the same scheduler produces the same fault sequence, in either package.
* :class:`FaultInjector` — the mutable runtime companion the
  :class:`~repro_torch.query.scheduler.QueryScheduler` wave supervisor
  consults at each (wave, attempt). A transient fault scheduled for
  ``count`` attempts fires exactly ``count`` times, then clears; an
  optional seeded per-attempt transient probability drives sweeps.
* The exception taxonomy the supervisor speaks: :class:`ShardFault`
  (transient → retry with backoff; permanent → evict the shard and serve
  degraded waves), :class:`WaveTimeout` (the wave exceeded its deadline:
  result discarded, retried), :class:`WaveFailedError` (retries exhausted
  and no failover path left: the only way a wave surfaces an error).
* The replica-level taxonomy of a gateway tier: :class:`ReplicaCrashed` /
  :class:`ReplicaStalled` and the plan's ``replica_*`` schedules, consulted
  at a replica pool's boundary (:class:`repro_torch.gateway.ReplicaPool`;
  the scheduler never reads them).

The module is stdlib-only, so the config layer can reference
:class:`FaultPlan` without pulling in torch.
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, List, Optional, Tuple


class FaultError(RuntimeError):
    """Base class for injected / detected serving faults."""


class ShardFault(FaultError):
    """One shard failed. ``transient=True`` means retry may succeed;
    ``transient=False`` means the shard (its slab block) is gone and the
    scheduler must evict it and serve degraded waves."""

    def __init__(self, message: str, shard: Optional[int] = None,
                 transient: bool = True):
        super().__init__(message)
        self.shard = shard
        self.transient = transient


class WaveTimeout(FaultError):
    """A wave exceeded ``wave_timeout_s`` (or an injected hang simulated
    one). The wave's result — if any — is discarded and the wave retried
    from the same key, so a successful retry is byte-identical."""


class WaveFailedError(FaultError):
    """Retries exhausted and no failover path left. The scheduler's state
    is untouched by the failed wave (no tallies landed, no budget spent),
    so the caller can evict capacity / re-admit and drive again."""


class ReplicaFault(FaultError):
    """A whole serving replica misbehaved (the pool boundary).

    Raised by a replica pool's supervisor, never by the scheduler:
    shard-level faults degrade *within* a replica, while
    a replica fault takes the replica out of routing (breaker opens) and
    moves its in-flight queries to a healthy replica (gateway failover).
    """

    def __init__(self, message: str, replica: int):
        super().__init__(message)
        self.replica = replica


class ReplicaCrashed(ReplicaFault):
    """The replica process died: its service is closed (in-flight handles
    report ``cancelled``), the pool quarantines the slot and restarts a
    fresh :class:`~repro_torch.service.FrogWildService` over the *same*
    shared slab — zero index rebuild, object identity preserved."""


class ReplicaStalled(ReplicaFault):
    """The replica missed its heartbeat deadline (wave wall-time exceeded
    ``heartbeat_timeout_s``): progress must never be hostage to one slow
    worker, so the pool quarantines it and the gateway reroutes. The
    replica itself stays open — after the breaker cooldown it is probed
    half-open and returns to rotation on the first clean wave."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One entry of the supervisor's fault log (provenance, not control)."""

    kind: str                       # shard_loss | transient | timeout |
                                    # stall | retry | failover | readmit
    wave: int
    attempt: int = 0
    shard: Optional[int] = None
    detail: str = ""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic, seed-driven fault schedule.

    Wave indices count *successful* waves the scheduler has completed (so
    "wave 1" is the second wave a query stream drives); attempt indices
    count retries of one wave (0 = first try).

    Fields:
      seed:             drives the probabilistic faults and the payload
                        mangling offsets — same seed, same fault sequence.
      shard_losses:     ``((wave, shard), ...)`` — permanent loss of
                        ``shard`` surfacing at ``wave``: the scheduler
                        evicts it and serves degraded waves from then on.
      transient_faults: ``((wave, count), ...)`` — the wave fails
                        ``count`` consecutive attempts, then succeeds
                        (exercises bounded retry + backoff).
      stalls:           ``((wave, seconds), ...)`` — injected stall before
                        the wave body (a slow shard); fires once. With a
                        configured ``wave_timeout_s`` below ``seconds``
                        this becomes a detected timeout.
      wave_timeouts:    ``((wave, count), ...)`` — simulated hang: the
                        wave raises :class:`WaveTimeout` for ``count``
                        attempts without running, then succeeds.
      p_transient:      per-(wave, attempt) transient-failure probability,
                        drawn from ``seed`` (sweeps / soak tests).
      corrupt_ckpt_shards:  shard ids whose on-disk checkpoint payload
                        :meth:`FaultInjector.mangle_checkpoints` bit-flips.
      truncate_ckpt_shards: shard ids whose payload it truncates.

    Replica-level faults are injected at the **pool boundary**: a replica
    pool consults them before dispatching a wave to the replica's
    scheduler. Their wave
    indices count the *pool's* drives of that replica, independently of
    the scheduler-level schedule above:

      replica_crashes:  ``((replica, wave), ...)`` — the replica dies at
                        its ``wave``-th pool drive: its service closes,
                        :class:`ReplicaCrashed` surfaces, the pool
                        quarantines + restarts it over the same slab.
      replica_stalls:   ``((replica, wave, seconds), ...)`` — one
                        injected stall of ``seconds`` before that drive's
                        wave body; a stall past the pool's
                        ``heartbeat_timeout_s`` is detected as
                        :class:`ReplicaStalled` (quarantine + reroute).
      replica_slow:     ``((replica, seconds), ...)`` — persistent
                        per-wave extra latency (a degraded-but-alive
                        straggler): lowers the replica's health score and
                        trips the gateway's hedging threshold.
    """

    seed: int = 0
    shard_losses: Tuple[Tuple[int, int], ...] = ()
    transient_faults: Tuple[Tuple[int, int], ...] = ()
    stalls: Tuple[Tuple[int, float], ...] = ()
    wave_timeouts: Tuple[Tuple[int, int], ...] = ()
    p_transient: float = 0.0
    corrupt_ckpt_shards: Tuple[int, ...] = ()
    truncate_ckpt_shards: Tuple[int, ...] = ()
    replica_crashes: Tuple[Tuple[int, int], ...] = ()
    replica_stalls: Tuple[Tuple[int, int, float], ...] = ()
    replica_slow: Tuple[Tuple[int, float], ...] = ()

    @property
    def empty(self) -> bool:
        """True when the plan schedules nothing (the overhead-measurement
        arm: injector attached, no faults fire)."""
        return not (self.shard_losses or self.transient_faults
                    or self.stalls or self.wave_timeouts
                    or self.p_transient > 0.0
                    or self.corrupt_ckpt_shards
                    or self.truncate_ckpt_shards
                    or self.replica_crashes or self.replica_stalls
                    or self.replica_slow)


class FaultInjector:
    """Runtime companion of a :class:`FaultPlan`.

    Consumable state: each scheduled event fires its budgeted number of
    times and then clears, so a supervised retry loop always terminates on
    injected faults. All randomness derives from ``plan.seed`` keyed by
    (wave, attempt) — call order cannot change the fault sequence.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._losses: Dict[int, List[int]] = {}
        for wave, shard in plan.shard_losses:
            self._losses.setdefault(int(wave), []).append(int(shard))
        self._transient = {int(w): int(c) for w, c in plan.transient_faults}
        self._timeouts = {int(w): int(c) for w, c in plan.wave_timeouts}
        self._stalls = {int(w): float(s) for w, s in plan.stalls}
        # replica-level schedules, keyed (replica, pool-wave) — consumed by
        # the ReplicaPool supervisor, invisible to scheduler-level hooks.
        self._replica_crashes = {(int(r), int(w))
                                 for r, w in plan.replica_crashes}
        self._replica_stalls = {(int(r), int(w)): float(s)
                                for r, w, s in plan.replica_stalls}
        self._replica_slow = {int(r): float(s) for r, s in plan.replica_slow}
        self.fired: List[FaultEvent] = []

    # --- wave-supervisor hooks -------------------------------------------

    def shard_losses_at(self, wave: int) -> List[int]:
        """Permanent shard losses surfacing at this wave (consumed once)."""
        shards = self._losses.pop(wave, [])
        for s in shards:
            self.fired.append(FaultEvent("shard_loss", wave, shard=s))
        return shards

    def stall_s(self, wave: int) -> float:
        """Injected stall (seconds) before this wave's body; fires once."""
        s = self._stalls.pop(wave, 0.0)
        if s:
            self.fired.append(FaultEvent("stall", wave,
                                         detail=f"{s:.3g}s"))
        return s

    def fail_attempt(self, wave: int, attempt: int) -> Optional[str]:
        """``"transient"`` / ``"timeout"`` when this (wave, attempt) is
        scheduled to fail, else None. Scheduled counts decrement; the
        seeded ``p_transient`` coin is keyed by (seed, wave, attempt)."""
        if self._timeouts.get(wave, 0) > 0:
            self._timeouts[wave] -= 1
            self.fired.append(FaultEvent("timeout", wave, attempt))
            return "timeout"
        if self._transient.get(wave, 0) > 0:
            self._transient[wave] -= 1
            self.fired.append(FaultEvent("transient", wave, attempt))
            return "transient"
        if self.plan.p_transient > 0.0:
            coin = random.Random((self.plan.seed, wave, attempt)).random()
            if coin < self.plan.p_transient:
                self.fired.append(FaultEvent("transient", wave, attempt,
                                             detail="p_transient"))
                return "transient"
        return None

    # --- pool-boundary (replica) hooks ------------------------------------

    def replica_crash_at(self, replica: int, wave: int) -> bool:
        """True when this (replica, pool-wave) is scheduled to crash
        (consumed once — a restarted replica does not re-crash)."""
        if (replica, wave) in self._replica_crashes:
            self._replica_crashes.discard((replica, wave))
            self.fired.append(FaultEvent("replica_crash", wave,
                                         detail=f"replica={replica}"))
            return True
        return False

    def replica_stall_s(self, replica: int, wave: int) -> float:
        """Injected stall (seconds) before this replica's pool drive;
        fires once."""
        s = self._replica_stalls.pop((replica, wave), 0.0)
        if s:
            self.fired.append(FaultEvent(
                "replica_stall", wave,
                detail=f"replica={replica} {s:.3g}s"))
        return s

    def replica_slow_s(self, replica: int) -> float:
        """Persistent per-wave extra latency for a straggler replica
        (0.0 for a healthy one). Not consumable — a slow replica stays
        slow until its plan says otherwise."""
        return self._replica_slow.get(replica, 0.0)

    # --- checkpoint-payload faults ---------------------------------------

    def mangle_checkpoints(self, directory: str) -> List[str]:
        """Applies the plan's corrupt / truncate faults to the per-shard
        checkpoints under ``directory`` (``shard_<s>/step_<k>/arrays.npz``)
        and returns the mangled paths. Deterministic in ``plan.seed``."""
        mangled = []
        for shard in self.plan.corrupt_ckpt_shards:
            for path in self._payload_paths(directory, shard):
                _flip_bytes(path, self.plan.seed ^ shard)
                mangled.append(path)
        for shard in self.plan.truncate_ckpt_shards:
            for path in self._payload_paths(directory, shard):
                _truncate_half(path)
                mangled.append(path)
        return mangled

    @staticmethod
    def _payload_paths(directory: str, shard: int) -> List[str]:
        base = os.path.join(directory, f"shard_{shard:04d}")
        if not os.path.isdir(base):
            return []
        return [os.path.join(base, d, "arrays.npz")
                for d in sorted(os.listdir(base)) if d.startswith("step_")
                and os.path.isfile(os.path.join(base, d, "arrays.npz"))]


def _flip_bytes(path: str, seed: int, stride: int = 97) -> None:
    """Bit-flips every ``stride``-th byte of the file body (deterministic
    offset from ``seed``) — enough to break the stored checksums without
    necessarily breaking the container format."""
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        if not data:
            return
        start = random.Random(seed).randrange(min(stride, len(data)))
        for i in range(start, len(data), stride):
            data[i] ^= 0xFF
        f.seek(0)
        f.write(data)


def _truncate_half(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


__all__ = [
    "FaultError",
    "ShardFault",
    "WaveTimeout",
    "WaveFailedError",
    "ReplicaFault",
    "ReplicaCrashed",
    "ReplicaStalled",
    "FaultEvent",
    "FaultPlan",
    "FaultInjector",
]
