"""Gateway metrics (port of ``repro/gateway/metrics.py``): counters,
latency quantiles, and qps over a sliding window — the numbers a load
balancer or dashboard needs to know whether the tier is healthy,
aggregated from the gateway's own accounting plus each replica
scheduler's :class:`~repro_torch.query.scheduler.SchedulerStats`.

Everything is plain host state (no device work): ``snapshot()`` returns a
JSON-ready dict and is what ``/metrics`` serves.

Fault-tolerance counters: ``failovers`` (queries migrated off a
crashed/stalled replica and replayed elsewhere), ``hedges_fired`` /
``hedges_won`` (duplicate submissions raced against a slow primary, and
how often the hedge certified first), ``sheds`` (submits refused with a
structured overload error — 503 + Retry-After at the HTTP layer — instead
of queueing into a lock convoy), and ``timeouts`` (request deadlines that
expired, HTTP 504). Per-replica health scores, breaker states, and
restart counts live in ``Gateway.stats()["replicas"]`` since they are
supervision state, not counters.
"""
from __future__ import annotations

import collections
import time
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from repro_torch.query.scheduler import AdmissionDecision, RejectReason

__all__ = ["GatewayMetrics"]

# completions remembered for the latency/qps window — enough for stable
# p99 at serving rates, small enough to never matter for memory.
_WINDOW = 2048


class GatewayMetrics:
    def __init__(self):
        self.requests = 0            # everything submitted through the tier
        self.completed = 0           # results handed back (any source)
        self.cache_hits = 0          # served straight from the result cache
        self.joins = 0               # attached to an in-flight duplicate
        self.live = 0                # routed to a replica as a new query
        self.rejected = 0            # replica admission refused
        self.downgraded = 0          # admitted with a clamped plan
        self.rejects_by_reason: Dict[str, int] = collections.Counter()
        # --- fault-tolerance counters ---
        self.failovers = 0           # queries migrated off a dead replica
        self.hedges_fired = 0        # hedged duplicate submissions
        self.hedges_won = 0          # … where the hedge certified first
        self.sheds = 0               # submits refused by overload/breakers
        self.timeouts = 0            # request deadlines expired (HTTP 504)
        # --- dynamic-graph counter ---
        self.epoch_orphaned = 0      # cached certificates dropped by epoch
                                     # bumps (mutation commits)
        # (t_done, latency_s) pairs, newest last
        self._window: Deque[Tuple[float, float]] = collections.deque(
            maxlen=_WINDOW)

    # --- recording hooks (called by the gateway) -------------------------

    def record_admission(self, decision: AdmissionDecision) -> None:
        if not decision.admitted:
            self.rejected += 1
            code = decision.reason_code
            self.rejects_by_reason[
                code.value if isinstance(code, RejectReason) else str(code)
            ] += 1
        elif decision.downgraded:
            self.downgraded += 1

    def record_completion(self, latency_s: float) -> None:
        self.completed += 1
        self._window.append((time.monotonic(), float(latency_s)))

    # --- snapshot ---------------------------------------------------------

    def qps(self) -> float:
        """Completions/sec over the sliding window (0 before 2 samples)."""
        if len(self._window) < 2:
            return 0.0
        span = self._window[-1][0] - self._window[0][0]
        return (len(self._window) - 1) / span if span > 0 else 0.0

    def latency_percentiles(self) -> Tuple[Optional[float], Optional[float]]:
        if not self._window:
            return None, None
        lat = np.asarray([l for _, l in self._window])
        return (float(np.percentile(lat, 50)), float(np.percentile(lat, 99)))

    def snapshot(self) -> Dict[str, object]:
        p50, p99 = self.latency_percentiles()
        return {
            "requests": self.requests,
            "completed": self.completed,
            "cache_hits": self.cache_hits,
            "joins": self.joins,
            "live": self.live,
            "rejected": self.rejected,
            "downgraded": self.downgraded,
            "rejects_by_reason": dict(self.rejects_by_reason),
            "failovers": self.failovers,
            "hedges_fired": self.hedges_fired,
            "hedges_won": self.hedges_won,
            "sheds": self.sheds,
            "timeouts": self.timeouts,
            "epoch_orphaned": self.epoch_orphaned,
            "hit_rate": (self.cache_hits / self.requests
                         if self.requests else 0.0),
            "join_rate": (self.joins / self.requests
                          if self.requests else 0.0),
            "qps": round(self.qps(), 3),
            "p50_ms": None if p50 is None else round(p50 * 1e3, 3),
            "p99_ms": None if p99 is None else round(p99 * 1e3, 3),
        }
