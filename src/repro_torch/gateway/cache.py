"""(ε, δ)-aware result cache (port of ``repro/gateway/cache.py``, pure
Python over the port's :class:`~repro_torch.query.scheduler.QueryResult`,
whose ``vertices`` and ``scores`` are numpy arrays): Theorem 1 makes reuse
principled.

A generic result cache can only serve *exact* repeats; FrogWild's
certificates make sharing sound across users asking for different
accuracies. Every finished query carries the ε Theorem 1 certifies for the
walks it executed, at the δ it was requested at. That pair is a
**certificate** ``(ε′, δ′)``, and the dominance contract is:

    a cached answer certified at (ε′, δ′) serves a request for (ε, δ)
    iff ε′ ≤ ε and δ′ ≤ δ — the cached guarantee is at least as strong
    in both coordinates, so the new user gets what they asked for free.

Keys are ``(query kind, k, target/source vertex, graph epoch)``; a key
holds the *Pareto frontier* of certificates seen so far (two certificates
can be incomparable — tighter ε at looser δ — so one slot would silently
throw away reusable guarantees). Degraded answers — walks died on evicted
shards — are **never** cached: their bound is honest for the moment the
fault happened, but serving them after recovery would pin the outage into
the cache. Bumping the graph epoch (dynamic-graph refresh) orphans every
older key without a scan.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.query.scheduler import QueryResult

__all__ = ["CacheEntry", "Certificate", "ResultCache"]

CacheKey = Tuple[str, int, int, int]     # (kind, k, source, epoch)


@dataclasses.dataclass(frozen=True)
class Certificate:
    """An (ε′, δ′) guarantee attached to a cached answer."""

    epsilon: float
    delta: float

    def dominates(self, epsilon: float, delta: float) -> bool:
        """True iff this certificate satisfies a request for (ε, δ)."""
        return self.epsilon <= epsilon and self.delta <= delta


@dataclasses.dataclass(frozen=True)
class CacheEntry:
    cert: Certificate
    result: QueryResult


class ResultCache:
    """LRU over query keys, Pareto frontier of certificates per key."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be ≥ 1, got {capacity}")
        self.capacity = capacity
        self._entries: "collections.OrderedDict[CacheKey, List[CacheEntry]]" = (
            collections.OrderedDict())
        self.hits = 0                # requests served from the cache
        self.dominated_hits = 0      # … of those, by a strictly stronger cert
        self.misses = 0
        self.insertions = 0
        self.rejected_inserts = 0    # degraded / uncertified answers refused
        self.epoch_evictions = 0     # certificates dropped by epoch bumps

    @staticmethod
    def key(kind: str, k: int, source: int, epoch: int) -> CacheKey:
        """Canonical cache key. Global queries (top-k, pagerank) have no
        source vertex — it is normalized away so a caller-supplied dummy
        can't split their cache lines."""
        src = int(source) if kind == "ppr" else -1
        return (kind, int(k), src, int(epoch))

    def lookup(self, key: CacheKey, epsilon: float,
               delta: float) -> Optional[CacheEntry]:
        """The first cached certificate dominating (ε, δ), else None."""
        entries = self._entries.get(key)
        if entries:
            for e in entries:
                if e.cert.dominates(epsilon, delta):
                    self._entries.move_to_end(key)
                    self.hits += 1
                    if e.cert.epsilon < epsilon or e.cert.delta < delta:
                        self.dominated_hits += 1
                    return e
        self.misses += 1
        return None

    def insert(self, key: CacheKey, result: QueryResult,
               delta: float, min_epoch: Optional[int] = None) -> bool:
        """Caches a certified answer under ``key``; returns False when the
        answer is uncacheable (degraded, no finite certificate, or — with
        ``min_epoch`` — certified under a graph epoch older than the
        gateway's current one) or an already-cached certificate dominates
        it.

        ``min_epoch`` is the bump-epoch race guard: a query started on
        epoch ``e`` whose certificate lands after the gateway moved to
        ``e+1`` must never enter the cache (its key could collide with a
        fresh epoch-``e`` lookup only through ``drop_epochs_before``
        ordering bugs, and even inert stale entries burn capacity).
        Refused stale inserts count in ``rejected_inserts``.
        """
        if min_epoch is not None and key[3] < min_epoch:
            self.rejected_inserts += 1
            return False
        if (result.degraded or result.epsilon_bound <= 0.0
                or not math.isfinite(result.epsilon_bound)):
            self.rejected_inserts += 1
            return False
        cert = Certificate(float(result.epsilon_bound), float(delta))
        entries = self._entries.get(key, [])
        if any(e.cert.dominates(cert.epsilon, cert.delta) for e in entries):
            return False
        entries = [e for e in entries
                   if not cert.dominates(e.cert.epsilon, e.cert.delta)]
        entries.append(CacheEntry(cert=cert, result=result))
        self._entries[key] = entries
        self._entries.move_to_end(key)
        self.insertions += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        return True

    def drop_epochs_before(self, epoch: int) -> int:
        """Evicts every key from an older graph epoch (they can never hit
        again once the gateway's epoch moved on); returns the count, also
        accumulated in ``epoch_evictions`` (surfaced via ``stats()``)."""
        stale = [k for k in self._entries if k[3] < epoch]
        for k in stale:
            del self._entries[k]
        self.epoch_evictions += len(stale)
        return len(stale)

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, float]:
        looked = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "dominated_hits": self.dominated_hits,
            "misses": self.misses,
            "insertions": self.insertions,
            "rejected_inserts": self.rejected_inserts,
            "epoch_evictions": self.epoch_evictions,
            "hit_rate": (self.hits / looked) if looked else 0.0,
        }
