"""Gateway-tier fault tolerance of the port: twins of
``tests/test_gateway_faults.py``, on the CPU (``device="cpu"``).

Each test asserts what its reference test asserts, against
``repro_torch.gateway``, at the reference's sizes (``chung_lu_powerlaw(n=
256, avg_out_deg=6, seed=2)``, R = 12, L = 3, 2 build shards,
``max_walks=512``). Five claims:

* **Failover byte-identity**: a replica crashing mid-query replays the
  query on a healthy replica, and — because every replica is seeded
  identically with a key stream starting at wave 0 — the survived answer
  is byte-identical to the fault-free run. Joined handles migrate with
  their parent.

* **Supervision**: crashes and missed heartbeats open the replica's
  circuit breaker (quarantined out of ``route()``); the breaker walks
  closed → open → half_open → closed; a crashed replica restarts over
  the *same* shared slab (object identity, zero index rebuild).

* **Shedding, not blocking**: overload (backlog past the shed threshold
  or every breaker open) raises ``GatewayOverloadError`` with an honest
  ``retry_after_s``; the HTTP layer maps it to 503 + ``Retry-After``,
  and request deadlines to 504 — a sick tier answers *something* fast.

* **Hedging**: a slow query fires one duplicate on another replica;
  first certified answer wins, the loser is cancelled, the cache sees
  exactly one insert, and a hedge outliving a crashed primary is
  promoted instead of spawning a third copy.

* **Termination**: cancel-with-joiners settles with a classified
  ``WaveFailedError`` (never an infinite poll); a certificate earned
  under epoch e is refused by the cache after ``bump_epoch()`` moved the
  tier to e+1; ``drain()`` finishes in-flight work then closes.

The answers of the failover and hedge runs against the reference
gateway's, byte for byte, are in ``tests/test_torch_gateway.py``.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro_torch import (FrogWildService, Gateway, RuntimeConfig,
                         ServingConfig, ShardConfig)
from repro_torch.distributed.faults import (FaultInjector, FaultPlan,
                                            ReplicaCrashed, WaveFailedError)
from repro_torch.gateway import GatewayOverloadError, serve_http
from repro_torch.graph import chung_lu_powerlaw

DEV = "cpu"
EPS_OK = 0.4   # feasible at max_steps=32 (certificate ≈ 0.392)


def _graph(n=256, seed=2):
    return chung_lu_powerlaw(n=n, avg_out_deg=6, seed=seed)


def _rc(faults=None, seed=11, **serving_kw):
    serving = dict(segments_per_vertex=12, segment_len=3, build_shards=2,
                   max_walks=512, max_queries=3, max_steps=32)
    serving.update(serving_kw)
    return RuntimeConfig(
        runtime=ShardConfig(num_shards=1, seed=seed),
        serving=ServingConfig(**serving), faults=faults)


@pytest.fixture(scope="module")
def graph():
    return _graph()


@pytest.fixture(scope="module")
def reference(graph):
    """The fault-free gateway answer every failover run must reproduce."""
    with Gateway.open(graph, _rc(), device=DEV, replicas=2, cache=False) as gw:
        return gw.topk(k=8, epsilon=EPS_OK, delta=0.1).result()


# ---------------------------------------------------------------------------
# the replica-level fault plan itself
# ---------------------------------------------------------------------------


class TestReplicaFaultPlan:
    def test_crash_is_consumed_once(self):
        inj = FaultInjector(FaultPlan(seed=1, replica_crashes=((1, 2),)))
        assert not inj.replica_crash_at(1, 0)
        assert not inj.replica_crash_at(0, 2)      # other replica untouched
        assert inj.replica_crash_at(1, 2)
        assert not inj.replica_crash_at(1, 2)      # consumed
        assert [e.kind for e in inj.fired] == ["replica_crash"]

    def test_stall_fires_once_slow_is_persistent(self):
        inj = FaultInjector(FaultPlan(
            seed=1, replica_stalls=((0, 1, 0.5),), replica_slow=((1, 0.2),)))
        assert inj.replica_stall_s(0, 0) == 0.0
        assert inj.replica_stall_s(0, 1) == 0.5
        assert inj.replica_stall_s(0, 1) == 0.0    # consumed
        for _ in range(3):                         # slow never drains
            assert inj.replica_slow_s(1) == 0.2
        assert inj.replica_slow_s(0) == 0.0

    def test_empty_plan_has_no_replica_faults(self):
        plan = FaultPlan(seed=0)
        assert plan.empty
        inj = FaultInjector(plan)
        assert not inj.replica_crash_at(0, 0)
        assert inj.replica_stall_s(0, 0) == 0.0
        assert inj.replica_slow_s(0) == 0.0


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------


class TestFailover:
    def test_crash_midquery_failover_is_byte_identical(self, graph,
                                                       reference):
        plan = FaultPlan(seed=3, replica_crashes=((0, 0),))
        with Gateway.open(graph, _rc(plan), device=DEV,
                          replicas=2, cache=False) as gw:
            h = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            assert h.replica == 0                  # routed to the doomed one
            r = h.result()
            # migrated, and the survived answer is the fault-free answer.
            assert h.replica == 1
            assert h.failovers == 1
            assert gw.metrics.failovers == 1
            np.testing.assert_array_equal(r.vertices, reference.vertices)
            np.testing.assert_array_equal(r.scores, reference.scores)
            assert r.epsilon_bound == reference.epsilon_bound
            # the sick replica is quarantined out of routing...
            assert gw.pool.breaker_state(0) == "open"
            assert gw.pool.states[0].crashed
            assert gw.pool.routable() == [1]
            # ...and restarts over the SAME slab: object identity, no
            # rebuild, cold key stream.
            fresh = gw.pool.restart_replica(0)
            assert fresh is gw.pool.replicas[0]
            assert fresh.ensure_index() is gw.pool.index
            assert gw.pool.states[0].restarts == 1
            assert not gw.pool.states[0].crashed

    def test_joiners_migrate_with_their_parent(self, graph, reference):
        plan = FaultPlan(seed=3, replica_crashes=((0, 0),))
        with Gateway.open(graph, _rc(plan), device=DEV, replicas=2) as gw:
            parent = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            joined = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            assert joined.source == "joined"
            pr = parent.result()                   # crash + failover inside
            assert parent.replica == 1
            jr = joined.result()
            assert joined.replica == 1             # migrated with parent
            # identical target ⇒ the joined result IS the parent's object.
            assert jr is pr
            np.testing.assert_array_equal(jr.vertices, reference.vertices)

    def test_no_replica_left_is_classified_not_a_hang(self, graph):
        plan = FaultPlan(seed=3, replica_crashes=((0, 0),))
        with Gateway.open(graph, _rc(plan), device=DEV,
                          replicas=1, cache=False) as gw:
            h = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            with pytest.raises(WaveFailedError, match="failover impossible"):
                h.result()

    def test_zero_fault_gateway_matches_direct_service(self, graph,
                                                       reference):
        """The supervised drive path must not perturb the fault-free
        answer: gateway-over-pool ≡ a cold standalone service."""
        with FrogWildService.open(graph, _rc(), device=DEV) as svc:
            direct = svc.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
        np.testing.assert_array_equal(direct.vertices, reference.vertices)
        np.testing.assert_array_equal(direct.scores, reference.scores)
        assert direct.epsilon_bound == reference.epsilon_bound


# ---------------------------------------------------------------------------
# supervision: stalls, breakers, health
# ---------------------------------------------------------------------------


class TestSupervision:
    def test_stall_quarantines_and_reroutes(self, graph, reference):
        plan = FaultPlan(seed=3, replica_stalls=((0, 0, 0.6),))
        with Gateway.open(graph, _rc(plan), device=DEV,
                          replicas=2, cache=False,
                          heartbeat_timeout_s=0.25) as gw:
            h = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            assert h.replica == 0
            r = h.result()                         # stall → migrate → serve
            assert h.replica == 1
            assert gw.pool.breaker_state(0) == "open"
            assert gw.pool.routable() == [1]
            np.testing.assert_array_equal(r.vertices, reference.vertices)
            # the stalled replica did not crash: its breaker can half-open
            # after the cooldown without a restart.
            assert not gw.pool.states[0].crashed

    def test_breaker_walks_closed_open_half_open_closed(self, graph):
        with Gateway.open(graph, _rc(), device=DEV, replicas=2, cache=False,
                          breaker_failure_threshold=3,
                          breaker_cooldown_s=0.05) as gw:
            pool = gw.pool
            assert pool.breaker_state(0) == "closed"
            pool.record_failure(0, "wave failed")
            pool.record_failure(0, "wave failed")
            assert pool.breaker_state(0) == "closed"   # below threshold
            pool.record_failure(0, "wave failed")
            assert pool.breaker_state(0) == "open"
            assert pool.routable() == [1]
            assert pool.health_score(0) == 0.0
            time.sleep(0.06)
            assert pool.breaker_state(0) == "half_open"  # cooldown elapsed
            assert pool.health_score(0) == 0.5
            assert pool.routable() == [0, 1]  # half_open stays probe-able
            gw.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
            assert pool.breaker_state(0) == "closed"     # clean probe wave
            assert pool.health_score(0) > 0.5
            kinds = [e.kind for e in pool.fault_log]
            assert kinds == ["breaker_open", "breaker_half_open",
                             "breaker_close"]

    def test_half_open_failure_reopens(self, graph):
        with Gateway.open(graph, _rc(), device=DEV, replicas=2, cache=False,
                          breaker_failure_threshold=3,
                          breaker_cooldown_s=0.01) as gw:
            pool = gw.pool
            for _ in range(3):
                pool.record_failure(0, "wave failed")
            time.sleep(0.02)
            assert pool.breaker_state(0) == "half_open"
            pool.record_failure(0, "probe failed")   # one strike in probe
            assert pool.breaker_state(0) == "open"

    def test_crashed_replica_refuses_drive_until_restart(self, graph):
        plan = FaultPlan(seed=3, replica_crashes=((0, 0),))
        with Gateway.open(graph, _rc(plan), device=DEV,
                          replicas=2, cache=False) as gw:
            gw.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
            with pytest.raises(ReplicaCrashed):
                gw.pool.step_replica(0)
            gw.pool.restart_replica(0)
            gw.pool.step_replica(0)                # cold but alive again

    def test_stats_surface_supervision_state(self, graph):
        plan = FaultPlan(seed=3, replica_crashes=((0, 0),))
        with Gateway.open(graph, _rc(plan), device=DEV,
                          replicas=2, cache=False) as gw:
            gw.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
            snap = gw.stats()
            r0, r1 = snap["replicas"]
            assert r0["breaker"] == "open" and r0["crashed"]
            assert r0["health"] == 0.0
            assert r1["breaker"] == "closed" and not r1["crashed"]
            assert snap["failovers"] == 1
            assert {"hedges_fired", "hedges_won", "sheds",
                    "timeouts"} <= snap.keys()
            assert gw.healthy()                    # replica 1 still routable


# ---------------------------------------------------------------------------
# shedding + drain
# ---------------------------------------------------------------------------


class TestShedding:
    def test_overload_sheds_instead_of_blocking(self, graph):
        with Gateway.open(graph, _rc(), device=DEV, replicas=2, cache=False,
                          shed_backlog_walks=1) as gw:
            h = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)   # fills the backlog
            with pytest.raises(GatewayOverloadError) as ei:
                gw.ppr(3, k=8, epsilon=EPS_OK, delta=0.1)
            assert ei.value.reason == "overload"
            assert ei.value.retry_after_s > 0
            assert gw.metrics.sheds == 1
            h.result()                             # the admitted one finishes

    def test_all_breakers_open_sheds_no_replica(self, graph):
        with Gateway.open(graph, _rc(), device=DEV, replicas=2, cache=False,
                          breaker_failure_threshold=1,
                          breaker_cooldown_s=60.0) as gw:
            gw.pool.record_failure(0, "dead")
            gw.pool.record_failure(1, "dead")
            with pytest.raises(GatewayOverloadError) as ei:
                gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            assert ei.value.reason == "no_replica"
            # Retry-After reflects the remaining breaker cooldown.
            assert 0 < ei.value.retry_after_s <= 60.0
            assert not gw.healthy()

    def test_drain_finishes_inflight_then_closes(self, graph):
        with Gateway.open(graph, _rc(), device=DEV, replicas=2) as gw:
            h = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            results = gw.drain()
            assert [r.rid for r in results] == [h.result().rid]
            assert h.done()
            assert gw.closed
            assert gw.drain() == []                # idempotent after close

    def test_draining_rejects_new_submits(self, graph):
        with Gateway.open(graph, _rc(), device=DEV, replicas=2) as gw:
            gw._draining = True                    # freeze admission only
            with pytest.raises(GatewayOverloadError) as ei:
                gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            assert ei.value.reason == "draining"
            with pytest.raises(GatewayOverloadError):
                gw.pagerank(epsilon=EPS_OK, delta=0.1, k=8)


# ---------------------------------------------------------------------------
# hedging
# ---------------------------------------------------------------------------


class TestHedging:
    def test_primary_win_cancels_hedge_one_cache_insert(self, graph):
        plan = FaultPlan(seed=3, replica_slow=((0, 0.05),))
        with Gateway.open(graph, _rc(plan), device=DEV, replicas=2,
                          hedge_after_s=0.01) as gw:
            h = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            assert h.replica == 0
            h.result()
            assert gw.metrics.hedges_fired == 1
            assert gw.metrics.hedges_won == 0      # primary stayed ahead
            assert h._hedge is None                # loser cancelled
            assert gw.cache.insertions == 1        # exactly one insert

    def test_hedge_promoted_when_primary_crashes(self, graph, reference):
        plan = FaultPlan(seed=3, replica_slow=((0, 0.2),),
                         replica_crashes=((0, 2),))
        with Gateway.open(graph, _rc(plan), device=DEV,
                          replicas=2, cache=False,
                          hedge_after_s=0.05) as gw:
            h = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            assert h.replica == 0
            r = h.result()
            assert h.replica == 1                  # the hedge's replica
            assert gw.metrics.hedges_fired == 1
            assert gw.metrics.hedges_won == 1      # promoted, not resubmit
            assert gw.metrics.failovers == 1
            # the promoted hedge ran cold on replica 1 ⇒ byte-identical.
            np.testing.assert_array_equal(r.vertices, reference.vertices)
            np.testing.assert_array_equal(r.scores, reference.scores)
            assert r.epsilon_bound == reference.epsilon_bound

    def test_hedging_disabled_by_default(self, graph):
        plan = FaultPlan(seed=3, replica_slow=((0, 0.05),))
        with Gateway.open(graph, _rc(plan), device=DEV,
                          replicas=2, cache=False) as gw:
            gw.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
            assert gw.metrics.hedges_fired == 0


# ---------------------------------------------------------------------------
# termination: joiner cancel, epoch race
# ---------------------------------------------------------------------------


class TestTermination:
    def test_cancel_with_joiners_is_classified_not_a_poll_loop(self, graph):
        with FrogWildService.open(graph, _rc(), device=DEV) as svc:
            qh = svc.topk(k=8, epsilon=EPS_OK, delta=0.1)
            joined = qh.join(EPS_OK, 0.2)
            assert qh.cancel()
            assert joined.done()                   # terminal, not pending
            with pytest.raises(WaveFailedError, match="cancelled"):
                joined.result()

    def test_bump_epoch_refuses_stale_certificate(self, graph):
        with Gateway.open(graph, _rc(), device=DEV, replicas=2) as gw:
            h = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)   # epoch 0 query
            assert gw.bump_epoch() == 1
            rejected_before = gw.cache.rejected_inserts
            h.result()                             # finishes under epoch 1
            assert gw.cache.rejected_inserts == rejected_before + 1
            assert len(gw.cache) == 0              # nothing stale landed
            # a fresh query on the new epoch caches normally.
            gw.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
            assert len(gw.cache) == 1


# ---------------------------------------------------------------------------
# HTTP: structured backpressure, no lock convoy
# ---------------------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.load(e)


class TestHTTP:
    def test_overload_maps_to_503_with_retry_after(self, graph):
        with Gateway.open(graph, _rc(), device=DEV, replicas=2, cache=False,
                          shed_backlog_walks=1) as gw:
            h = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
            with serve_http(gw) as srv:
                # a distinct key: the same key would ride the in-flight
                # join (dedup costs no new walks, so it is never shed).
                code, headers, body = _get(
                    f"{srv.url}/ppr?source=3&k=8&epsilon={EPS_OK}"
                    f"&delta=0.1")
                assert code == 503
                assert body["reason_code"] == "overload"
                assert int(headers["Retry-After"]) >= 1
                # /healthz and /metrics still answer while overloaded.
                code, _, hz = _get(f"{srv.url}/healthz")
                assert code == 200 and hz["healthy"]
                code, _, m = _get(f"{srv.url}/metrics")
                assert code == 200 and m["sheds"] == 1
            h.result()

    def test_deadline_maps_to_504(self, graph):
        with Gateway.open(graph, _rc(), device=DEV,
                          replicas=2, cache=False) as gw:
            with serve_http(gw) as srv:
                code, _, body = _get(
                    f"{srv.url}/topk?k=8&epsilon={EPS_OK}&delta=0.1"
                    f"&timeout_s=0.000001")
                assert code == 504
                assert body["reason_code"] == "deadline"
                assert gw.metrics.timeouts == 1

    def test_healthz_reports_quarantine(self, graph):
        plan = FaultPlan(seed=3, replica_crashes=((0, 0),))
        with Gateway.open(graph, _rc(plan), device=DEV,
                          replicas=2, cache=False) as gw:
            gw.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
            with serve_http(gw) as srv:
                code, _, hz = _get(f"{srv.url}/healthz")
                assert code == 200                 # degraded, still serving
                assert hz["routable"] == [1]
