"""The serving gateway of the port: twins of ``tests/test_gateway.py`` on
the CPU (``device="cpu"``), its answers against the reference gateway's
byte for byte, and the card's.

Each twin asserts what its reference test asserts, against
``repro_torch.gateway``, at the reference's sizes (``chung_lu_powerlaw(n=
256, avg_out_deg=6, seed=2)``, R = 12, L = 3, 2 build shards,
``max_walks=512``). Four claims:

* **Dominance**: a cached answer certified at (ε′, δ′) serves a request
  for (ε, δ) iff ε′ ≤ ε and δ′ ≤ δ — dominated repeats come back
  byte-identical with zero new walks; near-misses (ε < ε′) go live;
  degraded answers are never cached; bumping the graph epoch invalidates.

* **In-flight dedup**: a duplicate of a live query joins its handle
  instead of spawning walks; with an identical target the joined result
  is the parent's ``QueryResult`` object verbatim.

* **Replica economics**: N replicas share ONE walk-index slab (object
  identity), the router lands new work on the lowest EDF-charged queue,
  and a cold gateway replica answers byte-identically to a cold
  standalone service under the same config.

* **Lifecycle + structured rejection**: ``close()`` is idempotent and
  safe with handles in flight; ``AdmissionDecision.reason_code``
  distinguishes infeasible-SLO / capacity / shard-loss refusals.

A module-scoped fixture runs the same scenarios through the reference
``Gateway`` and the port's on the same graph, config and seed: the cold
miss, the dominated hit, the in-flight joins, the cached batch estimate,
the crash failover, the hedge promoted on a primary crash, and the query
spanning an epoch commit (and one after it); each answer must match in
vertices, scores, ``epsilon_bound``, ``num_walks``, ``waves`` and
``source``. The ``cuda`` tests run on the card (skipped here): replicas
share the index's storage, and a 2-replica gateway there answers as the
CPU's does. The reference is imported inside its fixture only, so the
card tests run where JAX is not installed.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch import (FrogWildService, Gateway, RuntimeConfig,
                         ServingConfig, ShardConfig)
from repro_torch.distributed.faults import FaultPlan
from repro_torch.gateway import (Certificate, ReplicaPool, ResultCache,
                                 serve_http)
from repro_torch.graph import chung_lu_powerlaw
from repro_torch.query import (QueryRequest, QueryResult, RejectReason,
                               SchedulerStats)

DEV = "cpu"
# ε=0.4 plans are feasible at max_steps=32 (certificate ≈ 0.392 ≤ 0.4);
# tighter requests are honestly clamped wider — used for near-miss tests.
EPS_OK = 0.4


def _graph(n=256, seed=2):
    return chung_lu_powerlaw(n=n, avg_out_deg=6, seed=seed)


def _rc(num_shards=1, seed=11, **serving_kw):
    serving = dict(segments_per_vertex=12, segment_len=3, build_shards=2,
                   max_walks=512, max_queries=3, max_steps=32)
    serving.update(serving_kw)
    return RuntimeConfig(
        runtime=ShardConfig(num_shards=num_shards, seed=seed),
        serving=ServingConfig(**serving))


@pytest.fixture(scope="module")
def gw():
    with Gateway.open(_graph(), _rc(), device=DEV, replicas=2) as g:
        yield g


# --- the cache: dominance is the whole contract ------------------------------


def test_certificate_dominance_rule():
    c = Certificate(epsilon=0.3, delta=0.1)
    assert c.dominates(0.3, 0.1)            # equality is dominance
    assert c.dominates(0.5, 0.2)
    assert not c.dominates(0.2, 0.1)        # tighter ε refused
    assert not c.dominates(0.5, 0.05)       # tighter δ refused


def test_cache_keeps_a_pareto_frontier_per_key():
    cache = ResultCache()
    key = ResultCache.key("topk", 8, 0, 0)

    def res(eps):
        return QueryResult(rid=0, kind="topk",
                           vertices=np.arange(8), scores=np.ones(8),
                           num_walks=100, num_steps=8, waves=1,
                           latency_s=0.1, epsilon_bound=eps)

    assert cache.insert(key, res(0.3), delta=0.10)
    assert cache.insert(key, res(0.2), delta=0.20)   # incomparable: kept
    assert cache.lookup(key, 0.3, 0.1) is not None
    assert cache.lookup(key, 0.2, 0.2) is not None
    assert cache.lookup(key, 0.2, 0.1) is None       # dominated by neither
    # a certificate dominated by a stored one is refused; a dominating one
    # prunes what it obsoletes
    assert not cache.insert(key, res(0.35), delta=0.15)
    assert cache.insert(key, res(0.2), delta=0.10)
    assert len(cache._entries[key]) == 1


def test_degraded_and_uncertified_results_never_cached():
    cache = ResultCache()
    key = ResultCache.key("topk", 8, 0, 0)
    bad = QueryResult(rid=0, kind="topk", vertices=np.arange(8),
                      scores=np.ones(8), num_walks=50, num_steps=8,
                      waves=1, latency_s=0.1, epsilon_bound=0.3,
                      degraded=True)
    assert not cache.insert(key, bad, delta=0.1)
    no_cert = QueryResult(rid=1, kind="topk", vertices=np.arange(8),
                          scores=np.ones(8), num_walks=50, num_steps=8,
                          waves=1, latency_s=0.1, epsilon_bound=0.0)
    assert not cache.insert(key, no_cert, delta=0.1)
    assert cache.rejected_inserts == 2 and len(cache) == 0


def test_ppr_sources_split_keys_but_global_kinds_ignore_source():
    assert ResultCache.key("ppr", 8, 3, 0) != ResultCache.key("ppr", 8, 4, 0)
    assert ResultCache.key("topk", 8, 3, 0) == ResultCache.key("topk", 8, 4, 0)


# --- the gateway: hit / near-miss / join / epoch -----------------------------


def test_dominated_repeat_hits_with_zero_new_walks(gw):
    r1 = gw.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
    waves = gw.pool.total_waves_run()
    # identical repeat and a strictly weaker request: both cache hits
    h2 = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
    h3 = gw.topk(k=8, epsilon=0.6, delta=0.2)
    assert h2.source == "cache" and h3.source == "cache"
    assert h2.result() is r1 and h3.result() is r1     # byte-identical
    assert gw.pool.total_waves_run() == waves          # zero new walks


def test_near_miss_tighter_than_certificate_goes_live(gw):
    r1 = gw.topk(k=10, epsilon=EPS_OK, delta=0.1).result()
    h = gw.topk(k=10, epsilon=r1.epsilon_bound * 0.9, delta=0.1)
    assert h.source == "live"
    h.result()
    # ... and a tighter δ alone also misses
    h2 = gw.topk(k=10, epsilon=EPS_OK, delta=0.05)
    assert h2.source == "live"
    h2.result()


def test_inflight_duplicate_joins_and_identical_target_is_verbatim(gw):
    h1 = gw.ppr(7, k=6, epsilon=0.34, delta=0.1)     # uncacheable: clamped
    assert h1.source == "live"
    h2 = gw.ppr(7, k=6, epsilon=0.5, delta=0.1)      # weaker: joins
    h3 = gw.ppr(7, k=6, epsilon=0.34, delta=0.1)     # identical: joins
    assert h2.source == "joined" and h3.source == "joined"
    waves = gw.pool.total_waves_run()
    r1 = h1.result()
    assert h3.result() is r1                          # verbatim object
    r2 = h2.result()                                  # certified no later
    assert r2.epsilon_bound <= 0.5
    # the joins rode h1's walks — finishing h2/h3 ran nothing new
    assert gw.pool.total_waves_run() == waves or h2.done()


def test_epoch_bump_invalidates_cached_certificates(gw):
    r1 = gw.topk(k=12, epsilon=EPS_OK, delta=0.1).result()
    assert gw.topk(k=12, epsilon=EPS_OK, delta=0.1).source == "cache"
    gw.bump_epoch()
    h = gw.topk(k=12, epsilon=EPS_OK, delta=0.1)
    assert h.source == "live"                         # stale cert orphaned
    assert h.result() is not r1


def test_batch_pagerank_is_cached_under_its_plan_certificate(gw):
    p1 = gw.pagerank(epsilon=0.5, delta=0.1, k=6)
    assert gw.pagerank(epsilon=0.5, delta=0.1, k=6) is p1
    assert gw.pagerank(epsilon=0.45, delta=0.1, k=6) is not p1


def test_metrics_snapshot_has_the_serving_numbers(gw):
    s = gw.stats()
    for k in ("requests", "completed", "cache_hits", "joins", "hit_rate",
              "join_rate", "qps", "p50_ms", "p99_ms", "rejects_by_reason",
              "cache", "replicas", "epoch"):
        assert k in s, k
    assert s["cache_hits"] >= 2 and s["joins"] >= 2
    assert len(s["replicas"]) == 2
    for r in s["replicas"]:
        assert r["lost_shards"] == []
        assert 0.0 <= r["wave_occupancy"] <= 1.0
    assert isinstance(gw.pool.replicas[0].serving_stats(), SchedulerStats)


# --- replica economics -------------------------------------------------------


def test_pool_shares_one_walk_index_slab():
    with ReplicaPool(_graph(), _rc(), device=DEV, num_replicas=3) as pool:
        idx = pool.replicas[0].ensure_index()
        for r in pool.replicas[1:]:
            assert r.ensure_index() is idx            # no N-fold slabs
        assert pool.replicas[0].graph is pool.replicas[1].graph


def test_router_prefers_the_lowest_charged_backlog():
    with Gateway.open(_graph(), _rc(), device=DEV,
                      replicas=2, cache=False) as gw2:
        h1 = gw2.topk(k=8, epsilon=EPS_OK, delta=0.1)
        assert h1.replica == 0
        # replica 0 now carries h1's backlog → the next request (a
        # different key, so dedup can't capture it) routes away
        h2 = gw2.topk(k=9, epsilon=0.5, delta=0.1)
        assert h2.source == "live" and h2.replica == 1
        st = gw2.pool.replicas[0].serving_stats()
        assert st.backlog_walks > 0
        h1.result(), h2.result()
        # drained: both replicas report empty queues again
        assert all(r.serving_stats().backlog_walks == 0
                   for r in gw2.pool.replicas)


def test_cold_gateway_replica_matches_cold_standalone_service():
    """Byte-identity across the tier: the first query through a fresh
    gateway (replica 0) equals the same query on a fresh direct service
    under the same config — the gateway adds routing, not noise."""
    g = _graph()
    direct = FrogWildService.open(g, _rc(), device=DEV).topk(
        k=8, epsilon=EPS_OK, delta=0.1).result()
    with Gateway.open(g, _rc(), device=DEV, replicas=2) as gw2:
        viagw = gw2.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
    assert (np.asarray(viagw.vertices) == np.asarray(direct.vertices)).all()
    assert (np.asarray(viagw.scores) == np.asarray(direct.scores)).all()
    assert viagw.epsilon_bound == direct.epsilon_bound
    assert viagw.num_walks == direct.num_walks


# --- degraded answers stay out of the cache ----------------------------------


def test_degraded_results_are_served_but_never_cached():
    cfg = RuntimeConfig(
        runtime=ShardConfig(num_shards=4, seed=3),
        serving=ServingConfig(segments_per_vertex=6, segment_len=2,
                              build_shards=4, max_walks=512, max_queries=4,
                              max_steps=12),
        faults=FaultPlan(shard_losses=((1, 0),)))
    with Gateway.open(_graph(), cfg, device=DEV, replicas=1) as gw2:
        h = gw2.topk(k=8, epsilon=0.6, delta=0.1)
        r = h.result()
        assert r.degraded
        assert gw2.cache.stats()["rejected_inserts"] >= 1
        assert len(gw2.cache) == 0
        # the repeat goes live — the outage is not pinned into the cache
        assert gw2.topk(k=8, epsilon=0.6, delta=0.1).source == "live"


# --- lifecycle: close() is idempotent and pool-safe --------------------------


def test_service_close_is_idempotent_with_inflight_handles():
    svc = FrogWildService.open(_graph(), _rc(), device=DEV)
    h = svc.topk(k=8, epsilon=EPS_OK, delta=0.1)
    h.poll()                                  # mid-flight
    svc.close()
    svc.close()                               # double-close: no raise
    assert svc.closed
    assert h.status() == "cancelled" and h.done()
    assert not h.cancel()
    with pytest.raises(RuntimeError, match="closed"):
        svc.topk(k=4)
    with pytest.raises(RuntimeError, match="closed"):
        svc.pagerank(epsilon=0.5)
    assert svc.serving_stats() is None


def test_gateway_close_is_idempotent_and_closes_every_replica():
    gw2 = Gateway.open(_graph(), _rc(), device=DEV, replicas=2)
    h = gw2.topk(k=8, epsilon=EPS_OK, delta=0.1)
    h.poll()
    gw2.close()
    gw2.close()
    assert gw2.closed and gw2.pool.closed
    assert all(r.closed for r in gw2.pool.replicas)
    with pytest.raises(RuntimeError, match="closed"):
        gw2.topk(k=4)


# --- structured rejection reasons --------------------------------------------


def _sched(**kw):
    from repro_torch.query import (QueryScheduler, WalkIndexConfig,
                                   shard_walk_index)
    from repro_torch.query.index import _build_walk_index
    g = _graph()
    idx = _build_walk_index(g, WalkIndexConfig(
        segments_per_vertex=6, segment_len=2, num_shards=4, seed=2))
    kw.setdefault("max_walks", 512)
    kw.setdefault("max_queries", 2)
    kw.setdefault("max_steps", 12)
    return QueryScheduler(g, shard_walk_index(idx, 4), seed=7, **kw)


def test_reject_reason_codes_distinguish_the_three_refusals():
    sched = _sched(wave_time_estimate_s=1.0, max_queries=1)
    ok = sched._submit(QueryRequest(rid=0, num_walks=512))
    assert ok.admitted and ok.reason_code == RejectReason.NONE
    # (a) SLO shorter than one wave
    d = sched._submit(QueryRequest(rid=1, num_walks=64, slo_s=0.5))
    assert not d.admitted and d.reason_code == RejectReason.INFEASIBLE_SLO
    # (b) feasible SLO, demand too large for the wave budget
    d = sched._submit(QueryRequest(rid=2, num_walks=4096, slo_s=3.0))
    assert not d.admitted and d.reason_code == RejectReason.CAPACITY
    # (c) shard loss re-admission: queued SLO work rejected by eviction
    sched._admit()
    assert sched._submit(QueryRequest(rid=3, num_walks=1024,
                                      slo_s=4.0)).admitted
    for s in (0, 1, 3):
        sched._evict_shard(s, wave_no=0)
    d = next(d for d in sched.rejected if d.rid == 3)
    assert d.reason_code == RejectReason.SHARD_LOSS


# --- HTTP front-end ----------------------------------------------------------


def _get(url):
    with urllib.request.urlopen(url) as resp:
        return resp.status, json.loads(resp.read())


def test_http_front_end_serves_queries_health_and_metrics(gw):
    with serve_http(gw) as srv:
        status, body = _get(srv.url + "/healthz")
        assert status == 200 and body["healthy"]
        status, body = _get(srv.url + f"/topk?k=4&epsilon={EPS_OK}")
        assert status == 200 and len(body["vertices"]) == 4
        assert body["epsilon_bound"] <= EPS_OK
        status, rep = _get(srv.url + f"/topk?k=4&epsilon={EPS_OK}")
        assert rep["source"] == "cache" and rep["vertices"] == body["vertices"]
        status, body = _get(srv.url + "/ppr?source=5&k=3&epsilon=0.6")
        assert status == 200 and body["kind"] == "ppr"
        status, body = _get(srv.url + "/metrics")
        assert body["requests"] >= 3 and body["cache_hits"] >= 1
        # bad params → 400; unknown route → 404 (stdlib raises HTTPError)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/ppr?k=3")                # missing source
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/nope")
        assert e.value.code == 404


# --- dynamic graphs through the tier ---------------------------------------


def test_mutation_stream_orphans_certificates_and_refreshes_replicas():
    """apply_mutations through the gateway: the cache's old-epoch
    certificates are orphaned (counted twice — gateway metric and cache
    stat), replicas serve the new epoch, and a repeat of a previously
    cached query goes live."""
    from repro_torch.dynamic import MutationBatch

    g = _graph(n=128, seed=7)
    with Gateway.open(g, _rc(), device=DEV, replicas=2) as gw2:
        r1 = gw2.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
        assert gw2.topk(k=8, epsilon=EPS_OK, delta=0.1).source == "cache"
        report = gw2.apply_mutations(MutationBatch.edges(insert=[(1, 100)]))
        assert report.epoch == 1
        assert report.segments_rebuilt == report.stale_segments
        assert gw2.epoch == 1
        assert gw2.metrics.epoch_orphaned >= 1
        assert gw2.cache.stats()["epoch_evictions"] >= 1
        s = gw2.stats()
        assert s["graph_epoch"] == 1
        assert s["epoch_orphaned"] >= 1
        h = gw2.topk(k=8, epsilon=EPS_OK, delta=0.1)
        assert h.source == "live"                 # stale cert orphaned
        r2 = h.result()
        assert r1.epoch == 0 and r2.epoch == 1


def test_inflight_gateway_query_spans_epoch_commit():
    """A live query admitted before the mutation finishes on its pinned
    epoch-0 slab, byte-identical to a gateway that never mutated — and
    its stale certificate is refused at cache-insert time."""
    from repro_torch.dynamic import MutationBatch

    g = _graph(n=128, seed=8)
    with Gateway.open(g, _rc(), device=DEV, replicas=1) as ctrl:
        rc_ = ctrl.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
    with Gateway.open(g, _rc(), device=DEV, replicas=1) as gw2:
        h = gw2.topk(k=8, epsilon=EPS_OK, delta=0.1)
        assert h.source == "live"
        gw2.apply_mutations(
            MutationBatch.edges(insert=[(3, 90), (60, 5)]))
        r = h.result()
        assert r.epoch == 0
        assert np.array_equal(r.vertices, rc_.vertices)
        assert np.array_equal(r.scores, rc_.scores)
        assert r.num_walks == rc_.num_walks
        # the old-epoch certificate never entered the cache: the same
        # query at the new epoch must go live, not hit
        assert gw2.cache.stats()["rejected_inserts"] >= 1
        assert gw2.topk(k=8, epsilon=EPS_OK, delta=0.1).source == "live"


# --- the index handed to a service stays the caller's object ---------------


@pytest.mark.parametrize("num_shards", [1, 4])
def test_service_open_with_an_index_keeps_its_object(num_shards):
    """``FrogWildService.open(..., index=idx).ensure_index() is idx`` for a
    dense slab and a sharded one, across ``close()`` of another service
    that shared it (close drops references, never the tensors)."""
    g = _graph()
    first = FrogWildService.open(g, _rc(num_shards=num_shards), device=DEV)
    idx = first.ensure_index()
    second = FrogWildService.open(g, _rc(num_shards=num_shards), device=DEV,
                                  index=idx)
    assert second.ensure_index() is idx
    assert second.graph is first.graph
    slab = idx.endpoints if num_shards == 1 else idx.blocks
    before = slab.clone()
    first.close()
    assert second.ensure_index() is idx and torch.equal(slab, before)
    second.topk(k=8, epsilon=EPS_OK, delta=0.1).result()
    second.close()


# --- byte for byte against the reference gateway ---------------------------


class _API:
    """One package's gateway surface, the reference's imported here only."""

    def __init__(self, pkg):
        if pkg == "ref":
            from repro import Gateway as G
            from repro import RuntimeConfig as RC
            from repro import ServingConfig as SC
            from repro import ShardConfig as ShC
            from repro.distributed.faults import FaultPlan as FP
            from repro.dynamic import MutationBatch as MB
            from repro.graph import chung_lu_powerlaw as gen
            self.open_kw = {}
        else:
            from repro_torch import Gateway as G
            from repro_torch import RuntimeConfig as RC
            from repro_torch import ServingConfig as SC
            from repro_torch import ShardConfig as ShC
            from repro_torch.distributed.faults import FaultPlan as FP
            from repro_torch.dynamic import MutationBatch as MB
            from repro_torch.graph import chung_lu_powerlaw as gen
            self.open_kw = {"device": DEV}
        self.Gateway, self.FaultPlan, self.MutationBatch = G, FP, MB
        self.RuntimeConfig, self.ServingConfig = RC, SC
        self.ShardConfig, self.gen = ShC, gen

    def graph(self, n=256, seed=2):
        return self.gen(n=n, avg_out_deg=6, seed=seed)

    def rc(self, faults=None):
        return self.RuntimeConfig(
            runtime=self.ShardConfig(num_shards=1, seed=11),
            serving=self.ServingConfig(
                segments_per_vertex=12, segment_len=3, build_shards=2,
                max_walks=512, max_queries=3, max_steps=32),
            faults=faults)

    def open(self, g, rc, **kw):
        return self.Gateway.open(g, rc, **kw, **self.open_kw)


def _scenarios(api):
    """``{scenario: (result, source, counters)}`` through one package's
    gateway; ``counters`` are the gateway's failover and hedge counts."""
    out = {}

    def keep(name, h, gw):
        r = h.result()
        out[name] = (r, h.source, (gw.metrics.failovers,
                                   gw.metrics.hedges_fired,
                                   gw.metrics.hedges_won))

    g = api.graph()
    with api.open(g, api.rc(), replicas=2) as gw:
        keep("cold_miss", gw.topk(k=8, epsilon=EPS_OK, delta=0.1), gw)
        keep("dominated_hit", gw.topk(k=8, epsilon=0.6, delta=0.2), gw)
        parent = gw.ppr(7, k=6, epsilon=0.34, delta=0.1)
        same = gw.ppr(7, k=6, epsilon=0.34, delta=0.1)
        weaker = gw.ppr(7, k=6, epsilon=0.5, delta=0.1)
        keep("join_parent", parent, gw)
        keep("join_identical", same, gw)
        keep("join_weaker", weaker, gw)
        for name in ("live", "cached"):
            hits = gw.metrics.cache_hits
            r = gw.pagerank(epsilon=0.5, delta=0.1, k=6)
            src = "cache" if gw.metrics.cache_hits > hits else "live"
            out["pagerank_" + name] = (r, src, ())
    crash = api.FaultPlan(seed=3, replica_crashes=((0, 0),))
    with api.open(g, api.rc(crash), replicas=2, cache=False) as gw:
        keep("crash_failover", gw.topk(k=8, epsilon=EPS_OK, delta=0.1), gw)
    hedge = api.FaultPlan(seed=3, replica_slow=((0, 0.2),),
                          replica_crashes=((0, 2),))
    with api.open(g, api.rc(hedge), replicas=2, cache=False,
                  hedge_after_s=0.05) as gw:
        keep("hedge_promoted", gw.topk(k=8, epsilon=EPS_OK, delta=0.1), gw)
    with api.open(api.graph(n=128, seed=8), api.rc(), replicas=1) as gw:
        h = gw.topk(k=8, epsilon=EPS_OK, delta=0.1)
        gw.apply_mutations(
            api.MutationBatch.edges(insert=[(3, 90), (60, 5)]))
        keep("epoch_pinned", h, gw)
        keep("epoch_fresh", gw.topk(k=8, epsilon=EPS_OK, delta=0.1), gw)
    return out


SCENARIOS = ("cold_miss", "dominated_hit", "join_parent", "join_identical",
             "join_weaker", "pagerank_live", "pagerank_cached",
             "crash_failover", "hedge_promoted", "epoch_pinned",
             "epoch_fresh")


@pytest.fixture(scope="module")
def both_gateways():
    return _scenarios(_API("ref")), _scenarios(_API("port"))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_answers_equal_the_reference_gateway(both_gateways, scenario):
    ref, port = (run[scenario] for run in both_gateways)
    (a, src_a, ctr_a), (b, src_b, ctr_b) = ref, port
    assert src_b == src_a
    assert ctr_b == ctr_a
    assert b.vertices.dtype == a.vertices.dtype
    assert b.vertices.tobytes() == a.vertices.tobytes()
    assert b.scores.dtype == a.scores.dtype
    assert b.scores.tobytes() == a.scores.tobytes()
    assert b.epsilon_bound == a.epsilon_bound
    assert (b.kind, b.num_walks, b.num_steps, b.waves, b.epoch,
            b.degraded) == (a.kind, a.num_walks, a.num_steps, a.waves,
                            a.epoch, a.degraded)


def test_reference_scenarios_take_their_paths(both_gateways):
    """The scenarios exercise what they are named for, in both packages:
    the hit and the identical join return the first answer's object, the
    failover and the promoted hedge are counted once."""
    for run in both_gateways:
        assert run["dominated_hit"][0] is run["cold_miss"][0]
        assert run["join_identical"][0] is run["join_parent"][0]
        assert run["pagerank_cached"][0] is run["pagerank_live"][0]
        assert [run[k][1] for k in ("cold_miss", "dominated_hit",
                                    "join_parent", "join_identical",
                                    "join_weaker")] == [
            "live", "cache", "live", "joined", "joined"]
        assert run["crash_failover"][2] == (1, 0, 0)
        assert run["hedge_promoted"][2] == (1, 1, 1)
        assert (run["epoch_pinned"][0].epoch,
                run["epoch_fresh"][0].epoch) == (0, 1)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_replicas_share_the_index_storage(cuda):
    """On the card (``device=None``), the replicas' ``ensure_index()`` is
    one object whose tensors are the pool's: equal ``data_ptr()``s, and
    the open allocates one index, not one a replica."""
    g = _graph().to(cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with Gateway.open(g, _rc(), replicas=3) as gw2:
        idx = gw2.pool.index
        grown = torch.cuda.memory_allocated() - before
        nbytes = (idx.endpoints.numel() * idx.endpoints.element_size()
                  + idx.visited_blocks.numel()
                  * idx.visited_blocks.element_size())
        assert idx.endpoints.device.type == "cuda"
        for r in gw2.pool.replicas:
            got = r.ensure_index()
            assert got is idx and r.graph is gw2.pool.graph
            assert got.endpoints.data_ptr() == idx.endpoints.data_ptr()
            assert (got.visited_blocks.data_ptr()
                    == idx.visited_blocks.data_ptr())
        assert grown < 1.5 * nbytes, (grown, nbytes)
        svc = FrogWildService.open(g, _rc(), index=idx)
        assert svc.ensure_index() is idx
        svc.close()
        gw2.pool.restart_replica(1)
        assert gw2.pool.replicas[1].ensure_index() is idx


def _mixed_run(device):
    """A 2-replica gateway's answers to a live top-k, its cached repeat, a
    PPR with an identical and a weaker join, a second live top-k and the
    cached batch estimate."""
    with Gateway.open(_graph(), _rc(), replicas=2, device=device) as gw2:
        hs = [gw2.topk(k=8, epsilon=EPS_OK, delta=0.1),
              gw2.ppr(7, k=6, epsilon=0.34, delta=0.1),
              gw2.ppr(7, k=6, epsilon=0.34, delta=0.1),
              gw2.ppr(7, k=6, epsilon=0.5, delta=0.1),
              gw2.topk(k=10, epsilon=0.5, delta=0.1)]
        out = [(h.result(), h.source, h.replica) for h in hs]
        h = gw2.topk(k=8, epsilon=EPS_OK, delta=0.1)
        out.append((h.result(), h.source, h.replica))
        out.append((gw2.pagerank(epsilon=0.5, delta=0.1, k=6), "live", None))
        return out


@pytest.mark.cuda
def test_cuda_gateway_answers_equal_the_cpu(cuda):
    for (a, sa, ra), (b, sb, rb) in zip(_mixed_run("cpu"), _mixed_run(None)):
        assert (sb, rb) == (sa, ra)
        assert b.vertices.tobytes() == a.vertices.tobytes()
        assert b.scores.tobytes() == a.scores.tobytes()
        assert (b.epsilon_bound, b.num_walks, b.waves) == (
            a.epsilon_bound, a.num_walks, a.waves)
