"""Slice B of the port (the indexed top-k / PPR query) against the
reference.

The walk-index slab, the walk lengths, one wave's ``[Q, n]`` counts,
``walk_wave`` / ``query_counts`` and the service's answers through
``QueryHandle`` are byte-equal to ``repro`` for the same graph, config and
key. Walk lengths are ``floor(log u / log(1 - p_T))`` in float32, and
torch's ``log`` differs from XLA's in the last bit for some inputs;
:func:`test_walk_lengths_equal_for_every_uniform` shows that no
length differs at ``p_T = 0.15`` over all 2**23 values ``uniform`` can
return, which is why the counts can be compared byte for byte.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import service as jservice
from repro.config import RuntimeConfig as JRuntimeConfig
from repro.config import ServingConfig as JServingConfig
from repro.config import ShardConfig as JShardConfig
from repro.config import WalkIndexConfig as JWalkIndexConfig
from repro.graph import generators as jgen
from repro.query import engine as jengine
from repro.query import index as jindex
from repro.query import scheduler as jsched
from repro_torch import (FrogWildService, RuntimeConfig, ServingConfig,
                         ShardConfig, convert)
from repro_torch import service as tservice
from repro_torch.config import WalkIndexConfig
from repro_torch.graph import generators as tgen
from repro_torch.query import engine as tengine
from repro_torch.query import index as tindex
from repro_torch.query import scheduler as tsched

P_T = 0.15


def _graphs(n=500, deg=6.0, seed=1):
    return (jgen.chung_lu_powerlaw(n, deg, seed=seed),
            tgen.chung_lu_powerlaw(n, deg, seed=seed))


def _tkey(key):
    return convert.key_from_jax(jax.random.key_data(key), device="cpu")


def _eq(want, got: torch.Tensor) -> None:
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


def _index_pair(gj, gt, R=8, L=3, shards=4, seed=0):
    ij = jindex._build_walk_index(
        gj, JWalkIndexConfig(segments_per_vertex=R, segment_len=L,
                             num_shards=shards, seed=seed))
    it = tindex._build_walk_index(
        gt, WalkIndexConfig(segments_per_vertex=R, segment_len=L,
                            num_shards=shards, seed=seed))
    return ij, it


@pytest.mark.parametrize("n,R,L,shards,seed", [
    (500, 8, 3, 4, 0), (97, 5, 1, 1, 3), (333, 4, 2, 3, 7)])
def test_build_walk_index_byte_equal(n, R, L, shards, seed):
    gj, gt = _graphs(n)
    ij, it = _index_pair(gj, gt, R, L, shards, seed)
    _eq(ij.endpoints, it.endpoints)
    _eq(ij.visited_blocks, it.visited_blocks)
    assert (it.n, it.segments_per_vertex, it.segment_len, it.seed) == (
        ij.n, ij.segments_per_vertex, ij.segment_len, ij.seed)
    # the facade's dispatcher builds the same slab
    via = tservice.build_index(
        gt, RuntimeConfig(runtime=ShardConfig(seed=seed),
                          serving=ServingConfig(segments_per_vertex=R,
                                                segment_len=L,
                                                build_shards=shards)),
        device="cpu")
    assert torch.equal(via.endpoints, it.endpoints)


def test_walk_lengths_equal_for_every_uniform():
    """Every float32 ``uniform`` can return, through the reference's
    expression (eager, and jitted, where XLA turns the division into a
    multiply by the reciprocal) and the port's."""
    c = math.log(1.0 - P_T)

    def ref(x):
        return jnp.floor(jnp.log(jnp.maximum(x, 1e-12)) / c).astype(
            jnp.int32)

    ref_jit = jax.jit(ref)
    chunk = 1 << 20
    for lo in range(0, 1 << 23, chunk):
        k = np.arange(lo, lo + chunk, dtype=np.uint32)
        u = (k | 0x3F800000).view(np.float32) - np.float32(1.0)
        got = tengine.lengths_from_uniform(torch.from_numpy(u), P_T,
                                           1 << 30).numpy()
        for want in (np.asarray(ref(jnp.asarray(u))),
                     np.asarray(ref_jit(jnp.asarray(u)))):
            bad = np.flatnonzero(np.maximum(want, 0) != got)
            assert bad.size == 0, (bad.size, u[bad[:4]], want[bad[:4]],
                                   got[bad[:4]])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_sample_walk_lengths_byte_equal(seed):
    key = jax.random.PRNGKey(seed)
    caps = np.random.default_rng(seed).integers(0, 40, 777).astype(np.int32)
    for W, cap in ((1, 32), (777, 32), (777, 7), (777, caps)):
        want = jengine.sample_walk_lengths(key, W, P_T, cap)
        tcap = torch.from_numpy(cap) if isinstance(cap, np.ndarray) else cap
        _eq(want, tengine.sample_walk_lengths(_tkey(key), W, P_T, tcap))


def _wave_operands(n, W, Q, seed, uniform_rows):
    rng = np.random.default_rng(seed)
    live = W - W // 5                        # the tail idles in row Q
    qid = np.full(W, Q, np.int32)
    qid[:live] = np.arange(live) * Q // live
    uniform = np.isin(qid, uniform_rows)
    start = np.where(uniform, 0, rng.integers(0, n, W)).astype(np.int32)
    t_cap = rng.integers(0, 20, W).astype(np.int32)
    return start, uniform, qid, t_cap


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("W,Q,seed", [(256, 3, 0), (1000, 4, 1)])
def test_wave_program_counts_byte_equal(impl, W, Q, seed):
    gj, gt = _graphs()
    ij, it = _index_pair(gj, gt)
    n, R, L = gt.n, it.segments_per_vertex, it.segment_len
    q_max = 16 // L
    ops_ = _wave_operands(n, W, Q, seed, uniform_rows=[0, 2])
    key = jax.random.PRNGKey(10 + seed)
    jspec = jengine.WaveSpec(n=n, R=R, L=L, q_max=q_max, S=1, sz=n, W=W,
                             Q=Q, p_T=P_T, impl="xla", tally_impl="ref",
                             donate=False)
    want = jengine.build_wave_program(jspec)(
        jnp.asarray(ij.endpoints).reshape(-1), gj.row_ptr, gj.col_idx,
        gj.out_deg, *map(jnp.asarray, ops_), jax.random.key_data(key),
        jnp.zeros(1, bool))
    tspec = tengine.WaveSpec(n=n, R=R, L=L, q_max=q_max, W=W, Q=Q, p_T=P_T,
                             impl=impl, tally_impl=impl)
    got = tengine.build_wave_program(tspec)(
        it.endpoints, gt.row_ptr, gt.col_idx, gt.out_deg,
        *map(torch.from_numpy, ops_), _tkey(key))
    assert got.shape == (Q, n)
    _eq(want, got)
    assert int(got.sum()) == int((ops_[2] < Q).sum())


def test_wave_program_matches_pallas_stitch():
    """The reference's Pallas stitch and tally kernels (interpret mode)
    give the same wave as the port."""
    gj, gt = _graphs(200, 5.0, seed=2)
    ij, it = _index_pair(gj, gt, R=4, L=2, shards=2)
    n, W, Q = gt.n, 128, 2
    ops_ = _wave_operands(n, W, Q, 5, uniform_rows=[1])
    key = jax.random.PRNGKey(3)
    jspec = jengine.WaveSpec(n=n, R=4, L=2, q_max=4, S=1, sz=n, W=W, Q=Q,
                             p_T=P_T, impl="pallas", tally_impl="pallas",
                             donate=False)
    want = jengine.build_wave_program(jspec)(
        jnp.asarray(ij.endpoints).reshape(-1), gj.row_ptr, gj.col_idx,
        gj.out_deg, *map(jnp.asarray, ops_), jax.random.key_data(key),
        jnp.zeros(1, bool))
    got = tengine.build_wave_program(tengine.WaveSpec(
        n=n, R=4, L=2, q_max=4, W=W, Q=Q, p_T=P_T, impl="auto",
        tally_impl="auto"))(it.endpoints, gt.row_ptr, gt.col_idx,
                            gt.out_deg, *map(torch.from_numpy, ops_),
                            _tkey(key))
    _eq(want, got)


@pytest.mark.parametrize("impl", ["xla", "ref"])
def test_walk_wave_and_query_counts_byte_equal(impl):
    gj, gt = _graphs()
    ij, it = _index_pair(gj, gt)
    rng = np.random.default_rng(4)
    W, rounds = 600, 5
    pos0 = rng.integers(0, gt.n, W).astype(np.int32)
    tau = rng.integers(0, rounds * 3 + 3, W).astype(np.int32)
    key = jax.random.PRNGKey(21)
    want_pos, want_counts = jengine.walk_wave(
        gj.row_ptr, gj.col_idx, gj.out_deg, ij.endpoints, jnp.asarray(pos0),
        jnp.asarray(tau), key, 3, rounds, impl=impl)
    got_pos, got_counts = tengine.walk_wave(
        gt.row_ptr, gt.col_idx, gt.out_deg, it.endpoints,
        torch.from_numpy(pos0), torch.from_numpy(tau), _tkey(key), 3,
        rounds)
    _eq(want_pos, got_pos)
    _eq(want_counts, got_counts)
    plan = jengine.plan_query(10, 0.4, 0.1, max_steps=16,
                              segments_per_vertex=8, segment_len=3)
    tplan = tengine.QueryPlan(**dataclasses.asdict(plan))
    for source in (None, 0, 123):
        k = jax.random.fold_in(key, 0 if source is None else source)
        _eq(jengine.query_counts(gj, ij, plan, k, source=source, impl=impl),
            tengine.query_counts(gt, it, tplan, _tkey(k), source=source))
    with pytest.raises(ValueError, match="outside"):
        tengine.query_counts(gt, it, tplan, _tkey(key), source=gt.n)


SERVING = dict(segments_per_vertex=8, segment_len=3, build_shards=4,
               max_walks=512, max_queries=3, max_steps=16)


def _services(seed=3, **serving):
    gj, gt = _graphs()
    sc = {**SERVING, **serving}
    sj = jservice.FrogWildService.open(gj, JRuntimeConfig(
        runtime=JShardConfig(seed=seed), serving=JServingConfig(**sc)))
    st = FrogWildService.open(gt, RuntimeConfig(
        runtime=ShardConfig(seed=seed), serving=ServingConfig(**sc)),
        device="cpu")
    return sj, st


def _same_result(a, b):
    assert (a.rid, a.kind, a.num_walks, a.num_steps, a.waves,
            a.epsilon_bound, a.downgraded, a.early_stopped, a.degraded,
            a.walks_lost, a.epoch) == (
        b.rid, b.kind, b.num_walks, b.num_steps, b.waves, b.epsilon_bound,
        b.downgraded, b.early_stopped, b.degraded, b.walks_lost, b.epoch)
    assert a.vertices.tobytes() == b.vertices.tobytes()
    assert a.scores.dtype == b.scores.dtype
    assert a.scores.tobytes() == b.scores.tobytes()


def test_service_end_to_end_byte_equal():
    """``pagerank``, then 3 ``topk`` and 2 ``ppr`` through
    ``QueryHandle.result()``: the same answers, walks, waves and bounds."""
    sj, st = _services()
    _eq(sj.pagerank(epsilon=0.3, k=10).counts,
        st.pagerank(epsilon=0.3, k=10).counts)
    _eq(sj.ensure_index().endpoints, st.ensure_index().endpoints)
    handles = []
    for svc in (sj, st):
        hs = [svc.topk(k=10, epsilon=0.3), svc.topk(k=5, epsilon=0.25),
              svc.ppr(7, k=5), svc.topk(k=10, epsilon=0.4,
                                        num_walks=3000),
              svc.ppr(11, k=8, epsilon=0.35, early_stop=False)]
        handles.append(hs)
    assert all(h.status() == "queued" for hs in handles for h in hs)
    for hj, ht in zip(*handles):
        _same_result(hj.result(), ht.result())
        assert ht.done() and ht.status() == "finished"
    a, b = sj.serving_stats(), st.serving_stats()
    assert (a.waves_run, a.walks_executed, a.finished, a.backlog_walks,
            a.wave_occupancy) == (b.waves_run, b.walks_executed, b.finished,
                                  b.backlog_walks, b.wave_occupancy)
    assert [r.rid for r in sj.drain()] == [r.rid for r in st.drain()]
    st.close()
    assert st.closed and ht.status() == "cancelled"
    with pytest.raises(RuntimeError, match="closed"):
        st.topk()


def test_admission_downgrade_partial_and_cancel_match():
    """SLO admission (infeasible, capacity, downgrade), anytime partials
    and cancellation decide as the reference does."""
    sj, st = _services(seed=5, wave_time_estimate_s=0.01,
                       walk_buckets=(128, 256), query_buckets=(1, 2))
    out = []
    for svc in (sj, st):
        hs = [svc.topk(k=10, slo_s=0.005),                  # < one wave
              svc.topk(k=10, slo_s=0.05),                   # capacity
              svc.topk(k=10, slo_s=0.05, allow_downgrade=True),
              svc.ppr(3, k=5, slo_s=5.0),
              svc.topk(k=5, epsilon=0.5),
              svc.ppr(9, k=4)]
        out.append(hs)
    for hj, ht in zip(*out):
        dj, dt = hj.decision, ht.decision
        assert (dt.admitted, dt.reason_code.value, dt.downgraded,
                dt.num_walks) == (dj.admitted, dj.reason_code.value,
                                  dj.downgraded, dj.num_walks)
        if dj.plan is not None:
            assert dataclasses.astuple(dt.plan) == dataclasses.astuple(
                dj.plan)
        assert ht.status() == hj.status()
    hj, ht = out[0][4], out[1][4]
    for _ in range(2):
        assert hj.poll() == ht.poll()
    pj, pt = hj.partial(), ht.partial()
    assert (pt.walks_done, pt.waves, pt.epsilon_bound, pt.done) == (
        pj.walks_done, pj.waves, pj.epsilon_bound, pj.done)
    assert pt.vertices.tobytes() == pj.vertices.tobytes()
    assert pt.scores.tobytes() == pj.scores.tobytes()
    assert out[0][5].cancel() and out[1][5].cancel()
    assert out[1][5].status() == "cancelled"
    with pytest.raises(RuntimeError, match="cancelled"):
        out[1][5].result()
    with pytest.raises(RuntimeError, match="rejected"):
        out[1][0].result()
    for hj, ht in zip(out[0][2:5], out[1][2:5]):
        _same_result(hj.result(), ht.result())


def test_scheduler_helpers_match():
    for cap, floor, buckets in ((8192, 1024, None), (512, 64, None),
                                (8, 1, None), (512, 64, (64, 100)),
                                (8, 1, (2, 8))):
        want = jsched.QueryScheduler._normalize_buckets(buckets, cap, "b",
                                                        floor)
        got = tsched.QueryScheduler._normalize_buckets(buckets, cap, "b",
                                                       floor)
        assert got == want
        for demand in (1, cap // 3, cap):
            assert (tsched.QueryScheduler._bucket(got, demand)
                    == jsched.QueryScheduler._bucket(want, demand))
    with pytest.raises(ValueError):
        tsched.QueryScheduler._normalize_buckets((0, 4), 8, "b", 1)
    rng = np.random.default_rng(0)
    for n, nnz, k in ((1000, 30, 10), (1000, 900, 10), (50, 50, 60),
                      (1000, 3, 10)):
        s = np.zeros(n, np.int64)
        s[rng.choice(n, nnz, replace=False)] = rng.integers(1, 5, nnz)
        assert (tsched._topk_stable(s, k) == jsched._topk_stable(s, k)).all()
