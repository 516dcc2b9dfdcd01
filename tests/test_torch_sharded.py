"""Sharded serving on one device against the reference.

The walk index split into ``S`` range blocks (``shard_walk_index``,
``reassemble``), one wave's ``[Q, n]`` counts under the fused and the loop
dispatch with an all-False and a set ``lost`` mask, the per-shard stitch
kernels (``stitch_step_local`` with and without its tally, and their sum
over the shards), and the ``num_shards=4`` service's answers are byte-equal
to ``repro``'s for the same graph, config and key. The reference runs on
its one CPU device, where it serves a sharded index through the same two
host dispatches.
"""
import dataclasses

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
from repro.kernels import ops as jops
from repro.query import index as jindex
from repro.query import scheduler as jsched
from repro_torch import (FrogWildService, RuntimeConfig, ServingConfig,
                         ShardConfig, ShardRuntime, convert)
from repro_torch import config as tconfig
from repro_torch.config import WalkIndexConfig
from repro_torch.distributed.faults import FaultPlan
from repro_torch.graph import generators as tgen
from repro_torch.kernels import ops
from repro_torch.query import index as tindex
from repro_torch.query import scheduler as tsched

P_T = 0.15


def _graphs(n=250, deg=8.0, seed=2):
    return (jgen.chung_lu_powerlaw(n, deg, seed=seed),
            tgen.chung_lu_powerlaw(n, deg, seed=seed))


def _tkey(key):
    return convert.key_from_jax(jax.random.key_data(key), device="cpu")


def _eq(want, got: torch.Tensor) -> None:
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


def _indexes(gj, gt, S, R=6, L=2):
    """Dense and S-sharded indexes of both packages (n = 250 with S = 4
    gives shard_size 63 and two zero padding rows)."""
    ij = jindex._build_walk_index(gj, JWalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=2))
    it = tindex._build_walk_index(gt, WalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=2))
    return ij, it, jindex.shard_walk_index(ij, S), tindex.shard_walk_index(
        it, S)


@pytest.mark.parametrize("n,S", [(250, 4), (250, 2), (97, 4), (64, 2)])
def test_shard_walk_index_and_reassemble_byte_equal(n, S):
    gj, gt = _graphs(n)
    ij, it, sj, st = _indexes(gj, gt, S)
    _eq(sj.blocks, st.blocks)
    assert (st.num_shards, st.shard_size, st.segments_per_vertex, st.n) == (
        sj.num_shards, sj.shard_size, sj.segments_per_vertex, sj.n)
    assert int(st.blocks.reshape(-1, st.segments_per_vertex)[n:].abs()
               .sum()) == 0                     # padding rows are zero
    _eq(sj.reassemble().endpoints, st.reassemble().endpoints)
    _eq(ij.endpoints, st.reassemble().endpoints)
    # the reference's blocks carried across through numpy
    via = convert.sharded_walk_index_from_numpy(
        np.asarray(sj.blocks), sj.n, sj.segment_len, sj.seed, device="cpu")
    assert torch.equal(via.blocks, st.blocks)
    assert (via.n, via.segment_len, via.seed) == (st.n, st.segment_len,
                                                  st.seed)


def _wave_operands(n, W, Q, seed):
    rng = np.random.default_rng(seed)
    live = W - W // 5                        # the tail idles in row Q
    qid = np.full(W, Q, np.int32)
    qid[:live] = np.arange(live) * Q // live
    uniform = np.isin(qid, [0, 2])
    start = np.where(uniform, 0, rng.integers(0, n, W)).astype(np.int32)
    t_cap = rng.integers(0, 20, W).astype(np.int32)
    return start, uniform, qid, t_cap


def _lost(S, which):
    lost = np.zeros(S, bool)
    lost[list(which)] = True
    return lost


@pytest.mark.parametrize("dispatch", ["fused", "loop"])
@pytest.mark.parametrize("S,lost_shards,seed", [
    (4, (), 0), (4, (1,), 1), (2, (), 2), (2, (0,), 3), (4, (0, 3), 4)])
def test_sharded_wave_counts_byte_equal(dispatch, S, lost_shards, seed):
    """One wave's counts through ``_wave_for`` of both packages' schedulers
    (twins of ``test_wave_programs.py::test_fused_matches_legacy_loop_
    exactly`` and ``test_serving_sharded.py::test_sharded_loop_wave_matches_
    gathered_exactly`` at the wave level), and against the port's other
    dispatch."""
    gj, gt = _graphs()
    _, _, sj, st = _indexes(gj, gt, S)
    W, Q = 320, 3
    operands = _wave_operands(gt.n, W, Q, seed)
    lost = _lost(S, lost_shards)
    key = jax.random.PRNGKey(40 + seed)
    kw = dict(max_walks=W, max_queries=Q, max_steps=12, seed=seed)
    jsch = jsched.QueryScheduler(gj, sj, impl="ref",
                                 sharded_dispatch=dispatch, **kw)
    want = jsch._wave_for(W, Q)(*map(jnp.asarray, operands), key,
                                jnp.asarray(lost))
    got = {}
    for d in ("fused", "loop"):
        tsch = tsched.QueryScheduler(gt, st, sharded_dispatch=d, **kw)
        assert tsch.dispatch == d and not tsch.runtime.is_mesh
        got[d] = tsch._wave_for(W, Q)(*map(torch.from_numpy, operands),
                                      _tkey(key), torch.from_numpy(lost))
    _eq(want, got[dispatch])
    assert got["fused"].tobytes() == got["loop"].tobytes()
    live = int((operands[2] < Q).sum())
    assert int(got[dispatch].sum()) <= live
    if not lost_shards:
        assert int(got[dispatch].sum()) == live


def test_sharded_wave_matches_pallas_local_stitch():
    """The reference's interpret-mode Pallas ``stitch_gather_local`` in its
    loop wave gives the port's loop wave."""
    gj, gt = _graphs(130, 6.0, seed=3)
    _, _, sj, st = _indexes(gj, gt, 2, R=5)
    W, Q = 128, 2
    operands = _wave_operands(gt.n, W, Q, 9)
    lost = np.zeros(2, bool)
    key = jax.random.PRNGKey(5)
    kw = dict(max_walks=W, max_queries=Q, max_steps=10, seed=1,
              sharded_dispatch="loop")
    want = jsched.QueryScheduler(gj, sj, impl="pallas", **kw)._wave_for(
        W, Q)(*map(jnp.asarray, operands), key, jnp.asarray(lost))
    got = tsched.QueryScheduler(gt, st, **kw)._wave_for(W, Q)(
        *map(torch.from_numpy, operands), _tkey(key), torch.from_numpy(lost))
    _eq(want, got)


@pytest.mark.parametrize("W,n,R,S", [(1000, 300, 8, 4), (128, 64, 3, 2),
                                     (777, 201, 5, 4)])
def test_stitch_step_local_matches_reference_and_composes(W, n, R, S):
    """Twin of ``test_serving_sharded.py::test_stitch_local_kernel_matches_
    ref_and_composes``, with bits = INT32_MIN and walks no shard owns."""
    rng = np.random.default_rng(W + n)
    pos = rng.integers(0, n, W).astype(np.int32)
    pos[:3] = (-5, S * -(-n // S) + 3, n - 1)      # owned by no shard; last
    stop = rng.integers(0, 2, W).astype(np.int32)
    bits = rng.integers(-(1 << 31), 1 << 31, W, dtype=np.int64)
    bits = bits.astype(np.int32)
    bits[3] = np.iinfo(np.int32).min
    endpoints = rng.integers(0, n, (n, R)).astype(np.int32)
    sz = -(-n // S)
    ep = np.zeros((S * sz, R), np.int32)
    ep[:n] = endpoints
    tpos, tstop, tbits = map(torch.from_numpy, (pos, stop, bits))
    acc_n = torch.zeros(W, dtype=torch.int32)
    acc_c = []
    for s in range(S):
        block = ep[s * sz:(s + 1) * sz]
        tblock = torch.from_numpy(block)
        got_n, got_c = ops.stitch_step_local(tpos, tstop, tbits, tblock,
                                             s * sz)
        got_g, none = ops.stitch_step_local(tpos, tstop, tbits, tblock,
                                            s * sz, tally=False)
        assert none is None and torch.equal(got_g, got_n)
        assert torch.equal(got_g, ops.stitch_gather_local(tpos, tbits,
                                                          tblock, s * sz))
        args = [jnp.asarray(a) for a in (pos, stop, bits, block)]
        for impl in ("pallas", "ref"):
            want_n, want_c = jops.stitch_step_local(*args, s * sz, impl=impl)
            want_g, _ = jops.stitch_step_local(*args, s * sz, impl=impl,
                                               tally=False)
            _eq(want_n, got_n)
            _eq(want_c, got_c)
            _eq(want_g, got_g)
        acc_n += got_n
        acc_c.append(got_c)
    # per-shard outputs sum to the global stitch round (one owner per walk)
    valid = (pos >= 0) & (pos < n)
    ng, cg = ops.stitch_step(*map(torch.from_numpy, (
        np.where(valid, pos, 0).astype(np.int32), stop * valid, bits,
        endpoints)), n)
    assert torch.equal(acc_n[torch.from_numpy(valid)],
                       ng[torch.from_numpy(valid)])
    assert int(acc_n[~torch.from_numpy(valid)].abs().sum()) == 0
    assert torch.equal(torch.cat(acc_c)[:n], cg)


def test_stitch_local_wrappers_refuse_bad_operands():
    pos = torch.zeros(8, dtype=torch.int32)
    block = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.stitch_gather_local(pos, pos, block, 0, impl="cuda")
    with pytest.raises(ValueError, match="base"):
        ops.stitch_step_local(pos, pos, pos, block, -1)
    with pytest.raises(ValueError, match="block must be 2-D"):
        ops.stitch_gather_local(pos, pos, block.reshape(-1), 0)
    before = ops.launch_counts()
    ops.stitch_step_local(pos, pos, pos, block, 0)   # CPU: plain version
    assert ops.launch_counts() == before


SERVING = dict(segments_per_vertex=8, segment_len=3, build_shards=4,
               max_walks=512, max_queries=3, max_steps=16)


def _same_result(a, b):
    assert (a.rid, a.kind, a.num_walks, a.num_steps, a.waves,
            a.epsilon_bound, a.downgraded, a.early_stopped, a.degraded,
            a.walks_lost, a.epoch) == (
        b.rid, b.kind, b.num_walks, b.num_steps, b.waves, b.epsilon_bound,
        b.downgraded, b.early_stopped, b.degraded, b.walks_lost, b.epoch)
    assert a.vertices.tobytes() == b.vertices.tobytes()
    assert a.scores.dtype == b.scores.dtype
    assert a.scores.tobytes() == b.scores.tobytes()


def _submit(svc):
    return [svc.topk(k=10, epsilon=0.3), svc.ppr(7, k=5),
            svc.topk(k=5, epsilon=0.25, num_walks=900),
            svc.ppr(11, k=8, epsilon=0.35, early_stop=False)]


@pytest.mark.parametrize("dispatch", ["fused", "loop"])
def test_service_num_shards_4_byte_equal(dispatch):
    """The ``num_shards=4`` service's handle results and stats equal the
    reference's (and the port's dense service's), under both dispatches."""
    gj, gt = _graphs(500, 6.0, seed=1)
    sc = dict(SERVING, sharded_dispatch=dispatch)
    sj = jservice.FrogWildService.open(gj, JRuntimeConfig(
        runtime=JShardConfig(num_shards=4, seed=3),
        serving=JServingConfig(**sc)))
    st = FrogWildService.open(gt, RuntimeConfig(
        runtime=ShardConfig(num_shards=4, seed=3),
        serving=ServingConfig(**sc)), device="cpu")
    dense = FrogWildService.open(gt, RuntimeConfig(
        runtime=ShardConfig(seed=3), serving=ServingConfig(**SERVING)),
        device="cpu")
    _eq(sj.pagerank(epsilon=0.3, k=10).counts,
        st.pagerank(epsilon=0.3, k=10).counts)
    ij, it = sj.ensure_index(), st.ensure_index()
    assert isinstance(it, tindex.ShardedWalkIndex) and it.num_shards == 4
    _eq(ij.blocks, it.blocks)
    handles = [_submit(svc) for svc in (sj, st, dense)]
    for hj, ht, hd in zip(*handles):
        rt = ht.result()
        _same_result(hj.result(), rt)
        _same_result(hd.result(), rt)
    sched = st.scheduler
    assert sched.dispatch == dispatch and sched.runtime is st.runtime
    a, b = sj.serving_stats(), st.serving_stats()
    assert (a.waves_run, a.walks_executed, a.finished, a.backlog_walks,
            a.wave_occupancy, a.lost_shards) == (
        b.waves_run, b.walks_executed, b.finished, b.backlog_walks,
        b.wave_occupancy, b.lost_shards)


def test_service_resplits_a_sharded_index():
    """A dense or differently sharded index handed to a sharded service is
    served at the configured shard count, with the same answers."""
    gj, gt = _graphs(300, 6.0, seed=4)
    base = tservice_index(gt)
    out = []
    for given in (base, tindex.shard_walk_index(base, 3)):
        svc = FrogWildService.open(gt, RuntimeConfig(
            runtime=ShardConfig(num_shards=2, seed=1),
            serving=ServingConfig(**SERVING)), device="cpu", index=given)
        idx = svc.ensure_index()
        assert idx.num_shards == 2 and idx.shard_size == 150
        assert torch.equal(idx.reassemble().endpoints, base.endpoints)
        out.append([h.result() for h in _submit(svc)])
    for a, b in zip(*out):
        _same_result(a, b)


def tservice_index(gt):
    return tindex._build_walk_index(gt, WalkIndexConfig(
        segments_per_vertex=SERVING["segments_per_vertex"],
        segment_len=SERVING["segment_len"],
        num_shards=SERVING["build_shards"]))


def test_sharded_config_runtime_and_unported_features():
    assert tconfig.ShardConfig(num_shards=4).num_shards == 4
    assert tconfig.ServingConfig(sharded_dispatch="loop").sharded_dispatch \
        == "loop"
    with pytest.raises(ValueError, match="sharded_dispatch"):
        tconfig.ServingConfig(sharded_dispatch="mesh")
    # the channel erasure is ported: its shards are the runtime's
    rc = tconfig.RuntimeConfig(runtime=tconfig.ShardConfig(num_shards=4),
                               erasure="channel", p_s=0.7)
    assert (rc.frogwild().erasure, rc.frogwild().num_shards) == ("channel",
                                                                4)
    # fault injection is ported: a FaultPlan is accepted, anything else not
    plan = FaultPlan(shard_losses=((1, 2),))
    assert tconfig.RuntimeConfig(runtime=tconfig.ShardConfig(num_shards=4),
                                 faults=plan).faults is plan
    with pytest.raises(TypeError, match="FaultPlan"):
        tconfig.RuntimeConfig(runtime=tconfig.ShardConfig(num_shards=4),
                              faults=object())
    with pytest.raises(TypeError, match="axis_name"):
        tconfig.ShardConfig(num_shards=4, axis_name="vertex")
    rt = ShardRuntime.acquire(4)
    assert (rt.num_shards, rt.is_mesh) == (4, False)
    assert rt.map_shards(lambda s, x: s * x, 10) == [0, 10, 20, 30]
    with pytest.raises(ValueError, match="num_shards"):
        ShardRuntime.acquire(0)
    gt = tgen.chung_lu_powerlaw(100, 5.0, seed=0)
    idx = tindex.shard_walk_index(tservice_index(gt), 4)
    with pytest.raises(ValueError, match="runtime has 2 shards"):
        tsched.QueryScheduler(gt, idx, runtime=ShardRuntime.acquire(2))
    with pytest.raises(ValueError, match="sharded_dispatch"):
        tsched.QueryScheduler(gt, idx, sharded_dispatch="mesh")
    assert dataclasses.replace(tsched.QueryScheduler(gt, idx)._spec(64, 2),
                               W=1).S == 4
