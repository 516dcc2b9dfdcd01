"""Fault tolerance of the port against the reference: twins of the
one-device tests of ``tests/test_faults.py``.

Each test sends the same :class:`FaultPlan` (built from the same fields in
each package) through the reference's and the port's scheduler or service
on the same graph and index, and asks for the same bytes: counts,
answers, the fault log's kinds, waves, attempts and shards in order,
``shards_lost`` and ``walks_lost``; degraded bounds equal to 1e-12
relative. The checkpoint protocol's twins run on the port, with the
reference reading what the port wrote. Sizes are tiny (n = 256, R = 4,
L = 2, 4 shards). The mesh failover test waits for the mesh (``ROADMAP.md``
Queue 1 item 8).
"""
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from repro.config import RuntimeConfig as JRuntimeConfig
from repro.config import ServingConfig as JServingConfig
from repro.config import ShardConfig as JShardConfig
from repro.config import WalkIndexConfig as JWalkIndexConfig
from repro.distributed import faults as jfaults
from repro.graph import generators as jgen
from repro.query import index as jindex
from repro.query import scheduler as jsched
from repro.service import FrogWildService as JService
from repro_torch import FrogWildService, RuntimeConfig, ServingConfig
from repro_torch import ShardConfig
from repro_torch.checkpoint import (CheckpointCorruptError, Checkpointer,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.config import WalkIndexConfig
from repro_torch.core import theory
from repro_torch.distributed import faults as tfaults
from repro_torch.graph import generators as tgen
from repro_torch.query import index as tindex
from repro_torch.query import scheduler as tsched

S = 4          # serving shards
R, L = 4, 2    # walk-index geometry
PKGS = ("ref", "port")


@pytest.fixture(scope="module")
def setup():
    """The graph and an S-way-partitioned index in each package (build
    partitioning == serving shards, as the reference's tests have it)."""
    n, seed = 256, 2
    gj = jgen.chung_lu_powerlaw(n, 6.0, seed=seed)
    gt = tgen.chung_lu_powerlaw(n, 6.0, seed=seed)
    ij = jindex._build_walk_index(gj, JWalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=S, seed=seed))
    it = tindex._build_walk_index(gt, WalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=S, seed=seed))
    return {"ref": (gj, jindex.shard_walk_index(ij, S)),
            "port": (gt, tindex.shard_walk_index(it, S))}


def _mods(pkg):
    return (jsched, jfaults) if pkg == "ref" else (tsched, tfaults)


def _sched(setup, pkg, plan=None, **kw):
    """One package's scheduler under ``FaultPlan(**plan)``."""
    sched_mod, faults_mod = _mods(pkg)
    g, sh = setup[pkg]
    inj = (faults_mod.FaultInjector(faults_mod.FaultPlan(**plan))
           if plan is not None else None)
    kw.setdefault("max_walks", 512)
    kw.setdefault("max_queries", 4)
    kw.setdefault("max_steps", 12)
    return sched_mod.QueryScheduler(g, sh, seed=7, fault_injector=inj, **kw)


def _reqs(pkg):
    Req = _mods(pkg)[0].QueryRequest
    return [Req(rid=0, kind="topk", k=8, num_walks=900),
            Req(rid=1, kind="ppr", source=5, k=8, num_walks=900)]


def _drain(sched, reqs):
    for r in reqs:
        assert sched._submit(r).admitted
    return sorted(sched._drain(), key=lambda r: r.rid)


def _both(setup, plan=None, **kw):
    """``{pkg: (scheduler, sorted results)}`` for both packages."""
    out = {}
    for pkg in PKGS:
        sched = _sched(setup, pkg, plan, **kw)
        out[pkg] = (sched, _drain(sched, _reqs(pkg)))
    return out


def _same(a, b):
    """Two results (or partials) agree: bytes, provenance, bound."""
    assert a.vertices.tobytes() == b.vertices.tobytes()
    assert a.scores.dtype == b.scores.dtype
    assert a.scores.tobytes() == b.scores.tobytes()
    assert (a.degraded, tuple(a.shards_lost), a.walks_lost) == (
        b.degraded, tuple(b.shards_lost), b.walks_lost)
    assert math.isclose(a.epsilon_bound, b.epsilon_bound, rel_tol=1e-12) \
        or a.epsilon_bound == b.epsilon_bound


def _log(events):
    return [(e.kind, e.wave, e.attempt, e.shard) for e in events]


def _same_runs(out):
    (js, jr), (ts, tr) = out["ref"], out["port"]
    for a, b in zip(jr, tr):
        _same(a, b)
        assert (a.num_walks, a.num_steps, a.waves) == (b.num_walks,
                                                       b.num_steps, b.waves)
    assert _log(js.fault_log) == _log(ts.fault_log)
    assert js.lost_shards == ts.lost_shards
    return ts, tr


# --- zero faults: byte identity ---------------------------------------------


def test_zero_faults_byte_identical_with_supervision_armed(setup):
    plain = _both(setup)
    armed = _both(setup, plan={}, wave_timeout_s=60.0)
    _, base = _same_runs(plain)
    _, out = _same_runs(armed)
    for a, b in zip(base, out):
        _same(a, b)
        assert not b.degraded and b.walks_lost == 0 and b.shards_lost == ()


# --- shard loss: degraded waves, renormalization, widened bound --------------


def test_shard_loss_degrades_with_theorem1_widened_bound(setup):
    out = _both(setup, plan=dict(shard_losses=((1, 2),)))
    sched, results = _same_runs(out)
    assert sched.lost_shards == {2}
    sh = setup["port"][1]
    lo, hi = sh.shard_size * 2, sh.shard_size * 3
    for r in results:
        assert r.degraded and r.shards_lost == (2,)
        assert r.walks_lost > 0
        assert r.num_walks + r.walks_lost == 900
        want = theory.epsilon_bound(sched.p_T, r.num_steps, 8, 0.1,
                                    r.num_walks, 1.0, 0.0)
        assert math.isclose(r.epsilon_bound, want, rel_tol=1e-12)
        counts = r.scores * r.num_walks
        assert np.allclose(counts, np.rint(counts))
        for v, sc in zip(r.vertices, r.scores):
            assert not (sc > 0 and lo <= int(v) < hi)
    base = _drain(_sched(setup, "port"), _reqs("port"))
    for rb, rd in zip(base, results):
        assert rb.num_walks == 900 and rd.num_walks == 900 - rd.walks_lost


@pytest.mark.parametrize("dispatch", ["fused", "loop"])
def test_partial_carries_degraded_provenance(setup, dispatch):
    parts = {}
    for pkg in PKGS:
        sched = _sched(setup, pkg, plan=dict(shard_losses=((0, 1),)),
                       sharded_dispatch=dispatch)
        req = _mods(pkg)[0].QueryRequest(rid=0, kind="topk", k=8,
                                         num_walks=2000)
        assert sched._submit(req).admitted
        sched.step_wave()
        p = sched.partial(0)
        assert p.degraded and p.shards_lost == (1,) and p.walks_lost > 0
        assert p.walks_done + p.walks_lost == 512
        sched._drain()
        done = sched.partial(0)
        assert done.done and done.degraded and done.shards_lost == (1,)
        parts[pkg] = (p, done)
    for a, b in zip(parts["ref"], parts["port"]):
        _same(a, b)
        assert (a.walks_done, a.waves, a.done) == (b.walks_done, b.waves,
                                                   b.done)


def test_evicting_everything_is_unservable(setup):
    for pkg in PKGS:
        _, faults_mod = _mods(pkg)
        sched = _sched(setup, pkg)
        for s in range(S - 1):
            sched._evict_shard(s, wave_no=0)
        with pytest.raises(faults_mod.WaveFailedError,
                           match="no shard left"):
            sched._evict_shard(S - 1, wave_no=0)
    # a dense slab has no shard granularity to degrade to
    g2 = tgen.chung_lu_powerlaw(64, 4.0, seed=3)
    dense = tindex._build_walk_index(g2, WalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=1, seed=3))
    with pytest.raises(tfaults.WaveFailedError, match="dense"):
        tsched.QueryScheduler(g2, dense, max_walks=64, max_steps=8,
                              seed=1)._evict_shard(0, wave_no=0)


# --- retry / backoff / timeout supervision -----------------------------------


def test_transient_faults_retried_byte_identically_then_bounded(setup):
    base = _both(setup)
    out = _both(setup, plan=dict(transient_faults=((0, 2),)), max_retries=2,
                backoff_base_s=0.001, backoff_max_s=0.002)
    _, want = _same_runs(base)
    sched, retried = _same_runs(out)
    for a, b in zip(want, retried):
        _same(a, b)
    assert [e.kind for e in sched.fault_log] == ["retry", "retry"]
    assert max(e.attempt for e in sched.fault_log) == 2
    # the backoff jitter draws the reference's seeded sequence
    assert [sched._backoff_s(a) for a in (1, 2, 3)] == [
        out["ref"][0]._backoff_s(a) for a in (1, 2, 3)]

    for pkg in PKGS:
        sched_mod, faults_mod = _mods(pkg)
        broke = _sched(setup, pkg, plan=dict(transient_faults=((0, 3),)),
                       max_retries=2, backoff_base_s=0.001,
                       backoff_max_s=0.002)
        assert broke._submit(sched_mod.QueryRequest(rid=0,
                                                    num_walks=100)).admitted
        with pytest.raises(faults_mod.WaveFailedError,
                           match="after 3 attempts"):
            broke.step_wave()
        a = next(iter(broke.active.values()))
        assert a.executed == 0 and a.remaining == 100 and a.counts.sum() == 0


def test_stall_detected_as_timeout_and_retried(setup):
    """A stall over ``wave_timeout_s``: the wave is discarded and retried
    from the same key, and the stall never reaches the admission EMA."""
    base = _both(setup)
    out = _both(setup, plan=dict(stalls=((1, 0.3),)), wave_timeout_s=0.25,
                wave_time_estimate_s=0.01, backoff_base_s=0.001,
                backoff_max_s=0.002)
    _, want = _same_runs(base)
    sched, got = _same_runs(out)
    for a, b in zip(want, got):
        _same(a, b)
    assert any(e.kind == "retry" for e in sched.fault_log)
    assert sched._wave_time < 0.1


def test_ema_skips_faulted_waves_and_clamps_outliers(setup):
    out = _both(setup, plan=dict(stalls=((1, 0.5),)),
                wave_time_estimate_s=0.02)
    sched, _ = _same_runs(out)
    assert sched._wave_time < 0.25
    assert _log(sched._injector.fired) == _log(out["ref"][0]._injector.fired)
    assert any(e.kind == "stall" for e in sched._injector.fired)


# --- capacity loss: admission + re-admission ---------------------------------


def test_eviction_shrinks_capacity_and_readmits_queued_slo_work(setup):
    seen = {}
    for pkg in PKGS:
        Req = _mods(pkg)[0].QueryRequest
        sched = _sched(setup, pkg, wave_time_estimate_s=1.0, max_queries=1)
        assert sched._effective_walks() == 512
        assert sched._submit(Req(rid=0, num_walks=512)).admitted
        sched._admit()
        ok = sched._submit(Req(rid=1, num_walks=1024, slo_s=4.0))
        dg = sched._submit(Req(rid=2, num_walks=1024, slo_s=4.0,
                               allow_downgrade=True))
        assert ok.admitted and dg.admitted
        for s in (0, 1, 3):
            sched._evict_shard(s, wave_no=0)
        assert sched._effective_walks() == 128
        assert sched.query_state(1) == "rejected"
        rej = next(d for d in sched.rejected if d.rid == 1)
        assert "shard" in rej.reason
        q2 = next(e for e in sched.queue if e.req.rid == 2)
        assert q2.downgraded and q2.walks < 1024
        assert any(e.kind == "readmit" for e in sched.fault_log)
        seen[pkg] = (rej.reason_code.value, q2.walks,
                     [(e.kind, e.detail) for e in sched.fault_log
                      if e.kind == "readmit"], _log(sched.fault_log))
    assert seen["ref"] == seen["port"]


def test_cancel_mid_degraded_leaves_scheduler_serviceable(setup):
    res = {}
    for pkg in PKGS:
        sched = _sched(setup, pkg, plan=dict(shard_losses=((0, 3),)))
        for r in _reqs(pkg):
            assert sched._submit(r).admitted
        sched.step_wave()
        assert sched.cancel(0)
        assert sched.query_state(0) == "cancelled"
        sched._drain()
        assert not sched.active and not sched.queue
        assert {r.rid for r in sched.finished} == {1}
        assert sched._submit(_mods(pkg)[0].QueryRequest(
            rid=9, num_walks=300)).admitted
        sched._drain()
        assert sched.query_state(9) == "finished"
        assert sched.result_for(9).degraded
        res[pkg] = [sched.result_for(1), sched.result_for(9)]
    for a, b in zip(res["ref"], res["port"]):
        _same(a, b)


# --- checkpoint integrity ----------------------------------------------------


def test_crash_during_write_never_exposes_torn_checkpoint(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"a": np.arange(12, dtype=np.int32).reshape(3, 4)}
    save_checkpoint(d, 0, tree)
    torn = os.path.join(d, "step_00000001.tmp")
    os.makedirs(torn)
    with open(os.path.join(torn, "arrays.npz"), "wb") as f:
        f.write(b"partial")
    assert latest_step(d) == 0
    out = restore_checkpoint(d, 0, {"a": 0}, device="cpu")
    assert out["a"].numpy().tobytes() == tree["a"].tobytes()
    assert out["a"].shape == (3, 4)


def test_corrupt_and_truncated_payloads_are_detected(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"a": np.arange(4096, dtype=np.int32)}
    save_checkpoint(d, 0, tree)
    payload = os.path.join(d, "step_00000000", "arrays.npz")
    like = {"a": 0}

    data = bytearray(open(payload, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(payload, "wb").write(bytes(data))
    with pytest.raises(CheckpointCorruptError, match="step_00000000"):
        restore_checkpoint(d, 0, like, device="cpu")

    # a payload that reads back but does not match its manifest names
    # the leaf
    save_checkpoint(d, 0, tree)
    meta_path = os.path.join(d, "step_00000000", "tree.json")
    meta = json.load(open(meta_path))
    meta["crc32"][0] ^= 1
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(CheckpointCorruptError,
                       match="step_00000000.*leaf 'a' failed its crc32"):
        restore_checkpoint(d, 0, like, device="cpu")

    save_checkpoint(d, 0, tree)
    size = os.path.getsize(payload)
    with open(payload, "r+b") as f:
        f.truncate(size // 2)
    with pytest.raises(CheckpointCorruptError, match="step_00000000"):
        restore_checkpoint(d, 0, like, device="cpu")


def test_async_checkpoint_write_failure_surfaces_at_wait(tmp_path):
    victim = tmp_path / "not_a_dir"
    victim.write_text("a file where the checkpointer wants a directory")
    ck = Checkpointer(str(victim))
    ck.save_async(0, {"a": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        ck.wait()
    ck.wait()                                       # error is consumed


def _write_shards(setup, d):
    """The reference's blocks, one checkpoint dir a shard, written by the
    reference."""
    g, sh = setup["ref"]
    for s in range(S):
        jindex.save_walk_index_shard(d, s, S, g.n, sh.blocks[s],
                                     sh.segment_len, sh.seed)


def test_corrupt_shards_quarantined_and_rebuilt_byte_identically(setup,
                                                                 tmp_path):
    want = np.asarray(setup["ref"][1].blocks)
    fixed = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        _write_shards(setup, d)
        faults_mod = _mods(pkg)[1]
        inj = faults_mod.FaultInjector(faults_mod.FaultPlan(
            corrupt_ckpt_shards=(1,), truncate_ckpt_shards=(3,)))
        assert len(inj.mangle_checkpoints(d)) == 2
        fixed[pkg] = d
    for name in ("arrays.npz", "tree.json"):   # the same bytes mangled
        for s in (1, 3):
            paths = [os.path.join(fixed[p], f"shard_{s:04d}", "step_00000000",
                                  name) for p in PKGS]
            assert open(paths[0], "rb").read() == open(paths[1], "rb").read()

    d = fixed["port"]
    with pytest.raises(CheckpointCorruptError) as ei:
        tindex.load_walk_index(d, reassemble=False, device="cpu")
    msg = str(ei.value)
    assert "shard_0001" in msg and f"R={R}" in msg and f"L={L}" in msg

    g = setup["port"][0]
    cfg = WalkIndexConfig(segments_per_vertex=R, segment_len=L, num_shards=S,
                          seed=2)
    got = tindex.load_or_repair_walk_index(d, g, cfg, reassemble=False)
    assert isinstance(got, tindex.ShardedWalkIndex)
    assert got.blocks.numpy().tobytes() == want.tobytes()
    ref = jindex.load_or_repair_walk_index(
        fixed["ref"], setup["ref"][0], JWalkIndexConfig(
            segments_per_vertex=R, segment_len=L, num_shards=S, seed=2),
        reassemble=False)
    assert np.asarray(ref.blocks).tobytes() == want.tobytes()
    for pkg in PKGS:
        assert sorted(x for x in os.listdir(fixed[pkg])
                      if x.startswith("quarantine")) == [
            "quarantine.shard_0001", "quarantine.shard_0003"]
    again = tindex.load_walk_index(d, reassemble=False, device="cpu")
    assert again.blocks.numpy().tobytes() == want.tobytes()
    # each package reads the shards the other repaired
    other = jindex.load_walk_index(d, reassemble=False)
    assert np.asarray(other.blocks).tobytes() == want.tobytes()
    back = tindex.load_walk_index(fixed["ref"], reassemble=False,
                                  device="cpu")
    assert back.blocks.numpy().tobytes() == want.tobytes()

    shutil.rmtree(os.path.join(d, "shard_0002"))
    fixed2 = tindex.load_or_repair_walk_index(d, g, cfg, reassemble=False)
    assert fixed2.blocks.numpy().tobytes() == want.tobytes()


# --- the service front door --------------------------------------------------


def _service_configs(tmp=None, plan=None):
    """The same configuration in each package."""
    kw = dict(serving=dict(segments_per_vertex=R, segment_len=L,
                           build_shards=S, max_walks=512, max_queries=4,
                           max_steps=12, checkpoint_dir=tmp))
    return {
        "ref": JRuntimeConfig(
            runtime=JShardConfig(num_shards=S, seed=3),
            serving=JServingConfig(**kw["serving"]),
            faults=None if plan is None else jfaults.FaultPlan(**plan)),
        "port": RuntimeConfig(
            runtime=ShardConfig(num_shards=S, seed=3),
            serving=ServingConfig(**kw["serving"]),
            faults=None if plan is None else tfaults.FaultPlan(**plan))}


def _open(setup, pkg, rc):
    g = setup[pkg][0]
    if pkg == "ref":
        return JService.open(g, rc)
    return FrogWildService.open(g, rc, device="cpu")


def test_service_serves_degraded_and_exposes_fault_provenance(setup):
    rcs = _service_configs(plan=dict(shard_losses=((1, 0),)))
    got = {}
    for pkg in PKGS:
        svc = _open(setup, pkg, rcs[pkg])
        r = svc.topk(k=8, num_walks=1200, early_stop=False).result()
        assert r.degraded and r.shards_lost == (0,)
        assert svc.lost_shards == frozenset({0})
        assert any(e.kind == "shard_loss" for e in svc.fault_log)
        got[pkg] = (r, _log(svc.fault_log))
    r = got["port"][0]
    want = theory.epsilon_bound(rcs["port"].p_T, r.num_steps, 8, 0.1,
                                r.num_walks, 1.0, 0.0)
    assert math.isclose(r.epsilon_bound, want, rel_tol=1e-12)
    _same(got["ref"][0], r)
    assert got["ref"][1] == got["port"][1]


def test_service_repairs_mangled_checkpoints_before_serving(setup, tmp_path):
    want = np.asarray(setup["ref"][1].blocks)
    answers = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        _write_shards(setup, d)
        rc = _service_configs(tmp=d, plan=dict(corrupt_ckpt_shards=(2,)))
        svc = _open(setup, pkg, rc[pkg])
        idx = svc.ensure_index()
        blocks = idx.blocks if pkg == "ref" else idx.blocks.numpy()
        assert np.asarray(blocks).tobytes() == want.tobytes()
        assert [x for x in os.listdir(d) if x.startswith("quarantine")] \
            == ["quarantine.shard_0002"]
        answers[pkg] = svc.topk(k=8, num_walks=900).result()
    _same(answers["ref"], answers["port"])


# --- the eviction mask lives on the host ------------------------------------


@pytest.mark.parametrize("dispatch", ["fused", "loop"])
def test_eviction_mask_built_once_and_never_read_back(setup, monkeypatch,
                                                      dispatch):
    """Before an eviction the waves take no mask; after it every degraded
    wave takes the same device mask (built once, at the eviction), and the
    loop wave the same block table, the lost shard's entry null, with the
    mask's host copy, so its rounds' call needs no read from the device."""
    from repro_torch.kernels import ops
    name = ("stitch_gather_rounds" if dispatch == "fused"
            else "stitch_gather_local_rounds")
    calls = []
    real = getattr(ops, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(ops, name, spy)
    sched = _sched(setup, "port", plan=dict(shard_losses=((1, 2),)),
                   sharded_dispatch=dispatch)
    _drain(sched, _reqs("port"))
    assert len(calls) == sched.stats().waves_run >= 3
    masks = [args[5] for args, _ in calls]
    assert masks[0] is None
    assert all(m is sched._lost_dev for m in masks[1:])
    assert sched._lost_dev.tolist() == [False, False, True, False]
    if dispatch == "loop":
        tables = [args[3] for args, _ in calls]
        assert tables[0].blocks[2] is not None and tables[1].blocks[2] is None
        assert all(t is tables[1] for t in tables[1:])
        assert [kw["lost_host"] for _, kw in calls[1:]] == \
            [sched._lost] * (len(calls) - 1)


def test_missing_block_check_reads_the_host_copy():
    """``lost_host`` is what the missing-block check reads: a host copy
    that calls shard 0 live refuses its missing block although the device
    mask says lost."""
    from repro_torch.kernels import ops
    blocks = [None, torch.zeros(5, 3, dtype=torch.int32)]
    pos, q, s0 = (torch.zeros(4, dtype=torch.int32) for _ in range(3))
    lost = torch.tensor([True, False])
    table = ops.block_table(blocks)
    got, alive = ops.stitch_gather_local_rounds(pos, q, s0, table, 2, lost,
                                                lost_host=[True, False])
    assert not alive.any()                      # every walk sits in shard 0
    with pytest.raises(ValueError, match=r"shards \[0\] have no block"):
        ops.stitch_gather_local_rounds(pos, q, s0, table, 2, lost,
                                       lost_host=[False, False])
    with pytest.raises(ValueError, match="lost_host needs lost"):
        ops.stitch_gather_local_rounds(pos, q, s0, table, 2,
                                       lost_host=[True, False])
