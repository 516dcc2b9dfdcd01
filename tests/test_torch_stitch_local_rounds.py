"""The loop wave's stitch rounds over every shard's block in one call
(``ops.stitch_gather_local_rounds``), and ``walk_wave``'s rounds with their
stop tally in one call (``ops.stitch_step_rounds``).

On the CPU each wrapper runs its plain version. Byte for byte:

* (a) the local rounds against the reference's per-round, per-shard
  composition: its interpret-mode Pallas ``stitch_step_local(...,
  tally=False)`` through its own ``QueryScheduler._shard_round`` for every
  shard not lost, summed, round by round under its ``_stitch_rounds``
  lost-shard rule; S = 1 and 4, no lost shard and one, q = 0, q > q_max,
  walks in the last shard, ``s0 + j`` wrapping past 2**31 − 1 and a slot
  value of INT32_MIN; blocks stacked and separate, a lost shard's block
  missing;
* (b) the port's loop wave against the reference's ``_build_loop_wave``
  through both schedulers, with and without a lost shard, one call a wave;
* (c) the tallied rounds against the reference's ``stitch_step`` rounds
  and the port's ``walk_wave`` / ``query_counts`` against the reference's
  (its ``stitch_step`` path), with walks at q = 0 and q > num_rounds.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import WalkIndexConfig as JWalkIndexConfig
from repro.graph import generators as jgen
from repro.kernels import ops as jops
from repro.query import engine as jengine
from repro.query import index as jindex
from repro.query import scheduler as jsched
from repro_torch import convert
from repro_torch.config import WalkIndexConfig
from repro_torch.graph import generators as tgen
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.query import engine as tengine
from repro_torch.query import index as tindex
from repro_torch.query import scheduler as tsched

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


def _tkey(key):
    return convert.key_from_jax(jax.random.key_data(key), device="cpu")


def _local_inputs(W, n, R, S, q_max, mode, seed):
    """Positions, round counts and slot offsets, and ``S`` blocks of
    ``sz = ceil(n / S)`` rows (the last one's rows past ``n`` are never
    gathered: every value is a vertex < n)."""
    rng = np.random.default_rng(seed)
    sz = -(-n // S)
    blocks = rng.integers(0, n, (S, sz, R)).astype(np.int32)
    pos = rng.integers(0, n, W).astype(np.int32)
    pos[:2] = (n - 1, (S - 1) * sz)                 # in the last shard
    q = rng.integers(0, q_max + 1, W).astype(np.int32)
    s0 = rng.integers(0, 1 << 30, W).astype(np.int32)
    if mode == "q_zero":
        q[:] = 0
    elif mode == "q_over":
        q = rng.integers(q_max + 1, 3 * q_max + 2, W).astype(np.int32)
    elif mode == "wraps":
        # s0 + j passes 2**31 − 1 and wraps negative; walk 0's second
        # round draws with INT32_MIN, walk 1's first
        s0 = (I32_MAX - rng.integers(0, 2 * q_max, W)).astype(np.int32)
        s0[:2] = (I32_MAX, I32_MIN)
        q[:2] = q_max
    return pos, q, s0, blocks, sz


def _reference_rounds(pos, q, s0, blocks, q_max, lost):
    """The reference loop wave's rounds: its ``_shard_round`` (the Pallas
    ``stitch_step_local`` in interpret mode, gather only) over the shards
    not lost, summed, under its ``_stitch_rounds``."""
    S, sz, R = blocks.shape
    owner = types.SimpleNamespace(
        index=types.SimpleNamespace(segments_per_vertex=R, shard_size=sz),
        impl="pallas", _q_max=q_max)
    jb = [jnp.asarray(b.reshape(-1)) for b in blocks]
    jpos, jq, js0 = map(jnp.asarray, (pos, q, s0))

    def round_fn(p, j):
        return sum(jsched.QueryScheduler._shard_round(
            owner, jb[s], s * sz, p, jq, js0, j)
            for s in range(S) if lost is None or not lost[s])

    lost_of = None if lost is None else (
        lambda p: jnp.asarray(lost)[jnp.clip(p // sz, 0, S - 1)])
    out, alive = jsched.QueryScheduler._stitch_rounds(owner, jpos, jq,
                                                      round_fn, lost_of)
    return np.asarray(out), None if alive is None else np.asarray(alive)


@pytest.mark.parametrize("mode", ["random", "q_zero", "q_over", "wraps"])
@pytest.mark.parametrize("S,lost_shard", [(1, None), (1, 0), (4, None),
                                          (4, 3), (4, 1)])
def test_local_rounds_equal_reference_composition(S, lost_shard, mode):
    n, R, q_max, W = 61, 5, 4, 300
    pos, q, s0, blocks, sz = _local_inputs(W, n, R, S, q_max, mode,
                                           S + q_max)
    lost = None
    if lost_shard is not None:
        lost = np.zeros(S, bool)
        lost[lost_shard] = True
    want_pos, want_alive = _reference_rounds(pos, q, s0, blocks, q_max,
                                             lost)
    tpos, tq, ts0 = map(torch.from_numpy, (pos, q, s0))
    tlost = None if lost is None else torch.from_numpy(lost)
    stacked = list(torch.from_numpy(blocks))        # views of one tensor
    separate = [torch.from_numpy(b.copy()) for b in blocks]
    if lost is not None and S > 1:
        separate[lost_shard] = None                 # never read
    table = ops.block_table(separate)
    before = ops.launch_counts()
    got = [ops.stitch_gather_local_rounds(tpos, tq, ts0,
                                          ops.block_table(stacked), q_max,
                                          tlost),
           ops.stitch_gather_local_rounds(tpos, tq, ts0, table, q_max,
                                          tlost),
           kref.stitch_gather_local_rounds_ref(tpos, tq, ts0, separate,
                                               q_max, tlost)]
    assert ops.launch_counts() == before          # CPU: the plain version
    # the fused wave's one-slab rounds over the same blocks, stacked
    fused = ops.stitch_gather_rounds(tpos, tq, ts0,
                                     torch.from_numpy(blocks).reshape(-1, R),
                                     q_max, tlost, S, sz)
    for got_pos, got_alive in (*got, fused):
        assert got_pos.dtype == torch.int32
        assert got_pos.numpy().tobytes() == want_pos.tobytes()
        if lost is None:
            assert got_alive is None
        else:
            assert got_alive.numpy().tobytes() == want_alive.tobytes()
    if mode == "q_zero":
        assert np.array_equal(want_pos, pos)
    if lost is not None and mode != "q_zero":
        assert not want_alive.all()
    if mode == "wraps":
        assert (s0.astype(np.int64) + q_max > I32_MAX).any()


def test_local_rounds_wrapper_refuses_bad_operands():
    pos, q, s0, blocks, sz = _local_inputs(10, 20, 3, 2, 4, "random", 0)
    tpos, tq, ts0 = map(torch.from_numpy, (pos, q, s0))
    bl = list(torch.from_numpy(blocks))
    table = ops.block_table(bl)
    lost = torch.tensor([False, True])
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.stitch_gather_local_rounds(tpos, tq, ts0, table, 4, impl="cuda")
    with pytest.raises(TypeError, match="q must be int32"):
        ops.stitch_gather_local_rounds(tpos, tq.long(), ts0, table, 4)
    with pytest.raises(ValueError, match="q_max"):
        ops.stitch_gather_local_rounds(tpos, tq, ts0, table, -1)
    with pytest.raises(ValueError, match="lost must be"):
        ops.stitch_gather_local_rounds(tpos, tq, ts0, table, 4,
                                       torch.zeros(3, dtype=torch.bool))
    # only a lost shard's block may be missing
    with pytest.raises(ValueError, match=r"shards \[0\] have no block"):
        ops.stitch_gather_local_rounds(tpos, tq, ts0,
                                       ops.block_table([None, bl[1]]), 4,
                                       lost)
    with pytest.raises(ValueError, match=r"shards \[1\] have no block"):
        ops.stitch_gather_local_rounds(tpos, tq, ts0,
                                       ops.block_table([bl[0], None]), 4)
    with pytest.raises(ValueError, match="at least one block"):
        ops.block_table([None, None])
    with pytest.raises(ValueError, match="must match"):
        ops.block_table([bl[0], bl[1][:-1]])
    with pytest.raises(ValueError, match="block must be 2-D"):
        ops.block_table([bl[0].reshape(-1)])
    got, alive = ops.stitch_gather_local_rounds(
        tpos, tq, ts0, ops.block_table([bl[0], None]), 4, lost)
    assert got.shape == (10,) and alive.dtype == torch.bool


def _wave_operands(n, W, Q, seed):
    rng = np.random.default_rng(seed)
    live = W - W // 5                        # the tail idles in row Q
    qid = np.full(W, Q, np.int32)
    qid[:live] = np.arange(live) * Q // live
    uniform = np.isin(qid, [0, 2])
    start = np.where(uniform, 0, rng.integers(0, n, W)).astype(np.int32)
    t_cap = rng.integers(0, 20, W).astype(np.int32)
    return start, uniform, qid, t_cap


def _counting(monkeypatch, *names):
    """Counts the calls of ``ops.<name>`` as the scheduler and engine make
    them (on the CPU no kernel launches, so the counters stay 0)."""
    calls = {k: 0 for k in names}
    for k in names:
        def wrapped(*a, _f=getattr(ops, k), _k=k, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(ops, k, wrapped)
    return calls


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("lost_shards", [(), (1,)])
def test_loop_wave_equal_reference_one_call(monkeypatch, impl, lost_shards):
    """The port's loop wave, its rounds in one ``stitch_gather_local_rounds``
    call, gives the reference loop wave's counts (and the port's fused
    wave's)."""
    n, S, R, L = 130, 4, 5, 2
    gj = jgen.chung_lu_powerlaw(n, 6.0, seed=3)
    gt = tgen.chung_lu_powerlaw(n, 6.0, seed=3)
    sj = jindex.shard_walk_index(jindex._build_walk_index(gj, JWalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=2)), S)
    st = tindex.shard_walk_index(tindex._build_walk_index(gt, WalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=2)), S)
    W, Q = 160, 3
    operands = _wave_operands(n, W, Q, 9)
    lost = np.zeros(S, bool)
    lost[list(lost_shards)] = True
    key = jax.random.PRNGKey(5)
    kw = dict(max_walks=W, max_queries=Q, max_steps=10, seed=1)
    want = jsched.QueryScheduler(gj, sj, impl=impl, sharded_dispatch="loop",
                                 **kw)._wave_for(W, Q)(
        *map(jnp.asarray, operands), key, jnp.asarray(lost))
    calls = _counting(monkeypatch, "stitch_gather_local_rounds",
                      "stitch_gather_local", "stitch_step_local")
    got = {}
    for d in ("loop", "fused"):
        wave = tsched.QueryScheduler(gt, st, sharded_dispatch=d,
                                     **kw)._wave_for(W, Q)
        got[d] = wave(*map(torch.from_numpy, operands), _tkey(key),
                      torch.from_numpy(lost) if lost_shards else None)
        if d == "loop":
            assert calls == {"stitch_gather_local_rounds": 1,
                             "stitch_gather_local": 0,
                             "stitch_step_local": 0}
    want = np.asarray(want)
    assert got["loop"].shape == want.shape == (Q, n)
    assert got["loop"].tobytes() == want.tobytes()
    assert got["fused"].tobytes() == want.tobytes()
    live = int((operands[2] < Q).sum())
    assert (int(want.sum()) < live) == bool(lost_shards)


@pytest.mark.parametrize("mode", ["random", "q_zero", "q_over", "wraps"])
def test_step_rounds_equal_reference_stitch_steps(mode):
    """The tallied rounds in one call against ``num_rounds + 1`` rounds of
    the reference's Pallas ``stitch_step`` (interpret mode) and
    ``jnp.where``, as its ``walk_wave`` runs them."""
    n, R, num_rounds, W = 53, 6, 4, 257
    pos, q, s0, blocks, _ = _local_inputs(W, n, R, 1, num_rounds, mode, 17)
    endpoints = blocks[0][:n]
    if mode == "random":                      # q from 0 past num_rounds
        q = np.random.default_rng(3).integers(0, num_rounds + 3, W).astype(
            np.int32)
    jpos, jq, js0, jend = map(jnp.asarray, (pos, q, s0, endpoints))
    counts = jnp.zeros(n, jnp.int32)
    for j in range(num_rounds + 1):
        nxt, c = jops.stitch_step(jpos, (jq == j).astype(jnp.int32), js0 + j,
                                  jend, n, impl="pallas")
        counts = counts + c
        jpos = jnp.where(j < jq, nxt, jpos)
    tin = list(map(torch.from_numpy, (pos, q, s0, endpoints)))
    before = ops.launch_counts()
    got = [ops.stitch_step_rounds(*tin, n, num_rounds),
           kref.stitch_step_rounds_ref(*tin, n, num_rounds)]
    assert ops.launch_counts() == before
    for got_pos, got_counts in got:
        assert got_pos.numpy().tobytes() == np.asarray(jpos).tobytes()
        assert got_counts.numpy().tobytes() == np.asarray(counts).tobytes()
    tallied = int(((q >= 0) & (q <= num_rounds)).sum())
    assert int(got[0][1].sum()) == tallied
    if mode == "q_over":
        assert tallied == 0
    with pytest.raises(ValueError, match="num_rounds"):
        ops.stitch_step_rounds(*tin, n, -1)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.stitch_step_rounds(*tin, n, num_rounds, impl="cuda")


def _graphs(n):
    return (jgen.chung_lu_powerlaw(n, 5.0, seed=6),
            tgen.chung_lu_powerlaw(n, 5.0, seed=6))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_walk_wave_one_call(monkeypatch, impl):
    """The port's ``walk_wave``, its rounds and tally in one
    ``stitch_step_rounds`` call, against the reference's ``stitch_step``
    path, walks at q = 0 and q > num_rounds among them."""
    n, R, L, rounds, W = 150, 6, 3, 3, 400
    gj, gt = _graphs(n)
    rng = np.random.default_rng(8)
    endpoints = rng.integers(0, n, (n, R)).astype(np.int32)
    pos0 = rng.integers(0, n, W).astype(np.int32)
    tau = rng.integers(0, (rounds + 3) * L, W).astype(np.int32)
    assert (tau < L).any() and (tau // L > rounds).any()
    key = jax.random.PRNGKey(23)
    want_pos, want_counts = jengine.walk_wave(
        gj.row_ptr, gj.col_idx, gj.out_deg, jnp.asarray(endpoints),
        jnp.asarray(pos0), jnp.asarray(tau), key, L, rounds, impl=impl)
    calls = _counting(monkeypatch, "stitch_step_rounds", "stitch_step")
    got_pos, got_counts = tengine.walk_wave(
        gt.row_ptr, gt.col_idx, gt.out_deg, torch.from_numpy(endpoints),
        torch.from_numpy(pos0), torch.from_numpy(tau), _tkey(key), L, rounds)
    assert calls == {"stitch_step_rounds": 1, "stitch_step": 0}
    assert got_pos.numpy().tobytes() == np.asarray(want_pos).tobytes()
    assert got_counts.numpy().tobytes() == np.asarray(want_counts).tobytes()
    assert int(got_counts.sum()) == int((tau // L <= rounds).sum()) < W


def test_query_counts_one_call(monkeypatch):
    """``query_counts`` (top-k and PPR) in one ``stitch_step_rounds`` call
    each, against the reference's ``stitch_step`` path."""
    n, R, L = 150, 6, 3
    gj, gt = _graphs(n)
    ij = jindex._build_walk_index(gj, JWalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=2))
    it = tindex._build_walk_index(gt, WalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=2))
    plan = jengine.plan_query(10, 0.5, 0.1, max_steps=12,
                              segments_per_vertex=R, segment_len=L)
    tplan = tengine.QueryPlan(**plan.__dict__)
    key = jax.random.PRNGKey(29)
    calls = _counting(monkeypatch, "stitch_step_rounds", "stitch_step")
    for source in (None, 7):
        got = tengine.query_counts(gt, it, tplan, _tkey(key), source=source)
        want = jengine.query_counts(gj, ij, plan, key, source=source,
                                    impl="ref")
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
        assert int(got.sum()) == plan.num_walks
    assert calls == {"stitch_step_rounds": 2, "stitch_step": 0}
