"""The erasure walks (p_s < 1) of the port against the reference.

The coin hashes (``hash_bits``, ``coin_uniform`` with both impls), the
retry budget and the ``draw="auto"`` policy, the graph's derived per-edge
arrays (``edge_src``, ``edge_dst_shard``, ``channel_layout``), the forced
edge, both probe draws (the channel enumeration with a skewed hub and fully
blocked vertices, edge rejection in its one-shot and its chunked regime),
``draw_next`` for every (erasure model × draw), the whole batch through
``FrogWildService.pagerank`` at the quickstart's configuration and
``sparsify_uniform`` are byte-equal to ``repro``'s for the same graph,
config and key. Everything here is integer hashing, threefry draws and
the exact coin ``(bits >> 8)·2⁻²⁴``, so every comparison is byte for byte.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.frogwild  # noqa: F401  (the module, not the function)
from repro import FrogWildService as JFrogWildService
from repro.config import FrogWildConfig as JFrogWildConfig
from repro.config import KernelConfig as JKernelConfig
from repro.config import RuntimeConfig as JRuntimeConfig
from repro.config import ShardConfig as JShardConfig
from repro.core import blocking as jblocking
from repro.core import sparsify as jsparsify
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
import repro_torch.core.frogwild  # noqa: F401
from repro_torch import (FrogWildService, KernelConfig, RuntimeConfig,
                         ShardConfig, convert)
from repro_torch.config import FrogWildConfig
from repro_torch.core import blocking as tblocking
from repro_torch.core import sparsify as tsparsify
from repro_torch.graph import generators as tgen

jfw = sys.modules["repro.core.frogwild"]
tfw = sys.modules["repro_torch.core.frogwild"]

MODELS = ["independent", "channel"]
DRAWS = ["rejection", "cumsum", "auto"]


def _graphs(n=500, deg=6.0, seed=1):
    return (jgen.chung_lu_powerlaw(n, deg, seed=seed),
            tgen.chung_lu_powerlaw(n, deg, seed=seed))


def _keys(seed):
    key = jax.random.PRNGKey(seed)
    return key, convert.key_from_jax(jax.random.key_data(key), device="cpu")


def _bytes_equal(want, got: torch.Tensor) -> None:
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert want.shape == got.shape
    assert want.tobytes() == got.astype(want.dtype).tobytes()


def _zero_degree_graph(n=41, seed=0):
    """A CSR with degree-0 vertices, the last one included (its forced
    edge points one past the end), and a hub of 99 edges."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 6, n)
    deg[[0, n // 2, n - 1]] = 0
    deg[3] = 99
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = rng.integers(0, n, int(row_ptr[-1])).astype(np.int32)
    gj = jcsr.CSRGraph(n=n, row_ptr=jnp.asarray(row_ptr),
                       col_idx=jnp.asarray(col_idx),
                       out_deg=jnp.asarray(deg.astype(np.int32)))
    return gj, convert.graph_from_numpy(n, row_ptr, col_idx, device="cpu")


def test_hash_bits_and_coins_equal():
    key, tkey = _keys(42)
    rng = np.random.default_rng(0)
    idx = rng.integers(-(1 << 31), 1 << 31, 20_000).astype(np.int32)
    idx[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    _bytes_equal(jblocking.hash_bits(key, jnp.asarray(idx)),
                 tblocking.hash_bits(tkey, torch.from_numpy(idx)))
    for impl in ("hash", "fold_in"):
        want = jblocking.coin_uniform(key, jnp.asarray(idx[:3000]), impl=impl)
        got = tblocking.coin_uniform(tkey, torch.from_numpy(idx[:3000]),
                                     impl=impl)
        assert got.dtype == torch.float32
        _bytes_equal(want, got)
    # a 2-D index grid, as the channel model's coins are drawn
    grid = rng.integers(0, 1 << 20, (257, 16)).astype(np.int32)
    _bytes_equal(jblocking.coin_uniform(key, jnp.asarray(grid)),
                 tblocking.coin_uniform(tkey, torch.from_numpy(grid)))
    with pytest.raises(ValueError, match="coin impl"):
        tblocking.coin_uniform(tkey, torch.zeros(3), impl="philox")


def test_retry_budget_and_auto_policy_equal():
    for p_s in (1e-4, 1e-3, 0.01, 0.05, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99, 1.0):
        for eps in (1e-2, 1e-4, 1e-8):
            assert (tblocking.num_rounds_for(p_s, eps)
                    == jblocking.num_rounds_for(p_s, eps))
        for B in (1, 1000, 400_000):
            for nnz in (10, 10_000, 68_829_582):
                for nc in (None, 4, 16):
                    assert (tblocking.rejection_is_profitable(B, nnz, p_s, nc)
                            == jblocking.rejection_is_profitable(
                                B, nnz, p_s, nc))


@pytest.mark.parametrize("S", [1, 3, 16, 700])
def test_derived_edge_arrays_equal(S):
    gj, gt = _graphs(n=301)
    _bytes_equal(gj.edge_src, gt.edge_src)
    assert gt.shard_size(S) == gj.shard_size(S)
    _bytes_equal(gj.edge_dst_shard(S), gt.edge_dst_shard(S))
    for want, got in zip(gj.channel_layout(S), gt.channel_layout(S)):
        assert got.dtype == torch.int32
        _bytes_equal(want, got)
    assert gt.channel_layout(S)[0] is gt.channel_layout(S)[0]   # memoized


def test_forced_edge_equal():
    gj, gt = _zero_degree_graph()
    key, tkey = _keys(5)
    pos = np.random.default_rng(2).integers(0, gj.n, 2000).astype(np.int32)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    want = jblocking.forced_edge_for(key, jp, gj.row_ptr[jp], gj.out_deg[jp])
    got = tblocking.forced_edge_for(tkey, tp, gt.row_ptr[tp.long()],
                                    gt.out_deg[tp.long()])
    _bytes_equal(want, got)


@pytest.mark.parametrize("p_s", [0.0, 0.3, 0.7, 1.0])
def test_channel_enum_draw_equal(p_s):
    """Skew: vertex 3 has 99 edges, most of them into one shard; p_s = 0
    blocks every channel, so every frog takes its forced edge."""
    gj, gt = _zero_degree_graph()
    S = 4
    key, tkey = _keys(9)
    rng = np.random.default_rng(3)
    pos = rng.integers(0, gj.n, 3000).astype(np.int32)
    pos[:500] = 3
    skip = rng.random(3000) < 0.1
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos).long()
    _, jcnt, joff = gj.channel_layout(S)
    _, tcnt, toff = gt.channel_layout(S)
    coins = rng.random((3000, S)) < p_s
    coins[500:600] = False                       # fully blocked frogs
    for sk in (None, skip):
        want = jblocking.channel_enum_draw(
            key, jp, gj.row_ptr[jp], gj.out_deg[jp], jcnt[jp], joff[jp],
            jnp.asarray(coins), None if sk is None else jnp.asarray(sk))
        got = tblocking.channel_enum_draw(
            tkey, tp, gt.row_ptr[tp], gt.out_deg[tp], tcnt[tp], toff[tp],
            torch.from_numpy(coins),
            None if sk is None else torch.from_numpy(sk))
        _bytes_equal(want, got)


@pytest.mark.parametrize("p_s,B", [
    (0.7, 3000),          # one shot: 14 rounds · 3000 probes ≤ 2**21
    (0.1, 23_000),        # chunked: 93 rounds · 23,000 > 2**21, 3 chunks
])
def test_rejection_blocking_draw_equal_in_both_regimes(p_s, B):
    gj, gt = _zero_degree_graph(n=4099)
    rounds = jblocking.num_rounds_for(p_s)
    assert (rounds * B > jblocking.UNROLL_PROBES) == (p_s == 0.1)
    key, tkey = _keys(11)
    rng = np.random.default_rng(4)
    pos = rng.integers(0, gj.n, B).astype(np.int32)
    skip = rng.random(B) < 0.05
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    S, last = 8, gj.nnz - 1
    sz = gj.shard_size(S)
    # the edge's own coin (independent model) and a coarser channel id
    # (a degree-0 vertex's probe points one past the end: clamped)
    for jchan, tchan in (
            (lambda v, e: e, lambda v, e: e),
            (lambda v, e: v * S + gj.col_idx[jnp.minimum(e, last)] // sz,
             lambda v, e: v * S + gt.col_idx[e.clamp_max(last)] // sz)):
        want = jblocking.rejection_blocking_draw(
            key, jp, gj.row_ptr, gj.out_deg, p_s, jchan,
            skip=jnp.asarray(skip))
        got = tblocking.rejection_blocking_draw(
            tkey, tp, gt.row_ptr, gt.out_deg, p_s, tchan,
            skip=torch.from_numpy(skip))
        _bytes_equal(want, got)
    ckey, tckey = _keys(12)
    want = jblocking.rejection_blocking_draw(
        key, jp, gj.row_ptr, gj.out_deg, p_s, lambda v, e: e, num_rounds=9,
        coin_key=ckey)
    got = tblocking.rejection_blocking_draw(
        tkey, tp, gt.row_ptr, gt.out_deg, p_s, lambda v, e: e, num_rounds=9,
        coin_key=tckey)
    _bytes_equal(want, got)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("draw", DRAWS)
@pytest.mark.parametrize("p_s", [0.1, 0.7])
def test_draw_next_equal(model, draw, p_s):
    gj, gt = _graphs()
    key, tkey = _keys(3)
    pos = np.random.default_rng(0).integers(0, gj.n, 3000).astype(np.int32)
    kw = dict(num_frogs=3000, p_s=p_s, erasure=model, num_shards=4,
              draw=draw)
    want = jfw.draw_next(gj, JFrogWildConfig(**kw), key, jnp.asarray(pos))
    got = tfw.draw_next(gt, FrogWildConfig(**kw), tkey, torch.from_numpy(pos))
    assert got.dtype == torch.int32
    _bytes_equal(want, got)


def test_draw_next_on_zero_degree_vertices():
    """Frogs on degree-0 vertices stay put under every draw (the last
    vertex's forced edge points one past the end of ``col_idx``)."""
    gj, gt = _zero_degree_graph()
    key, tkey = _keys(4)
    pos = np.arange(gj.n, dtype=np.int32).repeat(20)
    for model in MODELS:
        for draw in ("rejection", "cumsum"):
            kw = dict(num_frogs=pos.size, p_s=0.5, erasure=model,
                      num_shards=3, draw=draw)
            want = jfw.draw_next(gj, JFrogWildConfig(**kw), key,
                                 jnp.asarray(pos))
            got = tfw.draw_next(gt, FrogWildConfig(**kw), tkey,
                                torch.from_numpy(pos))
            _bytes_equal(want, got)
            zero = (gt.out_deg == 0).numpy()[pos]
            assert (got.numpy()[zero] == pos[zero]).all()


def test_unknown_model_or_draw_raises():
    _, gt = _graphs(n=50)
    _, tkey = _keys(0)
    pos = torch.zeros(4, dtype=torch.int32)
    for draw in ("rejection", "cumsum"):
        with pytest.raises(ValueError, match="erasure model 'bogus'"):
            tfw.draw_next(gt, FrogWildConfig(erasure="bogus", p_s=0.5,
                                             draw=draw), tkey, pos)
    with pytest.raises(ValueError, match="draw impl 'bogus'"):
        tfw.draw_next(gt, FrogWildConfig(erasure="channel", p_s=0.5,
                                         draw="bogus"), tkey, pos)
    with pytest.raises(ValueError, match="KernelConfig.draw"):
        KernelConfig(draw="bogus")


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("draw", DRAWS)
def test_quickstart_batch_byte_equal(model, draw):
    """The quickstart's configuration (p_s = 0.7, 16 destination shards,
    ``FrogWildService.pagerank(seed=0)``) scaled to a small graph: counts
    and ``pi_hat`` byte-equal, frogs conserved. At 4,000 frogs on 2,500
    edges ``"auto"`` picks the cumsum draw, as it does for the quickstart's
    own 50,000-vertex graph."""
    gj, gt = _graphs()
    kw = dict(num_frogs=4000, num_steps=7, p_s=0.7, erasure=model)
    want = JFrogWildService.open(gj, JRuntimeConfig(
        **kw, kernel=JKernelConfig(draw=draw),
        runtime=JShardConfig(num_shards=16))).pagerank(seed=0)
    svc = FrogWildService.open(gt, RuntimeConfig(
        **kw, kernel=KernelConfig(draw=draw),
        runtime=ShardConfig(num_shards=16)), device="cpu")
    assert svc.config.frogwild().num_shards == 16
    got = svc.pagerank(seed=0)
    _bytes_equal(want.counts, got.counts)
    _bytes_equal(want.pi_hat, got.pi_hat)
    assert int(got.counts.sum()) == 4000


def test_erasure_walk_at_p_s_one_is_the_plain_walk():
    """``use_erasure`` needs both a model and p_s < 1: at p_s = 1 the fused
    plain step runs, as in the reference."""
    gj, gt = _graphs()
    key, tkey = _keys(2)
    for model in MODELS:
        kw = dict(num_frogs=999, num_steps=4, p_s=1.0, erasure=model)
        want = jfw._frogwild_walks(gj, JFrogWildConfig(**kw), key)
        got = tfw._frogwild_walks(gt, FrogWildConfig(**kw), tkey)
        plain = tfw._frogwild_walks(gt, FrogWildConfig(
            num_frogs=999, num_steps=4), tkey)
        _bytes_equal(want.counts, got.counts)
        assert torch.equal(got.counts, plain.counts)


@pytest.mark.parametrize("q,seed", [(0.3, 0), (0.9, 4), (1.0, 1)])
def test_sparsify_uniform_equal(q, seed):
    gj, gt = _graphs(n=300)
    want = jsparsify.sparsify_uniform(gj, q, seed=seed)
    got = tsparsify.sparsify_uniform(gt, q, seed=seed)
    assert got.n == want.n
    for a in ("row_ptr", "col_idx", "out_deg"):
        _bytes_equal(getattr(want, a), getattr(got, a))
    with pytest.raises(ValueError, match="keep_prob"):
        tsparsify.sparsify_uniform(gt, 0.0)
