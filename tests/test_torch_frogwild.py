"""Slice A of the port (the batch estimate) against the reference.

The same graph, config and key go through ``repro`` and ``repro_torch``:
the walker counts and ``pi_hat`` are byte-equal (same threefry streams,
same integer walk), the plan and the Theorem 1 bounds are equal (the same
float64 arithmetic), and exact PageRank agrees within ``rtol=1e-5,
atol=1e-7`` because XLA's ``segment_sum`` and torch's ``index_add_`` add
the float32 terms in different orders.
"""
import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import service as jservice
from repro.config import FrogWildConfig as JFrogWildConfig
from repro.config import RuntimeConfig as JRuntimeConfig
import repro.core.frogwild  # noqa: F401  (the module, not the function)
from repro.core import metrics as jmetrics
from repro.core import pagerank as jpagerank
from repro.core import theory as jtheory
from repro.graph import generators as jgen
from repro.query import engine as jengine
from repro_torch import FrogWildService, KernelConfig, RuntimeConfig
from repro_torch import config as tconfig
from repro_torch import convert
from repro_torch import service as tservice
import repro_torch.core.frogwild  # noqa: F401
from repro_torch.core import metrics as tmetrics
from repro_torch.core import pagerank as tpagerank
from repro_torch.core import theory as ttheory
from repro_torch.graph import generators as tgen
from repro_torch.query import engine as tengine


jfw = sys.modules["repro.core.frogwild"]
tfw = sys.modules["repro_torch.core.frogwild"]


def _graphs(n=400, deg=6.0, seed=1):
    return (jgen.chung_lu_powerlaw(n, deg, seed=seed),
            tgen.chung_lu_powerlaw(n, deg, seed=seed))


def _bytes_equal(want, got: torch.Tensor) -> None:
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


@pytest.mark.parametrize("N,t,seed", [(1, 1, 0), (3000, 6, 5), (4097, 12, 9)])
@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_frogwild_walks_byte_equal(N, t, seed, impl):
    gj, gt = _graphs()
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = jfw._frogwild_walks(gj, JFrogWildConfig(num_frogs=N, num_steps=t),
                               key)
    got = tfw._frogwild_walks(
        gt, tconfig.FrogWildConfig(num_frogs=N, num_steps=t, step_impl=impl,
                                   tally_impl=impl),
        convert.key_from_jax(jax.random.key_data(key), device="cpu"))
    _bytes_equal(want.counts, got.counts)
    _bytes_equal(want.pi_hat, got.pi_hat)
    assert int(got.counts.sum()) == got.num_frogs == N


def test_frogwild_entry_point_byte_equal():
    """``frogwild(g, cfg, seed)`` and the fused-kernel path of the reference
    (``step_impl="ref"``) give the port's counts."""
    gj, gt = _graphs(300, 5.0, seed=2)
    want = jfw.frogwild(gj, JFrogWildConfig(num_frogs=2000, num_steps=5,
                                            step_impl="ref"), seed=4)
    got = tfw.frogwild(gt, tconfig.FrogWildConfig(num_frogs=2000,
                                                  num_steps=5),
                       seed=4, device="cpu")
    _bytes_equal(want.counts, got.counts)
    _bytes_equal(want.pi_hat, got.pi_hat)


@pytest.mark.parametrize("epsilon,k", [(0.3, 10), (0.2, 5)])
def test_service_pagerank_byte_equal(epsilon, k):
    """The front door: Theorem 1 inversion, then the walker estimator."""
    gj, gt = _graphs()
    want = jservice.FrogWildService.open(gj, JRuntimeConfig()).pagerank(
        epsilon=epsilon, delta=0.1, k=k)
    svc = FrogWildService.open(gt, RuntimeConfig(), device="cpu")
    got = svc.pagerank(epsilon=epsilon, delta=0.1, k=k)
    _bytes_equal(want.counts, got.counts)
    _bytes_equal(want.pi_hat, got.pi_hat)
    plain = svc.pagerank(epsilon=epsilon, delta=0.1, k=k, config=(
        dataclasses.replace(svc.config, kernel=KernelConfig(
            step_impl="torch", tally_impl="torch"))))
    assert torch.equal(plain.counts, got.counts)
    # batch_pagerank with an explicit key is the same run
    key = jax.random.PRNGKey(7)
    rc_j = dataclasses.replace(JRuntimeConfig(), num_frogs=999, num_steps=3)
    rc_t = dataclasses.replace(RuntimeConfig(), num_frogs=999, num_steps=3)
    _bytes_equal(jservice.batch_pagerank(gj, rc_j, key=key).counts,
                 tservice.batch_pagerank(
                     gt, rc_t, device="cpu",
                     key=convert.key_from_jax(jax.random.key_data(key),
                                          device="cpu"))
                 .counts)


@pytest.mark.parametrize("iters", [1, 50])
def test_power_iteration_close(iters):
    gj, gt = _graphs(500, 8.0, seed=3)
    want = np.array(jpagerank.power_iteration(gj, num_iters=iters))
    got = tpagerank.power_iteration(gt, num_iters=iters)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    res_j = float(jpagerank.pagerank_residual(gj, jnp.asarray(want)))
    res_t = float(tpagerank.pagerank_residual(gt, torch.from_numpy(want)))
    assert math.isclose(res_t, res_j, rel_tol=1e-4, abs_tol=1e-7)
    # the ELL path (the GraphLab-PR baseline on the SpMV kernel) is ported
    ell = tpagerank.power_iteration(gt, num_iters=iters, spmv="ell")
    assert ell.shape == (gt.n,) and bool(torch.isfinite(ell).all())


def test_metrics_equal_with_ties():
    """Ties rank the lower index first, as ``jax.lax.top_k`` does, so the
    selected sets are identical; the masses are float32 sums of the same
    ``k`` terms in another order, hence ``rtol=1e-6``."""
    rng = np.random.default_rng(0)
    pi = rng.random(200).astype(np.float32)
    pi /= pi.sum()
    est = rng.integers(0, 4, 200).astype(np.float32)    # many ties
    ej, pj = jnp.asarray(est), jnp.asarray(pi)
    et, pt = torch.from_numpy(est), torch.from_numpy(pi)
    for k in (1, 5, 17, 200):
        for v_j, v_t in ((ej, et), (pj, pt)):
            assert (tmetrics.topk_set(v_t, k).numpy()
                    == np.asarray(jax.lax.top_k(v_j, k)[1])).all()
        for fj, ft in ((jmetrics.mass_captured, tmetrics.mass_captured),
                       (jmetrics.normalized_mass_captured,
                        tmetrics.normalized_mass_captured)):
            np.testing.assert_allclose(ft(et, pt, k).numpy(),
                                       np.asarray(fj(ej, pj, k)), rtol=1e-6)
        assert (float(tmetrics.exact_identification(et, pt, k))
                == float(jmetrics.exact_identification(ej, pj, k)))


def test_theory_equal():
    for p_T, t, k, delta, N, p_s, p_cap in [
            (0.15, 4, 10, 0.1, 1000, 1.0, 0.0),
            (0.2, 9, 100, 0.05, 400_000, 0.7, 0.01)]:
        args = (p_T, t, k, delta, N, p_s, p_cap)
        assert ttheory.epsilon_bound(*args) == jtheory.epsilon_bound(*args)
        assert ttheory.mixing_term(p_T, t) == jtheory.mixing_term(p_T, t)
        assert (ttheory.sampling_term(k, delta, N, p_s, p_cap)
                == jtheory.sampling_term(k, delta, N, p_s, p_cap))
    assert (ttheory.p_cap_bound(1000, 5, 0.01, 0.15)
            == jtheory.p_cap_bound(1000, 5, 0.01, 0.15))
    assert (ttheory.pi_inf_powerlaw_bound(4_847_571)
            == jtheory.pi_inf_powerlaw_bound(4_847_571))
    for mu in (0.01, 0.2, 0.9):
        assert ttheory.suggested_steps(mu) == jtheory.suggested_steps(mu)
        assert (ttheory.suggested_frogs(100, mu)
                == jtheory.suggested_frogs(100, mu))


@pytest.mark.parametrize("kw", [
    dict(k=100, epsilon=0.1, delta=0.1, max_steps=32),
    dict(k=10, epsilon=0.3, delta=0.1, max_steps=32, segments_per_vertex=16,
         segment_len=4),
    dict(k=10, epsilon=0.05, delta=0.2, max_walks=5000, max_steps=64,
         segments_per_vertex=2, segment_len=3),
    dict(k=3, epsilon=5.0, delta=0.5),
])
def test_plan_query_equal(kw):
    got, want = tengine.plan_query(**kw), jengine.plan_query(**kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.num_rounds(4) == want.num_rounds(4)


def test_unported_features_raise():
    # the erasure walks are ported: the quickstart's configuration builds
    rc = tconfig.RuntimeConfig(erasure="channel", p_s=0.7)
    assert (rc.frogwild().erasure, rc.frogwild().p_s) == ("channel", 0.7)
    # sharded serving on one device is ported: four shards build
    assert tconfig.ShardConfig(num_shards=4).num_shards == 4
    with pytest.raises(ValueError, match="num_shards"):
        tconfig.ShardConfig(num_shards=0)
    # checkpoints and fault injection are ported
    assert tconfig.ServingConfig(checkpoint_dir="ckpt").checkpoint_dir \
        == "ckpt"
    with pytest.raises(TypeError, match="FaultPlan"):
        tconfig.RuntimeConfig(faults=object())
    with pytest.raises(ValueError, match="step_impl"):
        tconfig.KernelConfig(step_impl="pallas")
