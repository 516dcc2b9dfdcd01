"""The GraphLab-PR baseline of the port against the reference.

``to_ell`` gives the reference's hybrid ELL bytes (slab, validity,
weights and spill tail). The port's ``ops.spmv`` on the CPU (the plain
slab product in the kernel's order plus the ``index_add_`` spill tail)
agrees with the reference's Pallas kernel in interpret mode and with its
oracle within ``rtol=1e-6, atol=1e-6``: XLA sums each row in its own order
and the spill tail with ``segment_sum``, so the float32 sums differ in the
last bits (the reference's own kernel test allows ``atol=1e-4``). The ELL
power iteration agrees with a replica of the reference's loop
(``pagerank.py:59-71``; the reference itself raises ``ImportError``) and
with the port's COO iteration within ``rtol=1e-5, atol=1e-7``, the COO
path's tolerance against the reference. The wire-byte models are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pagerank as jpagerank
from repro.engine import netcost as jnetcost
from repro.graph import generators as jgen
from repro.graph import partition as jpartition
from repro.kernels import ops as jops
from repro_torch import convert, engine
from repro_torch.core import pagerank as tpagerank
from repro_torch.engine import netcost as tnetcost
from repro_torch.graph import generators as tgen
from repro_torch.graph import partition as tpartition
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

SPMV_TOL = dict(rtol=1e-6, atol=1e-6)
ITER_TOL = dict(rtol=1e-5, atol=1e-7)
ELL_FIELDS = ("idx", "valid", "weight", "spill_src", "spill_dst", "spill_w")


def _graphs(n, deg, seed=2):
    return (jgen.chung_lu_powerlaw(n, deg, seed=seed),
            tgen.chung_lu_powerlaw(n, deg, seed=seed))


def _hub_graphs(n=203, seed=0):
    """Every vertex points at vertex 7 too: its row spills far past K."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n), rng.integers(0, n, 4 * n)])
    dst = np.concatenate([np.full(n, 7), rng.integers(0, n, 4 * n)])
    from repro.graph.csr import build_csr as jbuild
    from repro_torch.graph.csr import build_csr as tbuild
    return jbuild(n, src, dst), tbuild(n, src, dst)


def _reference_ell_power_iteration(g, num_iters, p_T=0.15):
    """``repro/core/pagerank.py:59-71`` as written, with the one change
    that makes it run: ``ops.spmv`` from ``repro.kernels.ops`` in place of
    ``repro.kernels.spmv_ops``, which does not exist."""
    from repro.graph.partition import to_ell
    from repro.kernels import ops as spmv_ops

    ell = to_ell(g, K=32)
    x = jnp.full((g.n,), 1.0 / jpagerank.n_round(g.n), dtype=jnp.float32)

    def step(x, _):
        px = spmv_ops.spmv(ell, x, interpret=True)[: g.n]
        return (1.0 - p_T) * px + p_T / g.n, None

    x, _ = jax.lax.scan(step, x, None, length=num_iters)
    return x


@pytest.mark.parametrize("n,deg,K", [
    (301, 6.0, 32),      # n not a multiple of 8
    (500, 20.0, 8),      # a heavy spill
    (64, 3.0, 5),        # K not a multiple of 8 (rounded up to 8)
    (1000, 14.2, 40),
])
def test_to_ell_equal(n, deg, K):
    gj, gt = _graphs(n, deg)
    want, got = jpartition.to_ell(gj, K=K), tpartition.to_ell(gt, K=K)
    assert (got.n_rows, got.K, got.spill_nnz) == (want.n_rows, want.K,
                                                   want.spill_nnz)
    for f in ELL_FIELDS:
        w, t = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == t.dtype and w.shape == t.shape, f
        assert w.tobytes() == t.tobytes(), f
    assert got.nbytes == sum(np.asarray(getattr(want, f)).nbytes
                             for f in ELL_FIELDS)


def test_to_ell_hub_spill_and_row_pad():
    gj, gt = _hub_graphs()
    for K, row_pad in ((8, 8), (16, 128)):
        want = jpartition.to_ell(gj, K=K, row_pad=row_pad)
        got = tpartition.to_ell(gt, K=K, row_pad=row_pad)
        assert got.spill_nnz == want.spill_nnz >= gt.n - K
        assert got.n_rows == want.n_rows == -(-gt.n // row_pad) * row_pad
        for f in ELL_FIELDS:
            assert (np.asarray(getattr(want, f)).tobytes()
                    == getattr(got, f).numpy().tobytes()), f


@pytest.mark.parametrize("n,deg,K", [(301, 6.0, 32), (500, 20.0, 8),
                                     (1000, 14.2, 40)])
def test_spmv_close_to_pallas_and_oracle(n, deg, K):
    gj, gt = _graphs(n, deg)
    ej = jpartition.to_ell(gj, K=K)
    et = tpartition.to_ell(gt, K=K)
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = ops.spmv(et, torch.from_numpy(x), impl="torch")
    assert got.dtype == torch.float32 and got.shape == (et.n_rows,)
    assert torch.equal(got, ops.spmv(et, torch.from_numpy(x)))  # auto: plain
    for impl in ("pallas", "ref"):
        want = np.asarray(jops.spmv(ej, jnp.asarray(x), impl=impl))
        np.testing.assert_allclose(got.numpy(), want, **SPMV_TOL,
                                   err_msg=impl)
    # the layout carried across from the reference gives the same product
    back = convert.ell_from_numpy(ej.n_rows, ej.K, *(
        np.asarray(getattr(ej, f)) for f in ELL_FIELDS))
    assert torch.equal(ops.spmv(back, torch.from_numpy(x)), got)


def test_spmv_slab_plain_sums_in_kernel_order():
    """The plain slab product is a loop over k of rounded products and
    sums, padded lanes included (``0 · x[idx]``); the ragged row count
    needs no padding."""
    rng = np.random.default_rng(0)
    rows, K, n = 37, 12, 50
    idx = rng.integers(0, n, (rows, K)).astype(np.int32)
    w = rng.standard_normal((rows, K)).astype(np.float32)
    w[:, 9:] = 0.0
    x = rng.standard_normal(n).astype(np.float32)
    want = np.zeros(rows, np.float32)
    for k in range(K):
        want = (want + (w[:, k] * x[idx[:, k]]).astype(np.float32)
                ).astype(np.float32)
    got = ops.spmv_ell_slab(*map(torch.from_numpy, (idx, w, x)))
    assert got.numpy().tobytes() == want.tobytes()
    assert torch.equal(got, kref.spmv_ref(*map(torch.from_numpy,
                                               (idx, w, x))))
    x[idx[3, 10]] = np.inf                   # 0 · inf on a padded lane
    assert torch.isnan(ops.spmv_ell_slab(
        *map(torch.from_numpy, (idx, w, x)))[3])


def _kernel_replay(idx, w, x):
    """``csrc/spmv_ell.cu``'s schedule in numpy: each warp's 32 rows in
    chunks of at most 32 lanes, chunk element ``q`` at row ``q // kc``,
    lane ``k0 + q % kc``, products staged, then each row's products added
    in order."""
    rows, K = idx.shape
    y = np.zeros(rows, np.float32)
    for row0 in range(0, rows, 32):
        nrow = min(32, rows - row0)
        acc = np.zeros(nrow, np.float32)
        for k0 in range(0, K, 32):
            kc = min(32, K - k0)
            prod = np.full((32, kc), np.nan, np.float32)
            for lane in range(32):
                for q in range(lane, 32 * kc, 32):
                    r, j = divmod(q, kc)
                    if r < nrow:
                        at = (row0 + r, k0 + j)
                        prod[r, j] = w[at] * x[idx[at]]
            for j in range(kc):
                acc = (acc + prod[:nrow, j]).astype(np.float32)
        y[row0:row0 + nrow] = acc
    return y


@pytest.mark.parametrize("rows,K", [(70, 8), (33, 32), (45, 40), (40, 70)])
def test_spmv_kernel_schedule_replay(rows, K):
    """The kernel's warp and chunk schedule covers every lane of every row
    once and adds in the plain version's order (byte-equal)."""
    rng = np.random.default_rng(rows + K)
    idx = rng.integers(0, 97, (rows, K)).astype(np.int32)
    w = rng.standard_normal((rows, K)).astype(np.float32)
    x = rng.standard_normal(97).astype(np.float32)
    want = kref.spmv_ref(*map(torch.from_numpy, (idx, w, x))).numpy()
    assert _kernel_replay(idx, w, x).tobytes() == want.tobytes()


def test_spmv_wrapper_refuses_bad_operands():
    idx = torch.zeros(4, 8, dtype=torch.int32)
    w = torch.zeros(4, 8)
    x = torch.zeros(10)
    before = ops.launch_counts()
    ops.spmv_ell_slab(idx, w, x)             # CPU: the plain version
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.spmv_ell_slab(idx, w, x, impl="cuda")
    with pytest.raises(TypeError, match="int32"):
        ops.spmv_ell_slab(idx.long(), w, x)
    with pytest.raises(TypeError, match="weight must be contiguous"):
        ops.spmv_ell_slab(idx, w.double(), x)
    with pytest.raises(TypeError, match="x must be contiguous"):
        ops.spmv_ell_slab(idx, w, x[::2])
    with pytest.raises(ValueError, match="idx's shape"):
        ops.spmv_ell_slab(idx, w[:, :4].contiguous(), x)


@pytest.mark.parametrize("iters", [1, 50])
def test_ell_power_iteration_close_to_reference_loop(iters):
    gj, gt = _graphs(301, 6.0, seed=3)
    want = np.asarray(_reference_ell_power_iteration(gj, iters))
    got = tpagerank.power_iteration(gt, num_iters=iters, spmv="ell")
    assert got.dtype == torch.float32 and got.shape == (gt.n,)
    np.testing.assert_allclose(got.numpy(), want, **ITER_TOL)
    # the reference's own ELL path still fails on its missing import
    with pytest.raises(ImportError, match="spmv_ops"):
        jpagerank.power_iteration(gj, num_iters=iters, spmv="ell")


@pytest.mark.parametrize("iters", [1, 50])
def test_ell_power_iteration_close_to_coo(iters):
    """At n a multiple of 8 the ELL path's start ``1/n_round(n)`` is the
    COO path's ``1/n``, so the two agree from the first iteration; with a
    hub that spills, the spill tail is exercised."""
    for gt in (tgen.chung_lu_powerlaw(504, 8.0, seed=3), _hub_graphs(200)[1]):
        ell = tpagerank.power_iteration(gt, num_iters=iters, spmv="ell")
        coo = tpagerank.power_iteration(gt, num_iters=iters, spmv="coo")
        np.testing.assert_allclose(ell.numpy(), coo.numpy(), **ITER_TOL)
    with pytest.raises(ValueError, match="spmv impl 'csr'"):
        tpagerank.power_iteration(gt, spmv="csr")


@pytest.mark.parametrize("iters", [1, 2])
def test_reduced_iteration_baseline_close(iters):
    gj, gt = _graphs(400, 8.0, seed=5)
    want = np.asarray(jpagerank.reduced_iteration_baseline(gj, iters))
    got = tpagerank.reduced_iteration_baseline(gt, iters)
    np.testing.assert_allclose(got.numpy(), want, **ITER_TOL)
    assert tpagerank.n_round(301) == jpagerank.n_round(301) == 304


def test_netcost_equal():
    rng = np.random.default_rng(0)
    sent = rng.integers(0, 1000, 9)
    syncs = rng.integers(0, 500, 9)
    pairs = [
        (jnetcost.frogwild_bytes_measured(sent, syncs),
         tnetcost.frogwild_bytes_measured(sent, syncs)),
        (jnetcost.frogwild_bytes_model(400_000, 67, 0.15, 0.7, 16),
         engine.frogwild_bytes_model(400_000, 67, 0.15, 0.7, 16)),
        (jnetcost.frogwild_bytes_model(1000, 5, 0.2, 0.3, 4, 2.5),
         tnetcost.frogwild_bytes_model(1000, 5, 0.2, 0.3, 4, 2.5)),
        (jnetcost.pagerank_bytes_model(4_847_571, 2, 16),
         engine.pagerank_bytes_model(4_847_571, 2, 16)),
    ]
    for want, got in pairs:
        assert got.total == want.total
        assert got.per_step.tobytes() == want.per_step.tobytes()
        assert str(got) == str(want)
    assert (tnetcost.SYNC_MSG_BYTES, tnetcost.FROG_PAYLOAD_BYTES,
            tnetcost.RANK_BYTES) == (jnetcost.SYNC_MSG_BYTES,
                                     jnetcost.FROG_PAYLOAD_BYTES,
                                     jnetcost.RANK_BYTES)
