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


@pytest.mark.parametrize("n,deg,K", [(301, 6.0, 32), (500, 20.0, 8),
                                     (64, 3.0, 5), (1000, 14.2, 40)])
def test_to_ell_row_len(n, deg, K):
    """``row_len`` is each row's live lanes: the reference's
    ``valid.sum(1)``, ``min(in_deg, K)`` and 0 on the padding rows; an
    ``EllGraph`` made from the reference's arrays derives the same."""
    gj, gt = _graphs(n, deg)
    ej, et = jpartition.to_ell(gj, K=K), tpartition.to_ell(gt, K=K)
    assert et.row_len.dtype == torch.int32
    assert et.row_len.shape == (et.n_rows,)
    assert (et.row_len.numpy() == np.asarray(ej.valid).sum(1)).all()
    in_deg = np.bincount(gt.col_idx.numpy(), minlength=n)
    assert (et.row_len.numpy()[:n] == np.minimum(in_deg, et.K)).all()
    assert not et.row_len[n:].any()
    back = convert.ell_from_numpy(ej.n_rows, ej.K, *(
        np.asarray(getattr(ej, f)) for f in ELL_FIELDS), device="cpu")
    assert torch.equal(back.row_len, et.row_len)


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
        np.asarray(getattr(ej, f)) for f in ELL_FIELDS), device="cpu")
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


def _kernel_replay(idx, w, x, row_len=None):
    """``csrc/spmv_ell.cu``'s schedule in numpy → ``(y, reads)``, ``reads``
    counting the loads of each lane. Each warp owns 32 rows and walks
    them in windows of 32 lanes; a scan of the rows' live lengths in the
    window lays their live lanes end to end; compacted lane ``e`` finds
    its row by the kernel's binary search over the scan and stages its
    rounded product at ``e + e // 32``; then row ``r`` adds its staged
    products in order, from +0."""
    rows, K = idx.shape
    y = np.zeros(rows, np.float32)
    reads = np.zeros((rows, K), np.int64)
    for row0 in range(0, rows, 32):
        nrow = min(32, rows - row0)
        lens = np.zeros(32, np.int64)
        lens[:nrow] = K if row_len is None else np.clip(
            row_len[row0:row0 + nrow], 0, K)
        acc = np.zeros(32, np.float32)
        k0 = 0
        while True:
            lw = np.clip(lens - k0, 0, 32)
            inc = np.cumsum(lw)
            off = inc - lw
            prod = np.full(32 * 32 + 32, np.nan, np.float32)
            for e in range(int(inc[-1])):
                r = 0
                for step in (16, 8, 4, 2, 1):
                    if off[r + step] <= e:
                        r += step
                at = (row0 + r, k0 + e - off[r])
                reads[at] += 1
                prod[e + (e >> 5)] = w[at] * x[idx[at]]
            for r in range(32):
                for j in range(lw[r]):
                    e = off[r] + j
                    acc[r] = acc[r] + prod[e + (e >> 5)]
            k0 += 32
            if k0 >= lens.max():
                break
        y[row0:row0 + nrow] = acc[:nrow]
    return y, reads


def _ragged_slab(rows, K, seed):
    """A slab laid out as ``to_ell`` lays it: row ``r``'s first
    ``row_len[r]`` lanes live, the rest weight 0 and id 0; rows of length
    0 and K; mixed signs and zeros in ``w`` and ``x``; row 2's live
    products all −0.0."""
    rng = np.random.default_rng(seed)
    row_len = rng.integers(0, K + 1, rows).astype(np.int32)
    row_len[[0, 3]] = 0
    row_len[[1, rows - 1]] = K
    row_len[2] = max(1, row_len[2])
    idx = rng.integers(0, 97, (rows, K)).astype(np.int32)
    w = rng.standard_normal((rows, K)).astype(np.float32)
    w[rng.random((rows, K)) < 0.2] = 0.0
    x = rng.standard_normal(97).astype(np.float32)
    x[rng.random(97) < 0.1] = 0.0
    x[5] = 1.5
    idx[2], w[2] = 5, -0.0
    padded = np.arange(K)[None, :] >= row_len[:, None]
    idx[padded], w[padded] = 0, 0.0
    return idx, w, x, row_len, ~padded


@pytest.mark.parametrize("live", ["row_len", "every_lane"])
@pytest.mark.parametrize("rows,K", [(70, 8), (33, 32), (45, 40), (40, 70)])
def test_spmv_kernel_schedule_replay(rows, K, live):
    """The kernel's compacted schedule reads each live lane once and no
    padded lane (every lane without ``row_len``), and adds in the plain
    version's order: byte-equal to ``spmv_ref`` on finite ``x``."""
    idx, w, x, row_len, mask = _ragged_slab(rows, K, rows + K)
    want = kref.spmv_ref(*map(torch.from_numpy, (idx, w, x))).numpy()
    got, reads = _kernel_replay(idx, w, x,
                                row_len if live == "row_len" else None)
    assert got.tobytes() == want.tobytes()
    assert (reads == (mask if live == "row_len" else 1)).all()
    assert want[2] == 0.0 and not np.signbit(want[2])   # −0.0 terms: +0


def test_spmv_live_lanes_differ_from_plain_only_on_non_finite_x0():
    """``x[0] = inf`` (the id of every padded lane): the plain version's
    rows with a padded lane read ``0 · inf`` and turn NaN; the kernel's
    schedule never reads a padded lane. Rows with no padding agree byte for
    byte, and a finite ``x[0]`` makes every row agree."""
    _, gt = _graphs(301, 6.0)
    ell = tpartition.to_ell(gt, K=8)
    idx, w, row_len = ell.idx.numpy(), ell.weight.numpy(), ell.row_len
    x = np.random.default_rng(1).standard_normal(ell.n_rows).astype(
        np.float32)
    x[0] = np.inf
    plain = ops.spmv_ell_slab(ell.idx, ell.weight, torch.from_numpy(x),
                              row_len=row_len).numpy()
    kernel, _ = _kernel_replay(idx, w, x, row_len.numpy())
    padded = (row_len < ell.K).numpy()
    reads_0 = ((idx == 0) & ell.valid.numpy()).any(1)
    assert padded.any() and (~padded).any()
    assert np.isnan(plain[padded]).all()
    assert np.isfinite(kernel[padded & ~reads_0]).all()
    assert kernel[~padded].tobytes() == plain[~padded].tobytes()
    x[0] = 2.0
    plain = ops.spmv_ell_slab(ell.idx, ell.weight, torch.from_numpy(x),
                              row_len=row_len).numpy()
    assert _kernel_replay(idx, w, x, row_len.numpy())[0].tobytes() == \
        plain.tobytes()


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
    with pytest.raises(TypeError, match="row_len must be int32"):
        ops.spmv_ell_slab(idx, w, x, row_len=torch.zeros(4))
    with pytest.raises(ValueError, match="row_len has 3 elements"):
        ops.spmv_ell_slab(idx, w, x,
                          row_len=torch.zeros(3, dtype=torch.int32))


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
