"""The port's graph layer against the reference: identical generator
arrays, the same dangling fix, one ``.npz`` format read by both packages,
the same partition padding and walker hop."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.graph import partition as jpart
from repro_torch import convert
from repro_torch.device import resolve_device
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.graph import partition as tpart


def _same(gj, gt):
    assert gj.n == gt.n and gj.nnz == gt.nnz
    for a in ("row_ptr", "col_idx", "out_deg"):
        want = np.asarray(getattr(gj, a))
        got = getattr(gt, a)
        assert got.dtype == torch.int32, a
        assert (got.numpy() == want).all(), a
    assert (gj.epoch, gj.mutation_offset) == (gt.epoch, gt.mutation_offset)


@pytest.mark.parametrize("n,deg,theta,seed", [
    (1, 4.0, 2.2, 0), (257, 6.0, 2.2, 1), (2000, 14.2, 2.2, 0),
    (999, 3.0, 2.8, 5)])
def test_chung_lu_identical(n, deg, theta, seed):
    _same(jgen.chung_lu_powerlaw(n, deg, theta, seed),
          tgen.chung_lu_powerlaw(n, deg, theta, seed))


def test_other_generators_identical():
    _same(jgen.uniform_random(300, 5.0, seed=3),
          tgen.uniform_random(300, 5.0, seed=3))
    _same(jgen.ring_of_cliques(5, 4), tgen.ring_of_cliques(5, 4))


@pytest.mark.parametrize("dangling", ["hash", "self_loop"])
def test_build_csr_fixes_dangling_vertices_alike(dangling):
    rng = np.random.default_rng(0)
    n = 60
    src = rng.integers(0, n // 2, 200)      # vertices ≥ n/2 dangle
    dst = rng.integers(0, n, 200)
    _same(jcsr.build_csr(n, src, dst, dangling),
          tcsr.build_csr(n, src, dst, dangling))
    with pytest.raises(ValueError):
        tcsr.build_csr(n, src, dst, "nope")
    with pytest.raises(ValueError):
        tcsr.build_csr(n, src, dst + n)


def test_npz_written_by_each_package_loads_in_the_other(tmp_path):
    gj = jgen.chung_lu_powerlaw(400, 5.0, seed=2)
    gt = tgen.chung_lu_powerlaw(400, 5.0, seed=2)
    pj = jcsr.save_graph(str(tmp_path / "from_jax"), gj)
    pt = tcsr.save_graph(str(tmp_path / "from_torch"), gt)
    _same(gj, tcsr.load_graph(pj))
    _same(jcsr.load_graph(pt), gt)
    _same(jcsr.load_graph(pt), tcsr.load_graph(pt))


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_partition_graph_pads_alike(shards):
    gj = jgen.uniform_random(101, 4.0, seed=1)
    gt = tgen.uniform_random(101, 4.0, seed=1)
    pj, part_j = jpart.partition_graph(gj, shards)
    pt, part_t = tpart.partition_graph(gt, shards)
    _same(pj, pt)
    assert (part_j.num_shards, part_j.n, part_j.n_padded,
            part_j.shard_size) == (part_t.num_shards, part_t.n,
                                   part_t.n_padded, part_t.shard_size)
    assert part_j.bounds(shards - 1) == part_t.bounds(shards - 1)


def test_uniform_successor_and_transition_edges():
    # vertices 0 and 5 have out-degree 0 (a hand-made CSR, no repair)
    row_ptr = np.array([0, 0, 2, 5, 6, 8, 8], np.int32)
    col_idx = np.array([0, 3, 1, 2, 4, 5, 0, 2], np.int32)
    g = convert.graph_from_numpy(6, row_ptr, col_idx, device="cpu")
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 6, 500).astype(np.int32)
    bits = rng.integers(0, 1 << 30, 500).astype(np.int32)
    deg = np.diff(row_ptr).astype(np.int32)
    want = np.asarray(jcsr.uniform_successor(
        jnp.asarray(row_ptr), jnp.asarray(col_idx), jnp.asarray(deg),
        jnp.asarray(pos), jnp.asarray(bits)))
    got = tcsr.uniform_successor(g.row_ptr, g.col_idx, g.out_deg,
                                 torch.from_numpy(pos),
                                 torch.from_numpy(bits))
    assert (got.numpy() == want).all()
    gj = jgen.chung_lu_powerlaw(300, 6.0, seed=4)
    gt = tgen.chung_lu_powerlaw(300, 6.0, seed=4)
    sj, dj, wj = jcsr.transition_edges(gj)
    st, dt, wt = tcsr.transition_edges(gt)
    assert (st.numpy() == np.asarray(sj)).all()
    assert (dt.numpy() == np.asarray(dj)).all()
    assert (wt.numpy().view(np.int32) == np.asarray(wj).view(np.int32)).all()


def test_device_helper():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    g = tgen.ring_of_cliques(2, 3)
    assert g.to("cpu") is g
