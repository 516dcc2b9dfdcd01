"""The streamed superstep (``step_impl="stream"``) against the reference.

``block_csr``'s arrays, the streamed ``frog_step`` (sort, per-block runs,
the sorted kernel's plain version, unsort), the batch walk and the
service's ``pagerank`` under ``"stream"`` are byte-equal to ``repro``'s, at
block sizes that divide nothing and with a hub that draws every frog. The
index build under ``"stream"`` gives the reference's slab built with the
XLA step: the reference's own stream build refuses its traced graph
(ROADMAP.md Queue 3), and the per-vertex key streams make the slab
independent of the step backend. The CUDA kernel's work-item schedule is
checked here by replaying the kernel's loop in Python.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import service as jservice
from repro.config import KernelConfig as JKernelConfig
from repro.config import RuntimeConfig as JRuntimeConfig
from repro.config import ServingConfig as JServingConfig
from repro.config import WalkIndexConfig as JWalkIndexConfig
from repro.core import FrogWildConfig as JFrogWildConfig
from repro.core import frogwild as jfrogwild
from repro.graph import generators as jgen
from repro.kernels import frog_step_stream as jfss
from repro.kernels import ops as jops
from repro.query import index as jindex
from repro_torch import (FrogWildService, KernelConfig, RuntimeConfig,
                         ServingConfig, convert)
from repro_torch import config as tconfig
from repro_torch import service as tservice
from repro_torch.config import FrogWildConfig, WalkIndexConfig
from repro_torch.core import frogwild as tfrogwild
from repro_torch.graph import generators as tgen
from repro_torch.kernels import frog_step_stream as tfss
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref


def _eq(want, got: torch.Tensor) -> None:
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


def _hub_graph(n=200, hub=123, hub_deg=3000, seed=7):
    """A uniform random graph plus one vertex with ``hub_deg`` out-edges:
    its block's slab is far wider than the rest."""
    rng = np.random.default_rng(seed)
    deg = 1 + rng.poisson(2.0, n)
    deg[hub] = hub_deg
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    col = rng.integers(0, n, int(rp[-1])).astype(np.int32)
    return rp, col, deg.astype(np.int32)


def _both(rp, col, n):
    gt = convert.graph_from_numpy(n, rp, col, device="cpu")
    return (jnp.asarray(rp, jnp.int32), jnp.asarray(col),
            jnp.asarray(np.diff(rp).astype(np.int32))), gt


@pytest.mark.parametrize("n,bv,e_blk", [(130, 32, None), (300, 512, None),
                                        (513, 100, None), (97, 16, 128),
                                        ("hub", 32, None)])
def test_block_csr_arrays_equal_reference(n, bv, e_blk):
    if n == "hub":
        rp, col, _ = _hub_graph()
        n = 200
    else:
        g = jgen.uniform_random(n, avg_out_deg=5, seed=n)
        rp, col = np.asarray(g.row_ptr), np.asarray(g.col_idx)
    (jrp, jcol, jdeg), gt = _both(rp, col, n)
    want = jfss.block_csr(jrp, jcol, jdeg, n, vertex_block=bv, e_blk=e_blk)
    got = tfss.block_csr(gt.row_ptr, gt.col_idx, gt.out_deg, n,
                         vertex_block=bv, e_blk=e_blk)
    assert (got.vertex_block, got.num_blocks, got.n_pad, got.e_blk) == (
        want.vertex_block, want.num_blocks, want.n_pad, want.e_blk)
    for name in ("row_off", "deg", "col"):
        _eq(getattr(want, name), getattr(got, name))
    assert tfss.max_block_nnz(gt.row_ptr, n, bv) == jfss.max_block_nnz(
        rp, n, bv)
    for natural in (1, 7, 8, 9, 7643):
        assert tfss.round_e_blk(natural) == jfss.round_e_blk(natural)
    via = convert.blocked_csr_from_numpy(
        want.vertex_block, *(np.asarray(getattr(want, a))
                             for a in ("row_off", "deg", "col")), device="cpu")
    assert all(torch.equal(getattr(via, a), getattr(got, a))
               for a in ("row_off", "deg", "col"))
    with pytest.raises(ValueError, match="e_blk"):
        tfss.block_csr(gt.row_ptr, gt.col_idx, gt.out_deg, n,
                       vertex_block=bv,
                       e_blk=tfss.max_block_nnz(gt.row_ptr, n, bv) - 1)


def _inputs(n, N, seed, int32_min=True):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, n, N).astype(np.int32)
    die = (rng.random(N) < 0.2).astype(np.int32)
    bits = rng.integers(0, 1 << 30, N).astype(np.int32)
    if int32_min and N > 1:
        bits[1] = np.iinfo(np.int32).min
    return pos, die, bits


def _check_stream(rp, col, n, pos, die, bits, bv, fb, jbits=None):
    """The port's streamed step against the reference's Pallas stream
    kernel (interpret mode) and its oracle, byte for byte."""
    (jrp, jcol, jdeg), gt = _both(rp, col, n)
    blocked = tfss.block_csr(gt.row_ptr, gt.col_idx, gt.out_deg, n,
                             vertex_block=bv)
    got = ops.frog_step(*map(torch.from_numpy, (pos, die, bits)),
                        gt.row_ptr, gt.col_idx, gt.out_deg, n,
                        impl="stream", blocked=blocked)
    jb = jnp.asarray(bits if jbits is None else jbits)
    for impl in ("stream", "ref"):
        want = jops.frog_step(jnp.asarray(pos), jnp.asarray(die), jb, jrp,
                              jcol, jdeg, n, impl=impl, vertex_block=bv,
                              frog_block=fb)
        for a, b in zip(want, got):
            _eq(a, b)
    return got


@pytest.mark.parametrize("n,N,seed", [(16, 8, 0), (311, 1999, 3),
                                      (900, 4000, 17), (77, 3001, 50)])
def test_stream_step_matches_reference(n, N, seed):
    """Twin of ``test_stream_step.py::test_frog_step_stream_matches_ref``."""
    g = jgen.uniform_random(n, avg_out_deg=5, seed=seed)
    pos, die, bits = _inputs(n, N, seed, int32_min=False)
    _check_stream(np.asarray(g.row_ptr), np.asarray(g.col_idx), n, pos, die,
                  bits, 128, 256)


@pytest.mark.parametrize("n,N,bv,fb", [
    (513, 1025, 100, 96),        # nothing divides anything
    (97, 53, 16, 8),             # N < fb·num_vb, tiny blocks
    (300, 2000, 512, 1024),      # n < vertex_block (block shrinks to n)
    (769, 111, 64, 1024),        # N < frog_block
])
def test_stream_step_nondivisible_blocks(n, N, bv, fb):
    """Twin of ``test_stream_step.py::test_frog_step_stream_nondivisible_
    blocks``; the port's bits carry INT32_MIN, which the reference takes as
    its absolute value, itself."""
    g = jgen.uniform_random(n, avg_out_deg=6, seed=n + N)
    pos, die, bits = _inputs(n, N, n * 7 + N)
    _check_stream(np.asarray(g.row_ptr), np.asarray(g.col_idx), n, pos, die,
                  bits, bv, fb)


def test_stream_step_skewed_hub():
    """Twin of ``test_stream_step.py::test_frog_step_stream_skewed_hub``:
    every frog on the hub, whose block's slab is the widest, and empty
    vertex blocks everywhere else."""
    rp, col, _ = _hub_graph()
    N = 500
    pos = np.full(N, 123, np.int32)
    _, die, bits = _inputs(200, N, 0)
    nxt, counts = _check_stream(rp, col, 200, pos, die, bits, 32, 64)
    assert int(counts.sum()) == int(die.sum())
    assert int(counts[123]) == int(die.sum())


def _fw_slot(b, m):
    """``common.cuh:fw_slot``: ``|b| % m``, and for INT32_MIN (whose
    int32 absolute value is itself) the floor modulo of ``-2**31``."""
    r = abs(b) % m
    return m - r if b == -(1 << 31) and r else r


def _replay_kernel(pos, die, bits, seg_off, blocked):
    """The CUDA kernel's loop in Python: one work item of the schedule at a
    time, frogs of its run, the shared histogram added once."""
    num_cta, cta_vid, cta_lo = ops.stream_schedule(seg_off, pos.shape[0])
    seg_off = seg_off.numpy()
    bv, num_vb = blocked.vertex_block, blocked.num_blocks
    row_off, deg, col = (blocked.row_off.numpy(), blocked.deg.numpy(),
                         blocked.col.numpy())
    nxt = np.full(pos.shape[0], -7, np.int64)
    counts = np.zeros(num_vb * bv, np.int64)
    seen = np.zeros(pos.shape[0], np.int64)
    for c in range(num_cta):
        v = int(cta_vid[c])
        if v >= num_vb:
            continue
        lo = int(cta_lo[c])
        hi = min(lo + ops.STREAM_FROG_BLOCK, int(seg_off[v + 1]))
        hist = np.zeros(bv, np.int64)
        for f in range(lo, hi):
            p = int(pos[f])
            local = p - v * bv
            d = int(deg[v, local])
            slot = _fw_slot(int(bits[f]), d) if d > 0 else 0
            nxt[f] = col[v, row_off[v, local] + slot] if d > 0 else p
            hist[local] += int(die[f])
            seen[f] += 1
        counts[v * bv:(v + 1) * bv] += hist
    assert (seen == 1).all(), "every sorted frog in exactly one work item"
    return nxt, counts


@pytest.mark.parametrize("n,N,bv", [(600, 5000, 64), (3000, 2600, 16),
                                    ("hub", 4100, 32)])
def test_stream_kernel_schedule_covers_every_frog(n, N, bv):
    """The kernel's work items (runs cut at STREAM_FROG_BLOCK frogs, spare
    items idle) replayed in Python give the plain version's outputs, with
    runs longer than one item, empty blocks and bits = INT32_MIN."""
    if n == "hub":
        rp, col, _ = _hub_graph()
        n = 200
        gt = convert.graph_from_numpy(n, rp, col, device="cpu")
        pos = np.where(np.arange(N) % 3 == 0, 123,
                       np.arange(N) % n).astype(np.int32)
        _, die, bits = _inputs(n, N, 1)
    else:
        gt = tgen.uniform_random(n, avg_out_deg=4, seed=n)
        pos, die, bits = _inputs(n // 2, N, n)     # upper blocks empty
    blocked = tfss.blocked_csr_of(gt, bv)
    tpos = torch.from_numpy(pos)
    pos_s, order = torch.sort(tpos, stable=True)
    seg_off = torch.searchsorted(
        pos_s, torch.arange(blocked.num_blocks + 1, dtype=torch.int32) * bv,
        out_int32=True)
    die_s = torch.from_numpy(die)[order]
    bits_s = torch.from_numpy(bits)[order]
    want = kref.frog_step_stream_sorted_ref(pos_s, die_s, bits_s.abs(),
                                            seg_off, blocked.row_off,
                                            blocked.deg, blocked.col)
    nxt, counts = _replay_kernel(pos_s.numpy(), die_s.numpy(),
                                 bits_s.numpy(), seg_off, blocked)
    assert (nxt == want[0].numpy()).all()
    assert (counts == want[1].numpy()).all()


@pytest.mark.parametrize("N,t,seed", [(1, 1, 0), (3000, 4, 11),
                                      (4097, 12, 9)])
def test_frogwild_stream_byte_equal(N, t, seed):
    """The batch walk under ``"stream"`` against the reference's stream and
    oracle runs (twin of ``test_stream_step.py::test_frogwild_run_stream_
    equals_ref``), and against the port's resident walk."""
    gj = jgen.chung_lu_powerlaw(900, 8.0, seed=3)
    gt = tgen.chung_lu_powerlaw(900, 8.0, seed=3)
    got = tfrogwild(gt, FrogWildConfig(num_frogs=N, num_steps=t,
                                                step_impl="stream"),
                             seed=seed, device="cpu")
    for impl in ("stream", "ref"):
        want = jfrogwild(gj, JFrogWildConfig(num_frogs=N, num_steps=t,
                                             step_impl=impl), seed=seed)
        _eq(want.counts, got.counts)
        _eq(want.pi_hat, got.pi_hat)
    resident = tfrogwild(gt, FrogWildConfig(num_frogs=N,
                                                     num_steps=t),
                                  seed=seed, device="cpu")
    assert torch.equal(resident.counts, got.counts)
    assert int(got.counts.sum()) == N


def test_service_pagerank_and_index_build_under_stream():
    """``pagerank`` equals the reference's under ``"stream"``; the index
    built under ``"stream"`` equals the reference's slab built with the XLA
    step, whose own ``"stream"`` build raises on its traced graph."""
    gj = jgen.chung_lu_powerlaw(500, 6.0, seed=1)
    gt = tgen.chung_lu_powerlaw(500, 6.0, seed=1)
    sc = dict(segments_per_vertex=8, segment_len=3, build_shards=3)
    sj = jservice.FrogWildService.open(gj, JRuntimeConfig(
        kernel=JKernelConfig(step_impl="stream"),
        serving=JServingConfig(**sc)))
    st = FrogWildService.open(gt, RuntimeConfig(
        kernel=KernelConfig(step_impl="stream"),
        serving=ServingConfig(**sc)), device="cpu")
    for kw in (dict(epsilon=0.3, k=10), dict(epsilon=0.2, k=5, seed=4)):
        _eq(sj.pagerank(**kw).counts, st.pagerank(**kw).counts)
    assert st.blocked_csr() is st.blocked_csr()      # built once, kept
    icfg = dict(segments_per_vertex=8, segment_len=3, num_shards=3)
    want = jindex._build_walk_index(gj, JWalkIndexConfig(step_impl="xla",
                                                         **icfg))
    _eq(want.endpoints, st.ensure_index().endpoints)
    fresh = FrogWildService.open(gt, st.config, device="cpu")
    fresh.ensure_index()
    blocked = fresh._blocked               # the build made the layout ...
    assert blocked is not None
    fresh.pagerank(epsilon=0.3, k=10)      # ... and pagerank reuses it
    assert fresh.blocked_csr() is blocked
    _eq(want.endpoints, tservice.build_index(
        gt, WalkIndexConfig(step_impl="stream", **icfg),
        device="cpu").endpoints)
    with pytest.raises(ValueError, match="prebuilt BlockedCSR"):
        jindex._build_walk_index(gj, JWalkIndexConfig(step_impl="stream",
                                                      **icfg))


def test_stream_config_and_operands():
    assert tconfig.KernelConfig(step_impl="stream").step_impl == "stream"
    with pytest.raises(ValueError, match="stitch_impl"):
        tconfig.KernelConfig(stitch_impl="stream")
    g = tgen.uniform_random(50, 4.0, seed=0)
    pos = torch.zeros(10, dtype=torch.int32)
    small = tfss.block_csr(g.row_ptr[:21], g.col_idx, g.out_deg[:20], 20,
                           vertex_block=8)
    with pytest.raises(ValueError, match="covers 24 vertices"):
        ops.frog_step(pos, pos, pos, g.row_ptr, g.col_idx, g.out_deg, g.n,
                      impl="stream", blocked=small)
    blocked = tfss.blocked_csr_of(g, 8)
    seg = torch.zeros(blocked.num_blocks + 1, dtype=torch.int32)
    sched = ops.stream_schedule(seg, 10)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.frog_step_stream_sorted(pos, pos, pos, seg, sched, blocked,
                                    impl="cuda")
    with pytest.raises(ValueError, match="seg_off"):
        ops.frog_step_stream_sorted(pos, pos, pos, seg[1:], sched, blocked)
    before = ops.launch_counts()
    ops.frog_step(pos, pos, pos, g.row_ptr, g.col_idx, g.out_deg, g.n,
                  impl="stream")                  # CPU: the plain version
    assert ops.launch_counts() == before
