"""The port's kernels.

On the CPU: each plain version (``repro_torch.kernels.ref``, what the
wrappers run for CPU tensors) against the reference's Pallas kernel in
interpret mode (``repro.kernels.ops``, ``impl="pallas"``) and its oracle
(``impl="ref"``), byte for byte, at ragged sizes, with degree-0 vertices,
padding sentinels, negative bits and all-0 / all-1 tallies.

On the card (marker ``cuda``, skipped elsewhere): each CUDA kernel against
its plain version on the same CUDA tensors, byte for byte (the ELL SpMV's
float spill tail and power iteration within a stated tolerance), a refused
launch raising, the sharded and streamed service against the dense,
resident one, and the erasure walks against the CPU's. This file
imports JAX only inside the reference comparisons, so the card tests run
where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref


def _jops():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return jnp, jops


def _graph(n=37, seed=0):
    """A CSR with degree-0 vertices (first, middle and last)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 6, n)
    deg[[0, n // 2, n - 1]] = 0
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = rng.integers(0, n, int(row_ptr[-1])).astype(np.int32)
    return row_ptr, col_idx, deg.astype(np.int32)


def _walkers(N, n, mode, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, n, N).astype(np.int32)
    bits = rng.integers(-(1 << 31), 1 << 31, N, dtype=np.int64)
    bits = bits.astype(np.int32)
    if N:
        bits[0] = np.iinfo(np.int32).min        # abs() stays negative
    flag = {"random": rng.integers(0, 2, N), "zeros": np.zeros(N),
            "ones": np.ones(N)}[mode].astype(np.int32)
    return pos, flag, bits


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


MODES = ["random", "zeros", "ones"]


@pytest.mark.parametrize("N", [1, 1000, 1537])
@pytest.mark.parametrize("mode", MODES)
def test_frog_step_plain_matches_pallas(N, mode):
    jnp, jops = _jops()
    row_ptr, col_idx, deg = _graph()
    n = deg.shape[0]
    pos, die, bits = _walkers(N, n, mode)
    got_next, got_counts = ops.frog_step(*_t(pos, die, bits, row_ptr,
                                             col_idx, deg), n)
    for impl in ("pallas", "ref"):
        want_next, want_counts = jops.frog_step(
            *map(jnp.asarray, (pos, die, bits, row_ptr, col_idx, deg)), n,
            impl=impl, vertex_block=16, frog_block=256)
        assert (got_next.numpy() == np.asarray(want_next)).all(), impl
        assert (got_counts.numpy() == np.asarray(want_counts)).all(), impl
    assert got_next.dtype == got_counts.dtype == torch.int32


@pytest.mark.parametrize("N", [1, 999, 2048])
def test_frog_count_plain_matches_pallas(N):
    jnp, jops = _jops()
    n = 300
    rng = np.random.default_rng(N)
    dest = rng.integers(-3, n + 3, N).astype(np.int32)   # strays ignored
    got = ops.frog_count(*_t(dest), n)
    for impl in ("pallas", "ref", "sort"):
        want = jops.frog_count(jnp.asarray(dest), n, impl=impl,
                               vertex_block=64, frog_block=512)
        assert (got.numpy() == np.asarray(want)).all(), impl
    assert int(got.sum()) == int(((dest >= 0) & (dest < n)).sum())


@pytest.mark.parametrize("W", [1, 700, 1029])
@pytest.mark.parametrize("mode", MODES)
def test_stitch_plain_matches_pallas(W, mode):
    jnp, jops = _jops()
    n, R = 50, 6
    rng = np.random.default_rng(W)
    endpoints = rng.integers(0, n, (n, R)).astype(np.int32)
    pos, stop, bits = _walkers(W, n, mode, seed=W)
    tpos, tstop, tbits, tend = _t(pos, stop, bits, endpoints)
    got_next, got_counts = ops.stitch_step(tpos, tstop, tbits, tend, n)
    got_gather, none = ops.stitch_step(tpos, tstop, tbits, tend, n,
                                       tally=False)
    assert none is None
    assert torch.equal(got_gather, ops.stitch_gather(tpos, tbits, tend))
    args = [jnp.asarray(a) for a in (pos, stop, bits, endpoints)]
    for impl in ("pallas", "ref"):
        want_next, want_counts = jops.stitch_step(
            *args, n, impl=impl, vertex_block=16, walk_block=256)
        want_gather, _ = jops.stitch_step(*args, n, impl=impl, tally=False,
                                          walk_block=256)
        assert (got_next.numpy() == np.asarray(want_next)).all(), impl
        assert (got_counts.numpy() == np.asarray(want_counts)).all(), impl
        assert (got_gather.numpy() == np.asarray(want_gather)).all(), impl


def test_wrappers_refuse_bad_operands():
    row_ptr, col_idx, deg = _t(*_graph())
    n = deg.shape[0]
    pos, die, bits = _t(*_walkers(10, n, "random"))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.frog_step(pos, die, bits, row_ptr, col_idx, deg, n, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.frog_count(pos, n, impl="pallas")
    with pytest.raises(TypeError, match="int32"):
        ops.frog_count(pos.long(), n)
    with pytest.raises(ValueError, match="elements"):
        ops.frog_step(pos, die[:5], bits, row_ptr, col_idx, deg, n)
    with pytest.raises(ValueError, match="row_ptr"):
        ops.frog_step(pos, die, bits, row_ptr[:-1], col_idx, deg, n)
    with pytest.raises(ValueError, match="contiguous"):
        ops.stitch_gather(pos, bits, torch.zeros(4, n, dtype=torch.int32).t())
    before = ops.launch_counts()
    ops.frog_count(pos, n)                      # CPU: the plain version
    assert ops.launch_counts() == before


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 1537, 300_001])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_frog_step_matches_plain(cuda, N, mode):
    row_ptr, col_idx, deg = [t.to(cuda) for t in _t(*_graph(4099))]
    n = deg.shape[0]
    pos, die, bits = [t.to(cuda) for t in _t(*_walkers(N, n, mode))]
    before = ops.launch_counts()["frog_step"]
    got = ops.frog_step(pos, die, bits, row_ptr, col_idx, deg, n)
    assert ops.launch_counts()["frog_step"] == before + 1
    want = kref.frog_step_ref(pos, die, torch.abs(bits), row_ptr, col_idx,
                              deg, n)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 8192, 1_000_003])
def test_cuda_frog_count_matches_plain(cuda, N):
    n = 9 * 4099
    g = torch.Generator().manual_seed(N)
    dest = torch.randint(-5, n + 5, (N,), generator=g,
                         dtype=torch.int32).to(cuda)
    got = ops.frog_count(dest, n, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, kref.frog_count_ref(dest, n))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 8192, 100_003])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_stitch_matches_plain(cuda, W, mode):
    n, R = 4099, 16
    g = torch.Generator().manual_seed(W)
    endpoints = torch.randint(0, n, (n, R), generator=g,
                              dtype=torch.int32).to(cuda)
    pos, stop, bits = [t.to(cuda) for t in _t(*_walkers(W, n, mode, W))]
    got = ops.stitch_step(pos, stop, bits, endpoints, n)
    want = kref.stitch_step_ref(pos, stop, torch.abs(bits), endpoints, n)
    gather = ops.stitch_gather(pos, bits, endpoints)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(gather, want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("W,q_max,R,S,lost_shards", [
    (1, 8, 16, 1, None), (8192, 8, 16, 1, None), (8192, 8, 16, 8, (3,)),
    (8192, 8, 16, 8, ()), (100_003, 5, 7, 4, (0, 2)), (777, 0, 16, 1, None),
    (1000, 16, 3, 3, (2,))])
def test_cuda_stitch_gather_rounds_matches_plain(cuda, W, q_max, R, S,
                                                 lost_shards):
    """The wave's rounds in one launch against the plain round loop, byte
    for byte: ``q`` past ``q_max`` and 0, slot offsets over the whole int32
    range (``s0 + j`` wrapping, INT32_MIN and INT32_MAX), a stacked slab
    with padding rows, no mask, an all-False mask and lost shards."""
    n = 4099
    g = torch.Generator().manual_seed(W + q_max + S)
    sz = -(-n // S)
    slab = torch.randint(0, n, (S * sz, R), generator=g, dtype=torch.int32)
    pos = torch.randint(0, n, (W,), generator=g, dtype=torch.int32)
    q = torch.randint(0, q_max + 2, (W,), generator=g, dtype=torch.int32)
    s0 = torch.randint(-2 ** 31, 2 ** 31, (W,), generator=g,
                       dtype=torch.int64).to(torch.int32)
    s0[0] = 2 ** 31 - 1
    s0[-1] = -2 ** 31
    lost = None
    if lost_shards is not None:
        lost = torch.zeros(S, dtype=torch.bool)
        lost[list(lost_shards)] = True
        lost = lost.to(cuda)
    pos, q, s0, slab = (t.to(cuda) for t in (pos, q, s0, slab))
    before = ops.launch_counts()["stitch_gather_rounds"]
    got = ops.stitch_gather_rounds(pos, q, s0, slab, q_max, lost, S, sz)
    assert ops.launch_counts()["stitch_gather_rounds"] == before + 1
    want = kref.stitch_gather_rounds_ref(pos, q, s0, slab, q_max, lost, S,
                                         sz)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    if lost is None:
        assert got[1] is None and want[1] is None
    else:
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("W,q_max,R,S,lost_shards", [
    (1, 8, 16, 1, None), (8192, 8, 16, 8, None), (8192, 8, 16, 8, (3,)),
    (8192, 8, 16, 8, ()), (100_003, 5, 7, 4, (0, 2)), (777, 0, 16, 3, None),
    (1000, 16, 3, 3, (2,))])
def test_cuda_stitch_gather_local_rounds_matches_plain(cuda, W, q_max, R, S,
                                                       lost_shards):
    """The loop wave's rounds over S blocks in one launch against the plain
    per-round, per-shard sum, byte for byte: each block a separate
    allocation and a lost shard's table entry a null pointer (never read),
    walks in the last shard and walks no shard owns, ``q`` past ``q_max``
    and 0, slot offsets over the whole int32 range."""
    n = 4099
    g = torch.Generator().manual_seed(W + q_max + S)
    sz = -(-n // S)
    blocks = [torch.randint(0, n, (sz, R), generator=g,
                            dtype=torch.int32).to(cuda) for _ in range(S)]
    pos = torch.randint(0, n, (W,), generator=g, dtype=torch.int32)
    pos[::7] = -3                                  # owned by no shard
    pos[1::11] = S * sz + 5
    pos[2::13] = n - 1                             # the last shard
    q = torch.randint(0, q_max + 2, (W,), generator=g, dtype=torch.int32)
    s0 = torch.randint(-2 ** 31, 2 ** 31, (W,), generator=g,
                       dtype=torch.int64).to(torch.int32)
    s0[0] = 2 ** 31 - 1
    s0[-1] = -2 ** 31
    lost = None
    if lost_shards is not None:
        lost = torch.zeros(S, dtype=torch.bool)
        lost[list(lost_shards)] = True
        lost = lost.to(cuda)
        for s in lost_shards:
            blocks[s] = None
    table = ops.block_table(blocks)
    assert all((int(p) == 0) == (b is None)
               for p, b in zip(table.ptrs.cpu(), blocks))
    pos, q, s0 = (t.to(cuda) for t in (pos, q, s0))
    before = ops.launch_counts()["stitch_gather_local_rounds"]
    got = ops.stitch_gather_local_rounds(pos, q, s0, table, q_max, lost)
    assert ops.launch_counts()["stitch_gather_local_rounds"] == before + 1
    want = kref.stitch_gather_local_rounds_ref(pos, q, s0, blocks, q_max,
                                               lost)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    if lost is None:
        assert got[1] is None and want[1] is None
    else:
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("W,num_rounds,R", [
    (1, 8, 16), (4445, 8, 16), (8192, 0, 16), (100_003, 5, 7),
    (1000, 16, 3)])
def test_cuda_stitch_step_rounds_matches_plain(cuda, W, num_rounds, R):
    """``walk_wave``'s rounds and their stop tally in one launch against
    the plain round loop, byte for byte: ``q`` from 0 past
    ``num_rounds``, slot offsets over the whole int32 range."""
    n = 4099
    g = torch.Generator().manual_seed(W + num_rounds)
    endpoints = torch.randint(0, n, (n, R), generator=g, dtype=torch.int32)
    pos = torch.randint(0, n, (W,), generator=g, dtype=torch.int32)
    q = torch.randint(0, num_rounds + 3, (W,), generator=g,
                      dtype=torch.int32)
    s0 = torch.randint(-2 ** 31, 2 ** 31, (W,), generator=g,
                       dtype=torch.int64).to(torch.int32)
    s0[0] = 2 ** 31 - 1
    s0[-1] = -2 ** 31
    pos, q, s0, endpoints = (t.to(cuda) for t in (pos, q, s0, endpoints))
    before = ops.launch_counts()["stitch_step_rounds"]
    got = ops.stitch_step_rounds(pos, q, s0, endpoints, n, num_rounds)
    assert ops.launch_counts()["stitch_step_rounds"] == before + 1
    want = kref.stitch_step_rounds_ref(pos, q, s0, endpoints, n, num_rounds)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) == int((q <= num_rounds).sum())


@pytest.mark.cuda
def test_cuda_loop_wave_and_query_counts_one_launch(cuda):
    """The loop wave launches ``stitch_gather_local_rounds`` once a wave
    (and ``stitch_gather_local`` never), ``query_counts`` launches
    ``stitch_step_rounds`` once (and ``stitch_step`` never); both answers
    equal the CPU's byte for byte."""
    from repro_torch import (FrogWildService, RuntimeConfig, ServingConfig,
                             ShardConfig, prng)
    from repro_torch.graph import chung_lu_powerlaw
    from repro_torch.query.engine import plan_query, query_counts
    g = chung_lu_powerlaw(3000, 8.0, seed=1)
    S = 4
    rc = RuntimeConfig(runtime=ShardConfig(num_shards=S),
                       serving=ServingConfig(
                           sharded_dispatch="loop", segments_per_vertex=8,
                           segment_len=3, build_shards=3, max_walks=1024,
                           max_queries=4, max_steps=16))
    out = {}
    for dev in (cuda, "cpu"):
        svc = FrogWildService.open(g, rc, device=dev)
        dense = svc.ensure_index().reassemble()
        ops.reset_launch_counts()
        handles = [svc.topk(k=10), svc.ppr(5, k=5)]
        answers = [(h.result().vertices, h.result().scores)
                   for h in handles]
        serve = ops.launch_counts()
        waves = svc.scheduler.stats().waves_run
        plan = plan_query(10, 0.3, 0.1, p_T=rc.p_T, max_steps=16,
                          segments_per_vertex=8, segment_len=3)
        ops.reset_launch_counts()
        counts = query_counts(svc.graph, dense, plan,
                              prng.PRNGKey(7, svc.graph.device))
        single = ops.launch_counts()
        out[str(dev)] = (answers, counts.cpu(), serve, single, waves)
    answers, counts, serve, single, waves = out[str(cuda)]
    assert waves >= 1
    # one launch a draw (the slot offsets drawn in the rounds kernels):
    # the scheduler's split, wave_prep's three splits, start randint,
    # length uniform and L = 3 residual randints; query_counts' the same
    # but the scheduler's split
    assert serve == {**{k: 0 for k in serve},
                     "stitch_gather_local_rounds": waves,
                     "frog_count": S * waves, "threefry_split": 4 * waves,
                     "threefry_randint": 4 * waves,
                     "threefry_uniform": waves}
    assert single == {**{k: 0 for k in single}, "stitch_step_rounds": 1,
                      "threefry_split": 3, "threefry_randint": 4,
                      "threefry_uniform": 1}
    assert torch.equal(counts, out["cpu"][1])
    for (va, sa), (vb, sb) in zip(answers, out["cpu"][0]):
        assert (va == vb).all() and (sa == sb).all()


@pytest.mark.cuda
def test_cuda_walk_lengths_equal_cpu_for_every_uniform(cuda):
    """All 2**23 float32 values ``uniform`` can return give the same walk
    length on the card as on the CPU (and so as in the reference)."""
    from repro_torch.query.engine import lengths_from_uniform
    k = torch.arange(1 << 23, dtype=torch.int32)
    u = (k | 0x3F800000).view(torch.float32) - 1.0
    cpu = lengths_from_uniform(u, 0.15, 32)
    gpu = lengths_from_uniform(u.to(cuda), 0.15, 32).cpu()
    assert torch.equal(cpu, gpu)


@pytest.mark.cuda
def test_cuda_service_matches_plain_path(cuda):
    """The whole slice on a small graph: kernels on the card against the
    plain versions on the card, byte for byte."""
    from repro_torch import (FrogWildService, KernelConfig, RuntimeConfig,
                             ServingConfig)
    from repro_torch.graph import chung_lu_powerlaw
    g = chung_lu_powerlaw(3000, 8.0, seed=1)
    serving = ServingConfig(segments_per_vertex=8, segment_len=3,
                            build_shards=3, max_walks=1024, max_queries=4,
                            max_steps=16)
    out = {}
    for impl in ("auto", "torch"):
        rc = RuntimeConfig(kernel=KernelConfig(step_impl=impl,
                                               stitch_impl=impl,
                                               tally_impl=impl),
                           serving=serving)
        svc = FrogWildService.open(g, rc, device=cuda)
        res = svc.pagerank(epsilon=0.3, k=10)
        handles = [svc.topk(k=10), svc.ppr(5, k=5), svc.topk(k=5)]
        out[impl] = (res.counts.cpu(), svc.ensure_index().endpoints.cpu(),
                     [(h.result().vertices, h.result().scores)
                      for h in handles])
    a, b = out["auto"], out["torch"]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for (va, sa), (vb, sb) in zip(a[2], b[2]):
        assert (va == vb).all() and (sa == sb).all()


def _hub_csr(n, hub, hub_deg, seed=0):
    """A CSR with degree-0 vertices and one vertex of ``hub_deg`` edges."""
    row_ptr, col_idx, deg = _graph(n, seed)
    deg = deg.astype(np.int64)
    deg[hub] = hub_deg
    rng = np.random.default_rng(seed + 1)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = rng.integers(0, n, int(row_ptr[-1])).astype(np.int32)
    return row_ptr, col_idx, deg.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 1537, 300_001])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_frog_step_stream_matches_plain(cuda, N, mode):
    """The streamed superstep on the card against the plain version and
    the resident kernel; frogs on the lower half of the vertices leave the
    upper vertex blocks empty."""
    from repro_torch.kernels.frog_step_stream import block_csr
    row_ptr, col_idx, deg = [t.to(cuda) for t in _t(*_graph(4099))]
    n = deg.shape[0]
    blocked = block_csr(row_ptr, col_idx, deg, n)
    pos, die, bits = [t.to(cuda) for t in _t(*_walkers(N, n // 2, mode))]
    before = ops.launch_counts()["frog_step_stream_sorted"]
    got = ops.frog_step(pos, die, bits, row_ptr, col_idx, deg, n,
                        impl="stream", blocked=blocked)
    assert ops.launch_counts()["frog_step_stream_sorted"] == before + 1
    want = kref.frog_step_ref(pos, die, torch.abs(bits), row_ptr, col_idx,
                              deg, n)
    resident = ops.frog_step(pos, die, bits, row_ptr, col_idx, deg, n)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, resident))


@pytest.mark.cuda
@pytest.mark.parametrize("hub_deg", [20_000, 40_000])
def test_cuda_frog_step_stream_hub_block(cuda, hub_deg):
    """A hub block whose slab needs more than 48 KB of shared memory
    (20,000 edges: staged after raising the launch's limit) or more than
    the launch stages (40,000 edges: col read from device memory)."""
    from repro_torch.kernels.frog_step_stream import block_csr
    row_ptr, col_idx, deg = [t.to(cuda)
                             for t in _t(*_hub_csr(4099, 700, hub_deg))]
    n = deg.shape[0]
    blocked = block_csr(row_ptr, col_idx, deg, n)
    staged = 4 * blocked.e_blk <= ops.STREAM_SMEM_COL_BYTES
    assert staged == (hub_deg == 20_000) and 4 * blocked.e_blk > 48 * 1024
    for N, mode in ((5000, "random"), (70_000, "ones")):
        pos, die, bits = [t.to(cuda) for t in _t(*_walkers(N, n, mode))]
        pos[: N // 2] = 700                        # half the frogs on the hub
        got = ops.frog_step(pos, die, bits, row_ptr, col_idx, deg, n,
                            impl="stream", blocked=blocked)
        want = kref.frog_step_ref(pos, die, torch.abs(bits), row_ptr,
                                  col_idx, deg, n)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), N


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 8192, 100_003])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_stitch_local_matches_plain(cuda, W, mode):
    """Per-shard gather and stitch round against their plain versions, with
    walks no shard owns; summed over the shards, equal to stitch_step."""
    n, R, S = 4099, 16, 4
    sz = -(-n // S)
    g = torch.Generator().manual_seed(W)
    slab = torch.zeros(S * sz, R, dtype=torch.int32)
    slab[:n] = torch.randint(0, n, (n, R), generator=g, dtype=torch.int32)
    slab = slab.to(cuda)
    pos, stop, bits = [t.to(cuda) for t in _t(*_walkers(W, n, mode, W))]
    stray = pos.clone()
    stray[::7] = -3                                # owned by no shard
    sum_next = torch.zeros_like(pos)
    sum_counts = []
    for s in range(S):
        block = slab[s * sz:(s + 1) * sz]
        before = ops.launch_counts()
        got = ops.stitch_step_local(pos, stop, bits, block, s * sz)
        gather = ops.stitch_gather_local(stray, bits, block, s * sz)
        after = ops.launch_counts()
        assert after["stitch_step_local"] == before["stitch_step_local"] + 1
        assert (after["stitch_gather_local"]
                == before["stitch_gather_local"] + 1)
        want = kref.stitch_step_local_ref(pos, stop, torch.abs(bits), block,
                                          s * sz)
        want_g = kref.stitch_gather_local_ref(stray, torch.abs(bits), block,
                                              s * sz)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), s
        assert torch.equal(gather, want_g), s
        sum_next += got[0]
        sum_counts.append(got[1])
    whole = ops.stitch_step(pos, stop, bits, slab[:n], n)
    torch.cuda.synchronize()
    assert torch.equal(sum_next, whole[0])
    assert torch.equal(torch.cat(sum_counts)[:n], whole[1])


@pytest.mark.cuda
def test_cuda_sharded_streamed_service_matches_dense(cuda):
    """S = 4 sharded serving (fused and loop) with the streamed superstep
    against the dense, resident service on the card, byte for byte."""
    from repro_torch import (FrogWildService, KernelConfig, RuntimeConfig,
                             ServingConfig, ShardConfig)
    from repro_torch.graph import chung_lu_powerlaw
    g = chung_lu_powerlaw(3000, 8.0, seed=1)
    serving = dict(segments_per_vertex=8, segment_len=3, build_shards=3,
                   max_walks=1024, max_queries=4, max_steps=16)
    out = {}
    for name, shards, step, dispatch in (
            ("dense", 1, "auto", "fused"), ("fused", 4, "stream", "fused"),
            ("loop", 4, "stream", "loop")):
        rc = RuntimeConfig(kernel=KernelConfig(step_impl=step),
                           runtime=ShardConfig(num_shards=shards),
                           serving=ServingConfig(sharded_dispatch=dispatch,
                                                 **serving))
        svc = FrogWildService.open(g, rc, device=cuda)
        res = svc.pagerank(epsilon=0.3, k=10)
        index = svc.ensure_index()
        slab = (index.endpoints if shards == 1
                else index.blocks.reshape(-1, 8)[:g.n])
        handles = [svc.topk(k=10), svc.ppr(5, k=5), svc.topk(k=5)]
        out[name] = (res.counts.cpu(), slab.cpu(),
                     [(h.result().vertices, h.result().scores)
                      for h in handles])
    a = out["dense"]
    for name in ("fused", "loop"):
        b = out[name]
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), name
        for (va, sa), (vb, sb) in zip(a[2], b[2]):
            assert (va == vb).all() and (sa == sb).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 16, 32, 40])
@pytest.mark.parametrize("rows", [1, 1003, 300_001])
def test_cuda_spmv_ell_slab_matches_plain(cuda, K, rows):
    """The slab kernel against its plain version byte for byte: ragged row
    counts (a last warp with fewer than 32 rows), x ~ N(0, 1) (negative
    values), zero-weight padded lanes, full 32-lane chunks and a partial
    one (K = 8, and K = 40's second chunk); operands at an offset view."""
    g = torch.Generator().manual_seed(rows * K)
    n = 4099
    idx = torch.randint(0, n, (rows, K), generator=g, dtype=torch.int32)
    w = torch.randn(rows, K, generator=g)
    w[torch.rand(rows, K, generator=g) < 0.3] = 0.0
    x = torch.randn(n, generator=g)
    idx, w, x = idx.to(cuda), w.to(cuda), x.to(cuda)
    before = ops.launch_counts()["spmv_ell_slab"]
    got = ops.spmv_ell_slab(idx, w, x)
    assert ops.launch_counts()["spmv_ell_slab"] == before + 1
    # an operand 4 bytes off its allocation's alignment: the same bytes
    w_odd = torch.empty(rows * K + 1, device=cuda)[1:].view(rows, K)
    w_odd.copy_(w)
    odd = ops.spmv_ell_slab(idx, w_odd, x)
    torch.cuda.synchronize()
    want = kref.spmv_ref(idx, w, x)
    assert torch.equal(got, want) and torch.equal(odd, want)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 32, 40])
@pytest.mark.parametrize("rows", [1, 1003, 300_001])
def test_cuda_spmv_ell_slab_live_lanes_match_plain(cuda, K, rows):
    """With ``row_len`` the kernel reads each row's live prefix only and
    is byte-equal to the plain version, which reads every lane: rows of
    length 0 and K, padded lanes of weight 0 and id 0 as ``to_ell`` lays
    them out, x ~ N(0, 1) with a finite x[0], ragged row counts."""
    g = torch.Generator().manual_seed(rows * K + 1)
    n = 4099
    row_len = torch.randint(0, K + 1, (rows,), generator=g,
                            dtype=torch.int32)
    row_len[::7] = 0
    row_len[1::5] = K
    idx = torch.randint(0, n, (rows, K), generator=g, dtype=torch.int32)
    w = torch.randn(rows, K, generator=g)
    padded = torch.arange(K)[None, :] >= row_len[:, None]
    idx[padded], w[padded] = 0, 0.0
    x = torch.randn(n, generator=g)
    idx, w, x, row_len = (t.to(cuda) for t in (idx, w, x, row_len))
    before = ops.launch_counts()["spmv_ell_slab"]
    got = ops.spmv_ell_slab(idx, w, x, row_len=row_len)
    every = ops.spmv_ell_slab(idx, w, x)
    assert ops.launch_counts()["spmv_ell_slab"] == before + 2
    torch.cuda.synchronize()
    want = kref.spmv_ref(idx, w, x)
    assert torch.equal(got, want) and torch.equal(every, want)


@pytest.mark.cuda
def test_cuda_spmv_with_large_spill_close_to_plain(cuda):
    """A hub row that spills 19,980 in-edges: the layout and the slab are
    byte-equal to the CPU's. The spill's float atomics add the hub's terms
    in any order; 20 shuffles of that order on the CPU moved the whole
    product by up to 5.2e-5 and the 50-iteration ELL power iteration by up
    to 0.77 of rtol=1e-5, atol=1e-7, so both are held to 4× and 13× those
    spreads: rtol=1e-5, atol=2e-4 and rtol=1e-4, atol=1e-7."""
    from repro_torch.core import power_iteration
    from repro_torch.graph import build_csr, to_ell
    n = 20_003
    rng = np.random.default_rng(0)
    src = np.concatenate([np.arange(n), rng.integers(0, n, 8 * n)])
    dst = np.concatenate([np.full(n, 7), rng.integers(0, n, 8 * n)])
    g = build_csr(n, src, dst)
    ell_cpu = to_ell(g, K=32)
    ell = to_ell(g.to(cuda), K=32)
    assert ell.spill_nnz == ell_cpu.spill_nnz > n - 32
    for f in ("idx", "valid", "weight", "spill_src", "spill_dst", "spill_w",
              "row_len"):
        assert torch.equal(getattr(ell, f).cpu(), getattr(ell_cpu, f)), f
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = kref.spmv_ref(ell_cpu.idx, ell_cpu.weight, x)
    assert torch.equal(ops.spmv_ell_slab(ell.idx, ell.weight, x.to(cuda))
                       .cpu(), want)
    assert torch.equal(ops.spmv_ell_slab(ell.idx, ell.weight, x.to(cuda),
                                         row_len=ell.row_len).cpu(), want)
    np.testing.assert_allclose(ops.spmv(ell, x.to(cuda)).cpu().numpy(),
                               ops.spmv(ell_cpu, x).numpy(), rtol=1e-5,
                               atol=2e-4)
    before = ops.launch_counts()["spmv_ell_slab"]
    pi = power_iteration(g.to(cuda), num_iters=50, spmv="ell")
    assert ops.launch_counts()["spmv_ell_slab"] == before + 50
    np.testing.assert_allclose(
        pi.cpu().numpy(), power_iteration(g, num_iters=50, spmv="ell").numpy(),
        rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
def test_cuda_refused_launch_raises(cuda):
    """A launch the card refuses (a grid of 2**31 blocks, one more than
    the limit) raises from the wrapper's launch; the kernel never runs, so
    its null operands are never read. (``stitch_gather`` one block per 256
    walks; the slab product's grid is persistent and never that large.)"""
    with pytest.raises(RuntimeError, match="stitch_gather: kernel launch "
                                           "failed with CUDA error"):
        ops._launch("stitch_gather", cuda, 0, 0, 0, 0, 0, 1 << 39, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["independent", "channel"])
@pytest.mark.parametrize("draw", ["rejection", "cumsum", "auto"])
def test_cuda_erasure_walk_equals_cpu(cuda, model, draw):
    """The erasure walk on the card gives the CPU's counts byte for byte
    (it does no float work); the frog_count kernel tallies its deaths."""
    from repro_torch import (FrogWildService, KernelConfig, RuntimeConfig,
                             ShardConfig)
    from repro_torch.graph import chung_lu_powerlaw
    g = chung_lu_powerlaw(3000, 8.0, seed=1)
    rc = RuntimeConfig(num_frogs=20_000, num_steps=9, p_s=0.7, erasure=model,
                       kernel=KernelConfig(draw=draw),
                       runtime=ShardConfig(num_shards=16))
    before = ops.launch_counts()["frog_count"]
    got = FrogWildService.open(g, rc, device=cuda).pagerank(seed=3)
    assert ops.launch_counts()["frog_count"] == before + 10
    want = FrogWildService.open(g, rc, device="cpu").pagerank(seed=3)
    assert torch.equal(got.counts.cpu(), want.counts)
    assert torch.equal(got.pi_hat.cpu(), want.pi_hat)


# --- the walker step that draws its own bits (rng="device") -----------------

DRAW_ENTRY = {("superstep", "auto"): "frog_superstep",
              ("superstep", "stream"): "frog_superstep_stream_sorted",
              ("hop", "auto"): "frog_hop",
              ("hop", "stream"): "frog_hop_stream_sorted"}
# the kernel of a build's, repair's or refresh's segment walk: one launch
# a walk, or under "stream" one a hop and one frog_segment_masks a walk
SEGMENT_ENTRY = {"auto": "frog_segment_walk",
                 "stream": "frog_hop_stream_sorted"}


def _draw_graph(cuda, hub_deg=None):
    """``_graph(4099)`` (degree-0 vertices), or ``_hub_csr`` with vertex
    700 of ``hub_deg`` edges, on the card with its slab layout."""
    from repro_torch.kernels.frog_step_stream import block_csr
    arrays = _graph(4099) if hub_deg is None else _hub_csr(4099, 700,
                                                           hub_deg)
    row_ptr, col_idx, deg = [t.to(cuda) for t in _t(*arrays)]
    n = deg.shape[0]
    return row_ptr, col_idx, deg, n, block_csr(row_ptr, col_idx, deg, n)


def _set_col_staging(monkeypatch, stage):
    if not stage:       # no slab fits: every CTA reads col from memory
        monkeypatch.setattr(ops, "STREAM_SMEM_COL_BYTES", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [0, 1, 1537, 300_001])
@pytest.mark.parametrize("impl,stage", [
    ("auto", True), ("stream", True), ("stream", False)])
def test_cuda_frog_superstep_matches_plain(cuda, monkeypatch, N, impl,
                                           stage):
    """Eight supersteps in place (p_T = 0.3, a third of the frogs dead at
    the start), each one launch, against the plain version on the same CUDA
    tensors: pos, alive and counts byte for byte; the streamed kernel with
    its col slab staged and not."""
    from repro_torch import prng
    _set_col_staging(monkeypatch, stage)
    row_ptr, col_idx, deg, n, blocked = _draw_graph(cuda)
    rng = np.random.default_rng(N)
    pos = torch.from_numpy(rng.integers(0, n, N).astype(np.int32)).to(cuda)
    alive = torch.from_numpy(rng.random(N) < 0.67).to(cuda)
    counts = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(
        cuda)
    got = [pos.clone(), alive.clone(), counts.clone()]
    want = (pos, alive, counts)
    name = DRAW_ENTRY[("superstep", impl)]
    for step_key in prng.split(prng.PRNGKey(N, cuda), 8):
        before = ops.launch_counts()[name]
        ops.frog_superstep(*got, step_key, 0.3, row_ptr, col_idx, deg, n,
                           impl=impl, blocked=blocked)
        assert ops.launch_counts()[name] == before + (N > 0)
        want = kref.frog_superstep_ref(*want, step_key, 0.3, row_ptr,
                                       col_idx, deg, n)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[2].sum() - counts.sum()) + int(got[1].sum()) == \
        int(alive.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,R", [(0, 16), (1, 16), (606, 16),
                                    (20_011, 7), (300, 300)])
@pytest.mark.parametrize("impl,stage", [
    ("auto", True), ("stream", True), ("stream", False)])
def test_cuda_frog_hop_matches_plain(cuda, monkeypatch, rows, R, impl, stage):
    """Four hops of ``rows`` index rows of ``R`` walks in place, each one
    launch, against the plain version: walk counts that are not multiples
    of 256, R not dividing 256 and R above 256, row keys with words past
    2**31."""
    from repro_torch import prng
    _set_col_staging(monkeypatch, stage)
    row_ptr, col_idx, deg, n, blocked = _draw_graph(cuda)
    vertices = torch.arange(rows, dtype=torch.int32, device=cuda) * 7 % n
    row_keys = prng.fold_in(prng.PRNGKey(rows + R, cuda), vertices)
    got = torch.repeat_interleave(vertices, R)
    want = got.clone()
    name = DRAW_ENTRY[("hop", impl)]
    for step in range(4):
        before = ops.launch_counts()[name]
        ops.frog_hop(got, row_keys, step, R, row_ptr, col_idx, deg, n,
                     impl=impl, blocked=blocked)
        assert ops.launch_counts()[name] == before + (rows > 0)
        want = kref.frog_hop_ref(want, row_keys, step, R, row_ptr, col_idx,
                                 deg)
        torch.cuda.synchronize()
        assert torch.equal(got, want), step


@pytest.mark.cuda
@pytest.mark.parametrize("hub_deg", [20_000, 40_000])
def test_cuda_draw_stream_hub_block(cuda, hub_deg):
    """The streamed draw kernels on a hub block whose slab needs more than
    48 KB of shared memory (staged after raising each kernel's limit) or
    more than a launch stages."""
    from repro_torch import prng
    row_ptr, col_idx, deg, n, blocked = _draw_graph(cuda, hub_deg)
    N = 70_000
    pos = torch.full((N,), 700, dtype=torch.int32, device=cuda)
    pos[N // 2:] = torch.arange(N - N // 2, device=cuda) % n
    alive = torch.ones(N, dtype=torch.bool, device=cuda)
    counts = torch.zeros(n, dtype=torch.int32, device=cuda)
    key = prng.PRNGKey(hub_deg, cuda)
    got = [pos.clone(), alive.clone(), counts.clone()]
    ops.frog_superstep(*got, key, 0.15, row_ptr, col_idx, deg, n,
                       impl="stream", blocked=blocked)
    want = kref.frog_superstep_ref(pos, alive, counts, key, 0.15, row_ptr,
                                   col_idx, deg, n)
    R = 10
    row_keys = prng.fold_in(key, torch.arange(N // R, device=cuda))
    hop = pos.clone()
    ops.frog_hop(hop, row_keys, 2, R, row_ptr, col_idx, deg, n,
                 impl="stream", blocked=blocked)
    want_hop = kref.frog_hop_ref(pos, row_keys, 2, R, row_ptr, col_idx, deg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(hop, want_hop)


@pytest.mark.cuda
@pytest.mark.parametrize("step_impl", ["auto", "stream"])
def test_cuda_walks_one_launch_per_superstep_and_hop(cuda, step_impl):
    """The batch walk launches its step kernel once a superstep and the
    index build once a hop of each build shard, and nothing else of the
    walker's; both answers equal the CPU's byte for byte."""
    from repro_torch import (FrogWildService, KernelConfig, RuntimeConfig,
                             ServingConfig)
    from repro_torch.graph import chung_lu_powerlaw
    from repro_torch.query.engine import plan_query
    g = chung_lu_powerlaw(3000, 8.0, seed=4)
    rc = RuntimeConfig(kernel=KernelConfig(step_impl=step_impl),
                       serving=ServingConfig(segments_per_vertex=8,
                                             segment_len=3, build_shards=3))
    t = plan_query(10, 0.3, 0.1, p_T=rc.p_T,
                   max_steps=rc.serving.max_steps).num_steps
    out = {}
    for dev in (cuda, "cpu"):
        svc = FrogWildService.open(g, rc, device=dev)
        if step_impl == "stream":
            svc.blocked_csr()
        ops.reset_launch_counts()
        res = svc.pagerank(epsilon=0.3, k=10)
        walk = ops.launch_counts()
        ops.reset_launch_counts()
        slab = svc.ensure_index().endpoints
        build = ops.launch_counts()
        out[str(dev)] = (res.counts.cpu(), slab.cpu(), walk, build)
    counts, slab, walk, build = out[str(cuda)]
    step = DRAW_ENTRY[("superstep", step_impl)]
    # the walk's two splits and start randint, and one fold_in of the row
    # keys a build shard, each one launch; the resident build one segment
    # walk a build shard, the streamed one a sorted hop a hop, one mask
    # pass and two fold_in draws of every hop's keys a build shard
    assert walk == {**{k: 0 for k in walk}, step: t, "frog_count": 1,
                    "threefry_split": 2, "threefry_randint": 1}
    streamed = step_impl == "stream"
    extra = ({"frog_segment_masks": 3, "threefry_fold_in": 3 + 3 * 2}
             if streamed else {"threefry_fold_in": 3})
    assert build == {**{k: 0 for k in build},
                     SEGMENT_ENTRY[step_impl]: 3 * (3 if streamed else 1),
                     **extra}
    assert torch.equal(counts, out["cpu"][0])
    assert torch.equal(slab, out["cpu"][1])
    assert sum(out["cpu"][2].values()) == sum(out["cpu"][3].values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,args", [
    ("frog_superstep", (0, 0, 0, 0, 0.15, 0, 0, 0, 1 << 39)),
    ("frog_hop", (0, 0, 0, 16, 0, 0, 0, 0, 0, 1, 1 << 39))])
def test_cuda_refused_draw_launch_raises(cuda, name, args):
    """A draw kernel's launch the card refuses (a grid of 2**31 blocks)
    raises from the wrapper's launch; the kernel never runs."""
    with pytest.raises(RuntimeError, match=f"{name}: kernel launch failed "
                                           f"with CUDA error"):
        ops._launch(name, cuda, *args)


@pytest.mark.cuda
def test_cuda_rebuild_shard_blocks_equal_cpu(cuda):
    """A repair's re-walk on the card: each named shard one
    ``frog_segment_walk`` launch and no ``frog_hop``, the blocks and their
    masks (the last shard's padding rows included) byte-equal to the
    CPU's."""
    from repro_torch.config import WalkIndexConfig
    from repro_torch.graph import chung_lu_powerlaw
    from repro_torch.query.index import rebuild_shard_blocks
    g = chung_lu_powerlaw(3001, 8.0, seed=2)
    cfg = WalkIndexConfig(segments_per_vertex=8, segment_len=3,
                          num_shards=4, seed=9)
    ops.reset_launch_counts()
    got = rebuild_shard_blocks(g.to(cuda), cfg, [1, 3])
    assert ops.launch_counts()["frog_segment_walk"] == 2
    assert ops.launch_counts()["frog_hop"] == 0
    want = rebuild_shard_blocks(g, cfg, [1, 3])
    for s in (1, 3):
        assert torch.equal(got[s][0].cpu(), want[s][0])
        assert torch.equal(got[s][1].view(torch.int32).cpu(),
                           want[s][1].view(torch.int32))
    assert got[3][0][-3:].cpu().tolist() == [[3001 + i] * 8
                                             for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,R,L", [(1, 16, 4), (606, 16, 4),
                                      (20_011, 7, 3), (300, 300, 2),
                                      (513, 16, 1)])
@pytest.mark.parametrize("impl,stage", [
    ("auto", True), ("stream", True), ("stream", False)])
def test_cuda_frog_hop_masks_match_plain(cuda, monkeypatch, rows, R, L,
                                         impl, stage):
    """The hops of an L-step segment walk recording the visited-block
    masks (hops 0 … L − 2), each one launch, against the plain version:
    positions and masks byte for byte after every hop, hop 0 overwriting
    every word of a row that held garbage, L = 1 leaving every row
    zero."""
    from repro_torch import prng
    _set_col_staging(monkeypatch, stage)
    row_ptr, col_idx, deg, n, blocked = _draw_graph(cuda)
    vertices = torch.arange(rows, dtype=torch.int32, device=cuda) * 7 % n
    row_keys = prng.fold_in(prng.PRNGKey(rows + R, cuda), vertices)
    got = torch.repeat_interleave(vertices, R)
    want = got.clone()
    vis = torch.full((got.shape[0], kref.MASK_WORDS), -1, dtype=torch.int32,
                     device=cuda).view(torch.uint32)
    want_vis = vis.view(torch.int32).clone()
    bs = kref.segment_mask_block_size(n)
    name = DRAW_ENTRY[("hop", impl)]
    for step in range(L):
        before = ops.launch_counts()[name]
        ops.frog_hop(got, row_keys, step, R, row_ptr, col_idx, deg, n,
                     impl=impl, blocked=blocked, visited=vis,
                     record=step < L - 1)
        assert ops.launch_counts()[name] == before + 1
        want = kref.frog_hop_ref(want, row_keys, step, R, row_ptr, col_idx,
                                 deg)
        want_vis = kref.hop_visits(want_vis, want, step, step < L - 1, bs)
        torch.cuda.synchronize()
        assert torch.equal(got, want), step
        assert torch.equal(vis.view(torch.int32), want_vis), step
    assert bool(want_vis.any()) == (L > 1)


@pytest.mark.cuda
def test_cuda_sorted_hop_mask_skips_blocks_past_the_mask(cuda):
    """``frog_hop_stream_sorted`` and the mask pass after it with one id a
    block: a vertex whose block is past the mask's 256 sets no bit, as in
    the plain version (the reference's padding rows)."""
    from repro_torch import prng
    row_ptr, col_idx, deg, n, blocked = _draw_graph(cuda)
    R = 8
    vertices = torch.arange(0, n, 3, dtype=torch.int32, device=cuda)
    row_keys = prng.fold_in(prng.PRNGKey(5, cuda), vertices)
    pos = torch.repeat_interleave(vertices, R)
    got, want = pos.clone(), pos.clone()
    vis = torch.empty(pos.shape[0], kref.MASK_WORDS, dtype=torch.uint32,
                      device=cuda)
    _, pos_s, order, seg_off, sched = ops._sorted_runs(
        "test", pos, row_ptr, col_idx, deg, n, blocked)
    ops.frog_hop_stream_sorted(pos_s, order, got, row_keys, 0, R, seg_off,
                               sched, blocked)
    ops.frog_segment_masks(got[None], vis, 1)
    want = kref.frog_hop_ref(want, row_keys, 0, R, row_ptr, col_idx, deg)
    want_vis = kref.hop_visits(None, want, 0, True, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(vis.view(torch.int32), want_vis)
    assert bool((want >= 256).any()) and not bool(
        want_vis[want >= 256].any())


@pytest.mark.cuda
@pytest.mark.parametrize("step_impl,shards", [("auto", 1), ("stream", 4)])
def test_cuda_refresh_equals_rebuild(cuda, step_impl, shards):
    """``apply_mutations`` and ``refresh_walk_index`` on the card: the
    stale set and the refreshed slab (endpoints and masks, dense or 4
    serving blocks) equal a rebuild on the card at the new epoch and the
    CPU's refresh; each chunk one segment walk (resident: one launch;
    streamed: a sorted hop a hop and one mask pass)."""
    from repro_torch.config import WalkIndexConfig
    from repro_torch.dynamic import (MutationBatch, apply_mutations,
                                     invalidate_segments,
                                     refresh_walk_index)
    from repro_torch.graph import chung_lu_powerlaw
    from repro_torch.query import index as tindex
    g = chung_lu_powerlaw(3000, 8.0, seed=5)
    cfg = WalkIndexConfig(segments_per_vertex=8, segment_len=3,
                          num_shards=3, seed=2, step_impl=step_impl)
    window = range(1500, 1530)
    batch = MutationBatch.edges(
        insert=[(v, (v * 7 + 13) % g.n) for v in window],
        delete=[(v, int(g.successors(v)[0])) for v in window[::3]])
    out = {}
    for dev in (cuda, "cpu"):
        gd = g.to(dev)
        idx = tindex._build_walk_index(gd, cfg)
        if shards > 1:
            idx = tindex.shard_walk_index(idx, shards)
        g2, changed = apply_mutations(gd, batch)
        assert g2.device == gd.device
        stale = invalidate_segments(idx, changed)
        ops.reset_launch_counts()
        new, report = refresh_walk_index(idx, g2, changed,
                                         step_impl=step_impl, chunk=1000)
        launches = ops.launch_counts()
        full = tindex._build_walk_index(g2, cfg)
        if shards > 1:
            full = tindex.shard_walk_index(full, shards)
        ep = new.blocks if shards > 1 else new.endpoints
        full_ep = full.blocks if shards > 1 else full.endpoints
        assert torch.equal(ep, full_ep)
        assert torch.equal(new.visited_blocks.view(torch.int32),
                           full.visited_blocks.view(torch.int32))
        out[str(dev)] = (stale.cpu(), ep.cpu(),
                         new.visited_blocks.view(torch.int32).cpu(), report,
                         launches)
    stale, ep, vb, report, launches = out[str(cuda)]
    assert torch.equal(stale, out["cpu"][0])
    assert torch.equal(ep, out["cpu"][1]) and torch.equal(vb, out["cpu"][2])
    assert report == out["cpu"][3]
    assert 0 < report.stale_rows < g.n
    streamed = step_impl == "stream"
    chunks = -(-report.stale_rows // 1000)
    assert launches[SEGMENT_ENTRY[step_impl]] == \
        (3 if streamed else 1) * chunks, launches
    assert launches["frog_hop"] == 0, launches
    assert launches["frog_segment_masks"] == \
        (chunks if streamed else 0), launches


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["fused", "loop"])
def test_cuda_degraded_waves_equal_cpu(cuda, dispatch):
    """A service that loses shard 2 at wave 1: the degraded answers, their
    provenance and bounds on the card equal the CPU's, and the fault log
    too."""
    from repro_torch import (FrogWildService, RuntimeConfig, ServingConfig,
                             ShardConfig)
    from repro_torch.distributed.faults import FaultPlan
    from repro_torch.graph import chung_lu_powerlaw
    g = chung_lu_powerlaw(3000, 8.0, seed=1)
    rc = RuntimeConfig(runtime=ShardConfig(num_shards=4),
                       serving=ServingConfig(
                           sharded_dispatch=dispatch, segments_per_vertex=8,
                           segment_len=3, build_shards=3, max_walks=1024,
                           max_queries=4, max_steps=16),
                       faults=FaultPlan(shard_losses=((1, 2),)))
    out = {}
    for dev in (cuda, "cpu"):
        svc = FrogWildService.open(g, rc, device=dev)
        rs = [h.result() for h in (svc.topk(k=10, num_walks=3000),
                                   svc.ppr(5, k=5, num_walks=2000))]
        out[str(dev)] = ([(r.vertices.tobytes(), r.scores.tobytes(),
                           r.num_walks, r.walks_lost, r.shards_lost,
                           r.epsilon_bound) for r in rs],
                         [(e.kind, e.wave, e.shard) for e in svc.fault_log])
        assert all(r.degraded and r.walks_lost > 0 for r in rs)
    assert out[str(cuda)] == out["cpu"]


@pytest.mark.cuda
def test_cuda_degraded_local_rounds_make_no_host_sync(cuda):
    """The loop wave's rounds over a table whose lost shard's entry is
    null: with the mask's host copy the call reads nothing back from the
    card (the sync guard raises on any read), and equals the plain
    version."""
    S, sz, R, W, q_max = 4, 500, 8, 4096, 6
    gen = torch.Generator().manual_seed(3)
    blocks = [torch.randint(0, S * sz, (sz, R), generator=gen,
                            dtype=torch.int32).to(cuda) for _ in range(S)]
    blocks[1] = None
    lost_host = [False, True, False, False]
    lost = torch.tensor(lost_host, device=cuda)
    pos, q, s0 = (torch.randint(0, hi, (W,), generator=gen,
                                dtype=torch.int32).to(cuda)
                  for hi in (S * sz, q_max + 1, 2 ** 30))
    table = ops.block_table(blocks)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.stitch_gather_local_rounds(pos, q, s0, table, q_max, lost,
                                             lost_host=lost_host)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = kref.stitch_gather_local_rounds_ref(pos, q, s0, blocks, q_max,
                                               lost)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool(got[1].all())


# --- the threefry draws and the stitch kernels' rng="device" ----------------

DRAW_SIZES = [0, 1, 1023, 1025, 2 ** 20 + 3]


def _draw_cases(key, size):
    """``(kernel name, draw(impl))`` of every ``prng`` draw at ``size``
    elements a key."""
    from repro_torch import prng
    data = torch.arange(size, device=key.device) - size // 2
    return [
        ("threefry_bits", lambda impl: prng.random_bits(key, (size,), impl)),
        ("threefry_randint", lambda impl: prng.randint(key, (size,), 0,
                                                       1 << 30, impl)),
        ("threefry_randint", lambda impl: prng.randint(key, (size,), 0,
                                                       4_847_571, impl)),
        ("threefry_uniform", lambda impl: prng.uniform(key, (size,), impl)),
        ("threefry_bernoulli", lambda impl: prng.bernoulli(key, 0.15,
                                                           (size,), impl)),
        ("threefry_split", lambda impl: prng.split(key, size, impl)),
        ("threefry_fold_in", lambda impl: prng.fold_in(key, data, impl)),
    ]


def _same(got, want):
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("size", DRAW_SIZES)
def test_cuda_draws_match_plain(cuda, size):
    """Each draw on a CUDA key is one launch of its kernel (none when
    empty), byte-equal to the plain torch version on the same key, its
    dtype and shape included."""
    from repro_torch import prng
    key = prng.PRNGKey(size + 17, cuda)
    for name, draw in _draw_cases(key, size):
        before = ops.launch_counts()[name]
        got = draw("auto")
        assert ops.launch_counts()[name] == before + (1 if size else 0)
        assert _same(got, draw("torch")), (name, size)
        assert ops.launch_counts()[name] == before + (1 if size else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [(5,), (3, 4)])
def test_cuda_draws_batched_keys_match_plain(cuda, batch):
    """Batched keys (``[5, 2]``, ``[3, 4, 2]``): every draw gains the batch
    dimensions in front; ``fold_in`` with a scalar, with one datum a key
    and with data broadcast against the batch."""
    from repro_torch import prng
    keys = prng.split(prng.PRNGKey(3, cuda), math.prod(batch)).reshape(
        batch + (2,))
    per_key = torch.arange(math.prod(batch), dtype=torch.int32,
                           device=cuda).reshape(batch) - 7
    wide = torch.arange(6, device=cuda).reshape((6,) + (1,) * len(batch))
    for shape in [(7,), (3, 5), (0,)]:
        for draw in (lambda i: prng.random_bits(keys, shape, i),
                     lambda i: prng.randint(keys, shape, -3, 1000, i),
                     lambda i: prng.randint(keys, shape, 0, 1 << 30, i),
                     lambda i: prng.uniform(keys, shape, i),
                     lambda i: prng.bernoulli(keys, 0.7, shape, i)):
            got = draw("cuda")
            assert got.shape == batch + shape
            assert _same(got, draw("torch"))
    for draw in (lambda i: prng.split(keys, 3, i),
                 lambda i: prng.fold_in(keys, 11, i),
                 lambda i: prng.fold_in(keys, per_key, i),
                 lambda i: prng.fold_in(keys, wide, i)):
        assert _same(draw("cuda"), draw("torch"))


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [
    (0, 1), (0, 2), (0, 65_536), (0, 65_537), (0, 1 << 30), (0, 4_847_571),
    (-5, 100), (-(1 << 31), (1 << 31) - 1), (10, 10), (10, 3)])
def test_cuda_randint_spans_match_plain(cuda, lo, hi):
    """``randint`` over spans that keep and drop the high stream (2**16 and
    2**16 + 1), a negative ``minval``, the whole int32 range and ``maxval ≤
    minval``."""
    from repro_torch import prng
    for seed in (0, 2 ** 32 - 1):
        key = prng.PRNGKey(seed, cuda)
        got = prng.randint(key, (4099,), lo, hi, impl="cuda")
        assert _same(got, prng.randint(key, (4099,), lo, hi, impl="torch"))
        if hi <= lo:
            assert bool((got == lo).all())


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.15, 0.7, 1.0])
def test_cuda_bernoulli_matches_plain(cuda, p):
    from repro_torch import prng
    key = prng.PRNGKey(5, cuda)
    got = prng.bernoulli(key, p, (16, 1025), impl="cuda")
    assert _same(got, prng.bernoulli(key, p, (16, 1025), impl="torch"))
    if p in (0.0, 1.0):
        assert bool((got == (p == 1.0)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cuda_fold_in_data_types_match_plain(cuda, dtype):
    """Per-element ``fold_in`` over int32 and int64 data, negatives and
    values past 2**32 (taken mod 2**32) included."""
    from repro_torch import prng
    key = prng.PRNGKey(9, cuda)
    info = torch.iinfo(dtype)
    data = torch.tensor([0, 1, -1, info.min, info.max, -12345, 2 ** 31 - 1],
                        dtype=dtype, device=cuda)
    assert _same(prng.fold_in(key, data, "cuda"),
                 prng.fold_in(key, data, "torch"))


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 2, 3, 32])
def test_cuda_split_and_categorical_match_plain(cuda, num):
    from repro_torch import prng
    key = prng.PRNGKey(num, cuda)
    assert _same(prng.split(key, num, "cuda"), prng.split(key, num, "torch"))
    logits = torch.randn(4, 128, generator=torch.Generator().manual_seed(
        num)).to(cuda)
    assert _same(prng.categorical(key, logits, "cuda"),
                 prng.categorical(key, logits, "torch"))


@pytest.mark.cuda
def test_cuda_draws_make_no_host_sync(cuda):
    """Every draw on a CUDA key, under ``set_sync_debug_mode("error")``:
    the key is read on the card, nothing comes back to the host."""
    from repro_torch import prng
    key = prng.PRNGKey(1, cuda)
    keys = prng.split(key, 6)
    data = torch.arange(100, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [draw("auto") for _, draw in _draw_cases(key, 4096)]
        outs += [prng.randint(keys, (16,), 0, 1 << 30),
                 prng.fold_in(keys[:, None], data),
                 prng.categorical(key, torch.zeros(4, 128, device=cuda))]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(o.is_cuda for o in outs)


def _stitch_device_inputs(cuda, W, n=4099, R=16, S=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    sz = -(-n // S)
    slab = torch.randint(0, n, (S * sz, R), generator=g, dtype=torch.int32)
    pos = torch.randint(0, n, (W,), generator=g, dtype=torch.int32)
    q = torch.randint(0, 10, (W,), generator=g, dtype=torch.int32)
    stop = torch.randint(0, 2, (W,), generator=g, dtype=torch.int32)
    return [t.to(cuda) for t in (slab, pos, q, stop)] + [sz]


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 8192, 100_003])
def test_cuda_stitch_device_rng_matches_caller(cuda, W):
    """Every stitch kernel under ``rng="device"`` (the wave's key in place
    of the bits) against its caller mode fed ``randint(key, (W,), 0,
    2**30)``, byte for byte, one launch each: the per-round kernels, the
    rounds kernels with and without a lost shard, and the loop wave's
    rounds over a table with the lost shard's entry null."""
    from repro_torch import prng
    slab, pos, q, stop, sz = _stitch_device_inputs(cuda, W, seed=W)
    n, S, q_max = 4099, 4, 8
    key = prng.PRNGKey(W, cuda)
    s0 = prng.randint(key, (W,), 0, 1 << 30, impl="torch")
    lost = torch.tensor([False, False, True, False], device=cuda)
    blocks = [slab[s * sz:(s + 1) * sz].clone() for s in range(S)]
    table = ops.block_table(blocks)
    holed = ops.block_table([None if s == 2 else b
                             for s, b in enumerate(blocks)])
    block, base = blocks[1], sz
    cases = {
        "stitch_gather": lambda b, m: ops.stitch_gather(pos, b, slab,
                                                        rng=m),
        "stitch_step": lambda b, m: ops.stitch_step(pos, stop, b, slab, n,
                                                    rng=m),
        "stitch_gather_local": lambda b, m: ops.stitch_gather_local(
            pos, b, block, base, rng=m),
        "stitch_step_local": lambda b, m: ops.stitch_step_local(
            pos, stop, b, block, base, rng=m),
        "stitch_gather_rounds": lambda b, m: ops.stitch_gather_rounds(
            pos, q, b, slab, q_max, rng=m),
        "stitch_step_rounds": lambda b, m: ops.stitch_step_rounds(
            pos, q, b, slab[:n], n, q_max, rng=m),
        "stitch_gather_local_rounds": lambda b, m:
            ops.stitch_gather_local_rounds(pos, q, b, table, q_max, rng=m),
    }
    lost_cases = {
        "stitch_gather_rounds": lambda b, m: ops.stitch_gather_rounds(
            pos, q, b, slab, q_max, lost, S, sz, rng=m),
        "stitch_gather_local_rounds": lambda b, m:
            ops.stitch_gather_local_rounds(
                pos, q, b, holed, q_max, lost,
                lost_host=[False, False, True, False], rng=m),
    }
    for name, call in [*cases.items(), *lost_cases.items()]:
        before = ops.launch_counts()
        got = call(key, "device")
        after = ops.launch_counts()
        assert after[name] == before[name] + 1, name
        assert all(after[k] == before[k] for k in ops.DRAW_KERNELS), name
        want = call(s0, "caller")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b), name
    # the plain version of the device mode draws s0 through prng's plain
    # version
    plain = ops.stitch_gather_rounds(pos, q, key, slab, q_max, impl="torch",
                                     rng="device")
    assert torch.equal(plain[0], cases["stitch_gather_rounds"](
        key, "device")[0])
