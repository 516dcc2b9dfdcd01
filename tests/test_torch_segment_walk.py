"""The index build's segment walk in one call (``ops.frog_segment_walk``)
and the streamed walk's mask pass (``ops.frog_segment_masks``).

On the CPU, with one numpy-seeded graph (degree-0 vertices included) and
key: the port's segment walk (its plain version, and under ``"stream"``
the sorted hops with their trail and the mask pass) is byte-equal to the
reference's ``_segment_walk_rows`` (``step_impl="xla"``) and to the
per-hop ``ops.frog_hop`` loop it replaces, endpoints and masks; the mask
pass against the reference's ``_block_one_hot``; the rows' hop keys
against the hop bits they stand for; the kernel's CTA indexing (a walk a
thread, rows split across CTAs, the key table cut into step chunks)
replayed in numpy. The ``cuda`` tests hold the kernels against their
plain versions on the card and skip without one; JAX is imported only
inside the reference comparisons.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

THREADS = 256                       # common.cuh's FW_THREADS
KEY_TABLE_BYTES = 48 * 1024         # frog_segment.cu's FW_SEGMENT_KEY_BYTES


def _graph(n, seed):
    """int32 CSR arrays of an n-vertex graph, a fifth of it degree 0."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 7, n).astype(np.int32)
    deg[rng.random(n) < 0.2] = 0
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = rng.integers(0, n, int(row_ptr[-1])).astype(np.int32)
    return row_ptr, col_idx, deg


def _vertices(n, C, seed):
    return np.random.default_rng(seed + 1).integers(0, n, C).astype(np.int32)


def _hop_loop(vertices, row_keys, R, L, graph, n, impl):
    """The walk as the build ran it before: L ``ops.frog_hop`` calls in
    place, recording hops 0 … L − 2."""
    pos = torch.repeat_interleave(vertices, R)
    vis = torch.full((pos.shape[0], kref.MASK_WORDS), -1,
                     dtype=torch.int32).view(torch.uint32)
    for step in range(L):
        ops.frog_hop(pos, row_keys, step, R, *graph, n, impl=impl,
                     visited=vis, record=step < L - 1)
    return pos.view(-1, R), vis.view(torch.int32).view(-1, R,
                                                       kref.MASK_WORDS)


@pytest.mark.parametrize("n,R,L,C", [(200, 8, 4, 150), (1999, 5, 2, 333),
                                     (1999, 3, 1, 97), (300, 4, 4, 0)])
def test_segment_walk_equals_reference_and_hop_loop(n, R, L, C):
    """n < 256 (one id a mask block) and n > 256 (8 ids), L = 1 (empty
    masks), C·R no multiple of 256, C = 0: the one-call walk, its
    streamed form and the per-hop loop byte-equal to the reference."""
    import jax
    import jax.numpy as jnp
    from repro.query import index as jindex
    row_ptr, col_idx, deg = _graph(n, n + L)
    verts = _vertices(n, C, n)
    graph = tuple(torch.from_numpy(a) for a in (row_ptr, col_idx, deg))
    vertices = torch.from_numpy(verts)
    row_keys = prng.fold_in(prng.PRNGKey(n, "cpu"), vertices)
    ep, vis = ops.frog_segment_walk(vertices, row_keys, R, L, *graph, n,
                                    impl="torch")
    assert ep.dtype == torch.int32 and ep.shape == (C, R)
    assert vis.dtype == torch.uint32 and vis.shape == (C, R, 8)
    words = vis.view(torch.int32)
    want_ep, want_vis = jindex._segment_walk_rows(
        jnp.asarray(row_ptr), jnp.asarray(col_idx), jnp.asarray(deg), n,
        "xla", R, L, jindex.segment_mask_block_size(n), jnp.asarray(verts),
        jax.random.PRNGKey(n))
    assert np.asarray(want_ep).tobytes() == ep.numpy().tobytes()
    assert np.asarray(want_vis).tobytes() == vis.numpy().tobytes()
    loop = _hop_loop(vertices, row_keys, R, L, graph, n, "torch")
    assert torch.equal(loop[0], ep) and torch.equal(loop[1], words)
    out = (torch.full_like(ep, -1), torch.full_like(words, -1).view(
        torch.uint32))
    got = ops.frog_segment_walk(vertices, row_keys, R, L, *graph, n,
                                impl="stream", out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(out[0], ep)
    assert torch.equal(out[1].view(torch.int32), words)
    assert bool(words.any()) == (L > 1 and C > 0)
    if C:       # the walks reached degree-0 vertices and stayed there
        assert bool((torch.from_numpy(deg)[ep.long()] == 0).any())


@pytest.mark.parametrize("T,accumulate", [(3, False), (1, True),
                                          (0, False)])
def test_segment_masks_equal_reference(T, accumulate):
    """The mask pass over a trail with one id a block: the OR of the
    reference's ``_block_one_hot`` rows, blocks past the mask's 256
    setting none; ``accumulate`` ORs into the old words, T = 0 leaves
    zeros; the per-hop streamed ``frog_hop`` records through it as the
    plain hop does."""
    import jax.numpy as jnp
    from repro.query import index as jindex
    rng = np.random.default_rng(T)
    N = 1000
    trail = rng.integers(0, 600, (T, N)).astype(np.int32)
    old = rng.integers(-2**31, 2**31, (N, 8)).astype(np.int32)
    vis = torch.from_numpy(old.copy()).view(torch.uint32)
    ops.frog_segment_masks(torch.from_numpy(trail), vis, 1,
                           accumulate=accumulate)
    want = old.view(np.uint32) if accumulate else np.zeros((N, 8),
                                                           np.uint32)
    for t in range(T):
        want = want | np.asarray(jindex._block_one_hot(
            jnp.asarray(trail[t]), 1, 8))
    assert want.tobytes() == vis.numpy().tobytes()
    assert T == 0 or (trail >= 256).any()
    # the per-hop form: hop 0 writes, hop 1 ORs, hop 2 records nothing
    n, R = 700, 4
    graph = tuple(torch.from_numpy(a) for a in _graph(n, 5))
    vertices = torch.from_numpy(_vertices(n, 50, 5))
    row_keys = prng.fold_in(prng.PRNGKey(T, "cpu"), vertices)
    got = _hop_loop(vertices, row_keys, R, 3, graph, n, "stream")
    assert all(torch.equal(a, b) for a, b in zip(
        got, _hop_loop(vertices, row_keys, R, 3, graph, n, "torch")))


@pytest.mark.parametrize("R", [1, 7, 16])
def test_hop_keys_draw_the_hop_bits(R):
    """The streamed hop's keys (one table a hop, or every hop's at once)
    give each walk the reference's bits with one block."""
    row_keys = prng.fold_in(prng.PRNGKey(R, "cpu"), torch.arange(40))
    steps = torch.arange(4)[:, None]
    every = kref.hop_keys(row_keys, steps)
    assert every.shape == (4, 40, 2)
    for step in range(4):
        keys = kref.hop_keys(row_keys, step)
        assert torch.equal(keys, every[step])
        assert torch.equal(kref.hop_key_bits(keys, R),
                           kref.hop_bits(row_keys, step, R))


def np_segment_cta_map(N, R, L):
    """``frog_segment_walk_kernel``'s indexing replayed CTA by CTA: each
    lane's walk (a lane past N repeats walk N − 1 and stores nothing), its
    row in the CTA's key table and its slot, the table's step chunks →
    ``(row, slot)`` of every stored walk, the (row, step) keys each CTA
    derives and the most step chunks a CTA's table took."""
    F = THREADS
    rows_max = min(F, (F + R - 2) // R + 1)
    Lc = max(1, min(L, KEY_TABLE_BYTES // (rows_max * 8)))
    row = np.full(N, -1, np.int64)
    slot = np.full(N, -1, np.int64)
    chunks = 0
    for base in range(0, N, F):
        c0 = base // R
        rows = (min(base + F, N) - 1) // R - c0 + 1
        assert rows <= rows_max
        derived = set()
        chunks = max(chunks, len(range(0, L, Lc)))
        for s0 in range(0, L, Lc):
            ns = min(Lc, L - s0)
            i = np.arange(rows * ns)
            s = i // rows
            derived |= set(zip((c0 + i - s * rows).tolist(),
                               (s0 + s).tolist()))
        assert derived == {(c, s) for c in range(c0, c0 + rows)
                           for s in range(L)}
        f0 = base + np.arange(THREADS)
        f = np.minimum(f0, N - 1)
        c = f // R
        lrow = c - c0
        assert ((0 <= lrow) & (lrow < rows)).all()
        stored = f0 < N
        assert (row[f0[stored]] == -1).all()
        row[f0[stored]] = c[stored]
        slot[f0[stored]] = (f - c * R)[stored]
    return row, slot, chunks


@pytest.mark.parametrize("N,R,L,chunks", [
    (1, 1, 4, 1), (255, 1, 4, 1), (256, 1, 1, 1), (3000, 1, 30, 2),
    (257, 1, 49, 3), (513, 2, 48, 2), (2049, 7, 4, 1), (1000, 3, 5, 1),
    (4096, 16, 4, 1), (2560, 16, 25, 1), (769, 255, 3, 1),
    (1024, 256, 2, 1), (1025, 257, 2, 1), (5000, 300, 2, 1),
    (20_000, 1000, 1, 1)])
def test_segment_walk_cta_indexing(N, R, L, chunks):
    """Every walk stored once, at its row and slot, from a CTA that
    derived every key it reads: the last CTA's tail, rows split across
    CTAs, R at and above a CTA's walks, and a key table cut into step
    chunks (R = 1 from L = 25 on, R = 2 from L = 48 on)."""
    row, slot, got_chunks = np_segment_cta_map(N, R, L)
    f = np.arange(N)
    assert (row == f // R).all() and (slot == f % R).all()
    assert got_chunks == chunks


def test_segment_walk_checks_its_operands():
    n = 50
    graph = tuple(torch.from_numpy(a) for a in _graph(n, 1))
    vertices = torch.arange(4, dtype=torch.int32)
    row_keys = prng.fold_in(prng.PRNGKey(0, "cpu"), vertices)
    with pytest.raises(ValueError, match="L must be"):
        ops.frog_segment_walk(vertices, row_keys, 2, 0, *graph, n)
    with pytest.raises(ValueError, match="out must be"):
        ops.frog_segment_walk(vertices, row_keys, 2, 3, *graph, n,
                              out=(torch.empty(4, 3, dtype=torch.int32),
                                   torch.empty(4, 2, 8,
                                               dtype=torch.uint32)))
    with pytest.raises(ValueError, match="row_keys"):
        ops.frog_segment_walk(vertices, row_keys[:3], 2, 3, *graph, n)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.frog_segment_walk(vertices, row_keys, 2, 3, *graph, n,
                              impl="cuda")
    before = ops.launch_counts()
    ops.frog_segment_walk(vertices, row_keys, 2, 3, *graph, n)
    assert ops.launch_counts() == before        # the CPU launches nothing


def test_graphs_keep_the_degree_the_kernel_reads(tmp_path):
    """The kernel reads a degree as ``row_ptr[v + 1] − row_ptr[v]``, not
    ``deg[v]``: every way the port makes a ``CSRGraph`` (a generator, a
    mutation batch with its dangling repair, a saved and loaded graph)
    keeps ``out_deg == diff(row_ptr)``, and on such a graph the plain walk
    reads the same from either."""
    from repro_torch.dynamic import MutationBatch, apply_mutations
    from repro_torch.graph import generators, load_graph, save_graph
    g = generators.uniform_random(300, 3.0, seed=4)
    v = 5
    g2, changed = apply_mutations(g, MutationBatch.edges(
        delete=[(v, int(d)) for d in g.successors(v)],
        insert=[(7, 8), (7, 9)]))
    assert v in changed and g2.out_deg[v] == 1          # repaired
    g3 = load_graph(save_graph(str(tmp_path / "g"), g2))
    for h in (g, g2, g3, g2.to("cpu")):
        assert h.out_deg.dtype == torch.int32
        assert torch.equal(h.out_deg, torch.diff(h.row_ptr))
    vertices = torch.arange(0, 300, 3, dtype=torch.int32)
    row_keys = prng.fold_in(prng.PRNGKey(1, "cpu"), vertices)
    want = kref.frog_segment_walk_ref(vertices, row_keys, 4, 4, g2.row_ptr,
                                      g2.col_idx, g2.out_deg, g2.n)
    got = kref.frog_segment_walk_ref(vertices, row_keys, 4, 4, g2.row_ptr,
                                     g2.col_idx, torch.diff(g2.row_ptr),
                                     g2.n)
    assert all(torch.equal(x, y) for x, y in zip(want, got))


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


def _card_graph(cuda, n=4099):
    from repro_torch.kernels.frog_step_stream import block_csr
    row_ptr, col_idx, deg = (torch.from_numpy(a).to(cuda)
                             for a in _graph(n, 3))
    return (row_ptr, col_idx, deg), block_csr(row_ptr, col_idx, deg, n)


@pytest.mark.cuda
@pytest.mark.parametrize("C,R,L", [(0, 16, 4), (1, 16, 4), (606, 16, 4),
                                   (20_011, 7, 3), (300, 300, 2),
                                   (513, 16, 1), (3001, 1, 30),
                                   (1025, 2, 49)])
def test_cuda_segment_walk_matches_plain(cuda, C, R, L):
    """One ``frog_segment_walk`` launch against the plain version:
    endpoints and masks byte for byte over output rows that held garbage,
    walk counts that leave the last CTA's tail, rows split across CTAs, R
    above a CTA's walks, a key table cut into step chunks (R = 1, L = 30;
    R = 2, L = 49)."""
    graph, _ = _card_graph(cuda)
    n = graph[2].shape[0]
    vertices = (torch.arange(C, dtype=torch.int32, device=cuda) * 7) % n
    row_keys = prng.fold_in(prng.PRNGKey(C + R, cuda), vertices)
    out = (torch.full((C, R), -1, dtype=torch.int32, device=cuda),
           torch.full((C, R, 8), -1, dtype=torch.int32,
                      device=cuda).view(torch.uint32))
    before = ops.launch_counts()["frog_segment_walk"]
    ops.frog_segment_walk(vertices, row_keys, R, L, *graph, n, out=out)
    assert ops.launch_counts()["frog_segment_walk"] == before + (C > 0)
    want = kref.frog_segment_walk_ref(vertices, row_keys, R, L, *graph, n)
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0])
    assert torch.equal(out[1].view(torch.int32), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("C,R,L", [(606, 16, 4), (20_011, 7, 3),
                                   (513, 16, 1)])
def test_cuda_streamed_segment_walk_matches_plain(cuda, C, R, L):
    """The streamed walk: L sorted hops (their keys drawn once a walk) and
    one mask pass, against the plain segment walk."""
    graph, blocked = _card_graph(cuda)
    n = graph[2].shape[0]
    vertices = (torch.arange(C, dtype=torch.int32, device=cuda) * 5) % n
    row_keys = prng.fold_in(prng.PRNGKey(C, cuda), vertices)
    ops.reset_launch_counts()
    got = ops.frog_segment_walk(vertices, row_keys, R, L, *graph, n,
                                impl="stream", blocked=blocked)
    launches = ops.launch_counts()
    assert launches["frog_hop_stream_sorted"] == L
    assert launches["frog_segment_masks"] == 1
    assert launches["frog_segment_walk"] == launches["frog_hop"] == 0
    want = kref.frog_segment_walk_ref(vertices, row_keys, R, L, *graph, n)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("T,accumulate", [(3, False), (1, True),
                                          (0, False)])
def test_cuda_segment_masks_match_plain(cuda, T, accumulate):
    """The mask pass on the card, one id a block (blocks past 256 set no
    bit), over rows that held garbage."""
    g = torch.Generator().manual_seed(T)
    N = 70_001
    trail = torch.randint(0, 600, (T, N), generator=g,
                          dtype=torch.int32).to(cuda)
    old = torch.randint(-2**31, 2**31 - 1, (N, 8), generator=g,
                        dtype=torch.int32).to(cuda)
    vis = old.clone().view(torch.uint32)
    ops.frog_segment_masks(trail, vis, 1, accumulate=accumulate)
    want = kref.frog_segment_masks_ref(trail, 1, old if accumulate else None)
    torch.cuda.synchronize()
    assert torch.equal(vis.view(torch.int32), want)


@pytest.mark.cuda
def test_cuda_refused_segment_walk_raises(cuda):
    """A launch the card refuses (a grid of 2**31 blocks) raises from the
    wrapper's launch."""
    with pytest.raises(RuntimeError, match="frog_segment_walk: kernel "
                                           "launch failed with CUDA error"):
        ops._launch("frog_segment_walk", cuda, 0, 0, 16, 4, 0, 0, 0, 0, 1,
                    1 << 39)
