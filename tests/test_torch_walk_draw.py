"""The walker step that draws its own bits (``rng="device"``) on the CPU.

``ops.frog_superstep`` and ``ops.frog_hop`` launch one CUDA kernel a
superstep or a hop, which computes the reference's threefry streams itself
(``kernels/csrc/threefry.cuh``). The card tests hold the kernels against
the plain versions; here:

* the derivations the kernels rely on, over many keys (words at and above
  2**31 included): ``randint(k, ·, 0, 2**30)`` is ``split(k)[1]``'s bits
  masked to 30 bits, the bernoulli coin is the mantissa trick, and the
  index rows draw ``fold_in(row key, step)``'s stream at counter ``r``;
* the kernels' arithmetic written once in numpy ``uint32`` (threefry, the
  per-CTA key sharing, the per-frog formula, and the streamed kernel's work
  items with the original index as counter), equal to ``prng``'s tensors
  and to the plain versions;
* the new entries' plain versions, driven as the batch walk and the index
  build drive them (resident and ``"stream"``, and beside them the
  caller-bits ``ops.frog_step`` on ``prng``'s draws), byte-equal to ``repro``'s walk counts and slab, with every
  frog dead before ``t``, degree-0 vertices and frog counts that are not
  multiples of 256.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from repro.config import FrogWildConfig as JFrogWildConfig
from repro.config import WalkIndexConfig as JWalkIndexConfig
from repro.core import frogwild as _jfw_mod  # noqa: F401
from repro.graph.csr import CSRGraph as JCSRGraph
from repro.query import index as jindex
from repro_torch import convert, prng
from repro_torch.config import FrogWildConfig, WalkIndexConfig
from repro_torch.kernels import frog_step_stream as tfss
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.query import index as tindex

jfw = sys.modules["repro.core.frogwild"]
tfw = sys.modules["repro_torch.core.frogwild"]

M30 = (1 << 30) - 1
THREADS = 256                      # common.cuh's FW_THREADS


def _keys(count, seed):
    """``count`` keys of uniform uint32 words, the first few at the edges
    (0, 2**31 - 1, 2**31, 2**32 - 1)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (count, 2), dtype=np.int64)
    edge = np.array([[0, 0], [2**31 - 1, 2**31], [2**31, 2**32 - 1],
                     [2**32 - 1, 0]], np.int64)
    words[: len(edge)] = edge[:count]
    return torch.from_numpy(words)


# --- the kernels' arithmetic in numpy uint32 --------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def np_threefry(k0, k1, x0, x1):
    """``threefry.cuh:fw_threefry2x32`` over broadcast uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def np_split(k, i):
    return np_threefry(k[0], k[1], 0, i)


def np_bits(k, ctr):
    ctr = np.asarray(ctr, np.uint64)
    y0, y1 = np_threefry(k[0], k[1], (ctr >> np.uint64(32)).astype(np.uint32),
                         (ctr & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return y0 ^ y1


def np_randint30(k_lo, ctr):
    return (np_bits(k_lo, ctr) & np.uint32(M30)).astype(np.int32)


def np_bernoulli(k, p, ctr):
    f = ((np_bits(k, ctr) >> np.uint32(9)) | np.uint32(0x3F800000))
    return f.view(np.float32) - np.float32(1.0) < np.float32(p)


def np_step_keys(step_key):
    """``fw_step_keys``: ``(split(k, 0), split(split(k, 1), 1))``."""
    return np_split(step_key, 0), np_split(np_split(step_key, 1), 1)


def np_hop_key(row_key, step):
    return np_split(np_split(row_key, step), 1)


def np_slot(bits, d):
    """``common.cuh:fw_slot`` for non-negative bits: ``bits % d``."""
    return bits.astype(np.int64) % np.maximum(d, 1)


def np_successor(p, bits, row_ptr, col_idx, deg):
    d = deg[p]
    edge = row_ptr[p].astype(np.int64) + np_slot(bits, d)
    return np.where(d > 0, col_idx[np.where(d > 0, edge, 0)], p)


def np_superstep(pos, alive, counts, step_key, p_T, row_ptr, col_idx, deg):
    """``frog_superstep_kernel`` frog by frog (vectorised): a dead frog is
    skipped, a live one draws its coin at counter ``f``, dies and is
    tallied, or moves with its slot bits at counter ``f``."""
    k_die, k_lo = np_step_keys(step_key)
    f = np.arange(pos.shape[0])
    dies = alive & np_bernoulli(k_die, p_T, f)
    moves = alive & ~dies
    counts = counts + np.bincount(pos[dies], minlength=counts.shape[0])
    nxt = np_successor(pos, np_randint30(k_lo, f), row_ptr, col_idx, deg)
    return (np.where(moves, nxt, pos).astype(np.int32), alive & ~dies,
            counts.astype(np.int32))


def np_hop_cta_bits(row_keys, step, R, N):
    """``frog_hop_kernel``'s per-CTA key sharing, replayed CTA by CTA: the
    CTA's first row ``c0``, each thread's local row and slot, the rows the
    CTA derives (at most 256), and each walk's bits from its row's shared
    key."""
    bits = np.full(N, -1, np.int64)
    for f0 in range(0, N, THREADS):
        c0 = f0 // R
        r0 = f0 - c0 * R
        cnt = min(THREADS, N - f0)
        rows = (r0 + cnt - 1) // R + 1
        assert rows <= THREADS
        shared = [np_hop_key(row_keys[c0 + i], step) for i in range(rows)]
        for tid in range(cnt):
            lrow = (r0 + tid) // R
            r = r0 + tid - lrow * R
            assert lrow < rows and (c0 + lrow, r) == divmod(f0 + tid, R)
            bits[f0 + tid] = np_randint30(shared[lrow], r)
    return bits.astype(np.int32)


# --- the derivations --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randint30_is_the_low_stream_masked(seed):
    keys = _keys(64, seed)
    N = 300
    want = prng.randint(keys, (N,), 0, 1 << 30)
    low = prng.random_bits(prng.split(keys)[:, 1], (N,))
    assert torch.equal(want, (low & M30).to(torch.int32))
    k_lo = np_split(keys.numpy().astype(np.uint32).T, 1)
    got = np_randint30((k_lo[0][:, None], k_lo[1][:, None]), np.arange(N))
    assert (got == want.numpy()).all()


@pytest.mark.parametrize("p", [0.15, 0.0, 1.0, 0.5, 1e-7, 0.9999999])
def test_bernoulli_is_the_mantissa_compare(p):
    keys = _keys(32, 7)
    N = 500
    want = prng.bernoulli(keys, p, (N,)).numpy()
    kw = keys.numpy().astype(np.uint32)
    got = np_bernoulli((kw[:, 0:1], kw[:, 1:2]), p, np.arange(N))
    assert (got == want).all()


def test_counter_high_word_enters_the_bits():
    """A counter past 2**32 puts its high word in the first input word,
    as ``random_bits`` does for a flat index ≥ 2**32."""
    k = (np.uint32(123), np.uint32(2**31 + 5))
    ctr = np.array([5, (1 << 32) + 5, (3 << 32) + 5], np.uint64)
    b = np_bits(k, ctr)
    assert len(set(b.tolist())) == 3
    y0, y1 = np_threefry(k[0], k[1], 3, 5)
    assert b[2] == y0 ^ y1


@pytest.mark.parametrize("R,step", [(16, 0), (5, 3), (1, 1)])
def test_hop_stream_per_row(R, step):
    row_keys = _keys(40, 3)
    want = kref.hop_bits(row_keys, step, R).numpy()
    kw = row_keys.numpy().astype(np.uint32)
    rows = np_hop_key((kw[:, 0], kw[:, 1]), step)
    got = np_randint30((rows[0][:, None], rows[1][:, None]),
                       np.arange(R)).reshape(-1)
    assert (got == want).all()
    per_row = torch.stack([
        prng.random_bits(prng.split(prng.fold_in(row_keys[c], step))[1],
                         (R,)) & M30 for c in range(40)]).reshape(-1)
    assert (per_row.numpy() == want).all()


@pytest.mark.parametrize("N,R", [(40 * 16, 16), (37 * 7, 7), (300, 1),
                                 (3 * 300, 300)])
def test_hop_cta_key_sharing_replay(N, R):
    """The hop kernel's CTA row bookkeeping gives every walk its own row
    and slot; walk counts not a multiple of 256, R not dividing 256, R
    above 256."""
    row_keys = _keys(N // R, 11)
    want = kref.hop_bits(row_keys, 2, R).numpy()
    got = np_hop_cta_bits(row_keys.numpy().astype(np.uint32), 2, R, N)
    assert (got == want).all()


# --- the per-frog formula against prng and the plain versions --------------


def _graph(n=300, seed=0, zero_share=0.1):
    """A CSR with degree-0 vertices (no repair: a frog there stays put)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 9, n)
    deg[rng.random(n) < zero_share] = 0
    deg[[0, n - 1]] = 0
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    col = rng.integers(0, n, int(row_ptr[-1])).astype(np.int32)
    return row_ptr, col, deg.astype(np.int32)


def test_superstep_draws_replay_prng():
    step_keys = _keys(6, 5)
    N = 1537
    for s in range(6):
        die, bits = kref.superstep_draws(step_keys[s], 0.15, N)
        k_die, k_lo = np_step_keys(step_keys[s].numpy().astype(np.uint32))
        f = np.arange(N)
        assert (np_bernoulli(k_die, 0.15, f) == die.numpy()).all()
        assert (np_randint30(k_lo, f) == bits.numpy()).all()


def caller_superstep(pos, alive, counts, step_key, p_T, g, n):
    """A superstep the caller-bits way, in place: ``prng``'s draws, then
    ``ops.frog_step`` on them."""
    die, bits = kref.superstep_draws(step_key, p_T, pos.shape[0])
    die &= alive
    nxt, dead = ops.frog_step(pos, die, bits, g.row_ptr, g.col_idx,
                              g.out_deg, n)
    counts += dead
    alive &= ~die
    pos.copy_(torch.where(alive, nxt, pos))


@pytest.mark.parametrize("N,p_T,t", [(1537, 0.15, 6), (1000, 0.6, 30),
                                     (1, 0.15, 3)])
def test_superstep_replay_equals_plain(N, p_T, t):
    """The kernel's per-frog formula in numpy, step after step, against
    ``ops.frog_superstep``'s plain version (CPU tensors) and the caller-bits
    ``ops.frog_step`` on ``prng``'s draws; at p_T = 0.6 every frog is dead long before t = 30."""
    rp, col, deg = _graph()
    n = deg.shape[0]
    g = convert.graph_from_numpy(n, rp, col, device="cpu")
    step_keys = _keys(t, 13)
    rng = np.random.default_rng(N)
    pos0 = rng.integers(0, n, N).astype(np.int32)
    want = (pos0, np.ones(N, bool), np.zeros(n, np.int32))
    runs = {rng_: (torch.from_numpy(pos0.copy()), torch.ones(N, dtype=bool),
                   torch.zeros(n, dtype=torch.int32))
            for rng_ in ("device", "caller")}
    for s in range(t):
        want = np_superstep(*want, step_keys[s].numpy().astype(np.uint32),
                            p_T, rp, col, deg)
        ops.frog_superstep(*runs["device"], step_keys[s], p_T, g.row_ptr,
                           g.col_idx, g.out_deg, n)
        caller_superstep(*runs["caller"], step_keys[s], p_T, g, n)
        for rng_, state in runs.items():
            for a, b in zip(state, want):
                assert (a.numpy() == b).all(), (rng_, s)
    if p_T > 0.5:
        assert not want[1].any()
    assert int(want[2].sum()) + int(want[1].sum()) == N


def _stream_state(N, n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, n, N).astype(np.int32)
    alive = rng.random(N) < 0.7
    return pos, alive


def np_stream_kernel(pos_s, order, pos, alive, counts, seg_off, blocked,
                     draw):
    """The streamed kernel's loop (``stream_walk``): one work item of
    ``ops.stream_schedule`` at a time, sorted frog ``f`` drawing at counter
    ``order[f]`` and writing back there. ``draw(o)`` gives ``(dies,
    bits)`` of original frog ``o`` (``dies`` None for a hop)."""
    num_cta, cta_vid, cta_lo = ops.stream_schedule(
        torch.from_numpy(seg_off), pos_s.shape[0])
    bv, num_vb = blocked.vertex_block, blocked.num_blocks
    row_off, deg, col = (blocked.row_off.numpy(), blocked.deg.numpy(),
                         blocked.col.numpy())
    pos, alive, counts = pos.copy(), alive.copy(), counts.copy()
    seen = np.zeros(pos_s.shape[0], np.int64)
    for c in range(num_cta):
        v = int(cta_vid[c])
        if v >= num_vb:
            continue
        lo = int(cta_lo[c])
        hi = min(lo + ops.STREAM_FROG_BLOCK, int(seg_off[v + 1]))
        for f in range(lo, hi):
            seen[f] += 1
            o = int(order[f])
            dies, bits = draw(o)
            if dies is not None:
                if not alive[o]:
                    continue
                if dies:
                    counts[pos_s[f]] += 1
                    alive[o] = False
                    continue
            local = int(pos_s[f]) - v * bv
            d = int(deg[v, local])
            pos[o] = col[v, row_off[v, local] + bits % d] if d else pos_s[f]
    assert (seen == 1).all(), "every sorted frog in exactly one work item"
    return pos, alive, counts


@pytest.mark.parametrize("N,bv", [(1537, 32), (300, 16)])
def test_stream_kernels_replay_equal_plain(N, bv):
    """Both streamed entries' loops replayed with the original index as
    the counter, against their plain versions and against the resident
    plain versions (sorting changes nothing)."""
    rp, col, deg = _graph()
    n = deg.shape[0]
    g = convert.graph_from_numpy(n, rp, col, device="cpu")
    blocked = tfss.blocked_csr_of(g, bv)
    pos, alive = _stream_state(N, n, 4)
    tpos = torch.from_numpy(pos)
    blocked_, pos_s, order, seg_off, sched = ops._sorted_runs(
        "test", tpos, g.row_ptr, g.col_idx, g.out_deg, n, blocked)
    step_key = _keys(1, 9)[0]
    k_die, k_lo = np_step_keys(step_key.numpy().astype(np.uint32))
    counts = np.zeros(n, np.int32)
    want = np_stream_kernel(
        pos_s.numpy(), order.numpy(), pos, alive, counts, seg_off.numpy(),
        blocked, lambda o: (bool(np_bernoulli(k_die, 0.15, o)),
                            int(np_randint30(k_lo, o))))
    got = [torch.from_numpy(a.copy()) for a in (pos, alive, counts)]
    ops.frog_superstep_stream_sorted(pos_s, order, *got, step_key, 0.15,
                                     seg_off, sched, blocked)
    resident = kref.frog_superstep_ref(
        tpos, torch.from_numpy(alive), torch.from_numpy(counts), step_key,
        0.15, g.row_ptr, g.col_idx, g.out_deg, n)
    for a, b, c in zip(got, want, resident):
        assert (a.numpy() == b).all() and torch.equal(a, c)
    # the hop: R = 7 walks a row
    R = 7
    M = (N // R) * R
    hpos = tpos[:M].contiguous()
    row_keys = _keys(M // R, 21)
    _, hpos_s, horder, hseg, hsched = ops._sorted_runs(
        "test", hpos, g.row_ptr, g.col_idx, g.out_deg, n, blocked)
    kw = row_keys.numpy().astype(np.uint32)
    want_h = np_stream_kernel(
        hpos_s.numpy(), horder.numpy(), hpos.numpy(), np.ones(M, bool),
        counts, hseg.numpy(), blocked,
        lambda o: (None, int(np_randint30(np_hop_key(kw[o // R], 3),
                                          o % R))))[0]
    got_h = hpos.clone()
    ops.frog_hop_stream_sorted(hpos_s, horder, got_h, row_keys, 3, R, hseg,
                               hsched, blocked)
    assert (got_h.numpy() == want_h).all()
    assert torch.equal(got_h, kref.frog_hop_ref(hpos, row_keys, 3, R,
                                                g.row_ptr, g.col_idx,
                                                g.out_deg))


# --- the slice against the reference ----------------------------------------


def _graph_pair(seed=0):
    rp, col, deg = _graph(seed=seed)
    n = deg.shape[0]
    gj = JCSRGraph(n=n, row_ptr=jax.numpy.asarray(rp, jax.numpy.int32),
                   col_idx=jax.numpy.asarray(col),
                   out_deg=jax.numpy.asarray(deg))
    return gj, convert.graph_from_numpy(n, rp, col, device="cpu")


def _eq(want, got):
    want, got = np.asarray(want), got.cpu().numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


@pytest.mark.parametrize("N,t,p_T,seed", [(1537, 8, 0.15, 0),
                                          (1000, 40, 0.6, 3),
                                          (1, 2, 0.15, 1)])
@pytest.mark.parametrize("step_impl", ["auto", "stream"])
def test_batch_walk_byte_equal_reference(N, t, p_T, seed, step_impl):
    """The batch walk through ``ops.frog_superstep``'s plain version
    against ``repro.core.frogwild`` (the XLA step), on a graph with
    degree-0 vertices; at p_T = 0.6 every frog dies before t = 40."""
    gj, gt = _graph_pair(seed)
    key = jax.random.PRNGKey(seed)
    want = jfw._frogwild_walks(gj, JFrogWildConfig(num_frogs=N, num_steps=t,
                                                   p_T=p_T), key)
    blocked = tfss.blocked_csr_of(gt, 32) if step_impl == "stream" else None
    got = tfw._frogwild_walks(
        gt, FrogWildConfig(num_frogs=N, num_steps=t, p_T=p_T,
                           step_impl=step_impl),
        convert.key_from_jax(jax.random.key_data(key), device="cpu"), blocked)
    _eq(want.counts, got.counts)
    _eq(want.pi_hat, got.pi_hat)
    assert int(got.counts.sum()) == N


@pytest.mark.parametrize("step_impl", ["auto", "stream", "torch"])
@pytest.mark.parametrize("R,L,shards", [(16, 4, 3), (7, 3, 2)])
def test_index_slab_byte_equal_reference(step_impl, R, L, shards):
    """The index slab through ``ops.frog_hop``'s plain version against the
    reference's ``_build_walk_index`` (XLA step), degree-0 vertices
    included; 300 rows over 3 or 2 build shards give walk counts that are
    not multiples of 256."""
    gj, gt = _graph_pair(2)
    want = jindex._build_walk_index(gj, JWalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=shards, seed=5))
    got = tindex._build_walk_index(gt, WalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=shards, seed=5,
        step_impl=step_impl))
    _eq(want.endpoints, got.endpoints)


def test_hop_caller_and_device_agree_and_refuse_bad_operands():
    gj, g = _graph_pair(1)
    n = g.n
    R = 4
    row_keys = _keys(50, 2)
    pos = torch.repeat_interleave(torch.arange(50, dtype=torch.int32), R)
    a, b = pos.clone(), pos.clone()
    ops.frog_hop(a, row_keys, 1, R, g.row_ptr, g.col_idx, g.out_deg, n)
    b, _ = ops.frog_step(b, torch.zeros_like(b), kref.hop_bits(row_keys, 1, R),
                         g.row_ptr, g.col_idx, g.out_deg, n)
    assert torch.equal(a, b) and not torch.equal(a, pos)
    with pytest.raises(ValueError, match="whole rows"):
        ops.frog_hop(pos[:-1].contiguous(), row_keys, 1, R, g.row_ptr,
                     g.col_idx, g.out_deg, n)
    with pytest.raises(ValueError, match="row_keys"):
        ops.frog_hop(pos, row_keys[:-1], 1, R, g.row_ptr, g.col_idx,
                     g.out_deg, n)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.frog_hop(pos, row_keys, 1, R, g.row_ptr, g.col_idx, g.out_deg,
                     n, impl="cuda")
    alive = torch.ones(pos.shape[0], dtype=torch.bool)
    counts = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="alive"):
        ops.frog_superstep(pos, alive[:-1], counts, row_keys[0], 0.15,
                           g.row_ptr, g.col_idx, g.out_deg, n)
    with pytest.raises(ValueError, match="step_key"):
        ops.frog_superstep(pos, alive, counts, row_keys[:2], 0.15,
                           g.row_ptr, g.col_idx, g.out_deg, n)
    before = ops.launch_counts()
    ops.frog_superstep(pos, alive, counts, row_keys[0], 0.15, g.row_ptr,
                       g.col_idx, g.out_deg, n)     # CPU: the plain version
    assert ops.launch_counts() == before
    assert int(counts.sum()) + int(alive.sum()) == pos.shape[0]
