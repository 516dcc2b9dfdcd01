"""A wave's stitch rounds in one call (``ops.stitch_gather_rounds``).

On the CPU the wrapper runs its plain version (``kref.
stitch_gather_rounds_ref``). It is held byte for byte to the rounds as
the wave ran them before: ``kref.stitch_rounds`` over one gather-only
``ops.stitch_step`` per round, with and without the eviction mask, at
ragged walk counts, ``q`` all 0 and all ``q_max``, and slot offsets whose
``s0 + j`` wraps past 2**31 − 1. The port's wave (``build_wave_program``,
which now calls it) gives the reference's counts, with ``impl="xla"``
and with the Pallas stitch in interpret mode, over a stacked sharded
slab with and without a lost shard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.query import engine as jengine
from repro_torch import convert
from repro_torch.graph import generators as tgen
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.query import engine as tengine

P_T = 0.15
I32_MAX = np.iinfo(np.int32).max


def _rounds_inputs(W, n, R, S, q_max, mode, seed):
    """Walk positions, round counts and slot offsets, and a stacked
    ``[S·sz, R]`` slab (its padding rows past ``n`` are never gathered)."""
    rng = np.random.default_rng(seed)
    sz = -(-n // S)
    slab = rng.integers(0, n, (S * sz, R)).astype(np.int32)
    pos = rng.integers(0, n, W).astype(np.int32)
    q = rng.integers(0, q_max + 1, W).astype(np.int32)
    s0 = rng.integers(0, 1 << 30, W).astype(np.int32)
    if mode == "q_zero":
        q[:] = 0
    elif mode == "q_full":
        q[:] = q_max
    elif mode == "s0_wraps":
        # s0 + j passes 2**31 - 1 for some j < q_max and wraps negative
        s0 = (I32_MAX - rng.integers(0, 2 * q_max, W)).astype(np.int32)
        s0[0] = I32_MAX
    return [torch.from_numpy(a) for a in (pos, q, s0, slab)], sz


def _rounds_before(pos, q, s0, slab, q_max, lost, S, sz, n):
    """The wave's rounds as they ran before the one-launch kernel."""
    def round_fn(pos, j):
        nxt, _ = ops.stitch_step(pos, (q == j), s0 + j, slab, n,
                                 impl="torch", tally=False)
        return nxt

    return kref.stitch_rounds(
        pos, q, q_max, round_fn,
        None if lost is None else lambda p: kref.lost_of(lost, p, S, sz))


@pytest.mark.parametrize("lost_mode", ["none", "all_false", "one_lost"])
@pytest.mark.parametrize("mode,W", [("random", 1000), ("random", 256),
                                    ("q_zero", 777), ("q_full", 777),
                                    ("s0_wraps", 513)])
def test_rounds_equal_per_round_gathers(mode, W, lost_mode):
    n, R, S, q_max = 97, 6, 4, 8
    (pos, q, s0, slab), sz = _rounds_inputs(W, n, R, S, q_max, mode, W)
    lost = None if lost_mode == "none" else torch.zeros(S, dtype=torch.bool)
    if lost_mode == "one_lost":
        lost[1] = True
    want_pos, want_alive = _rounds_before(pos, q, s0, slab, q_max, lost, S,
                                          sz, n)
    before = ops.launch_counts()
    got_pos, got_alive = ops.stitch_gather_rounds(pos, q, s0, slab, q_max,
                                                  lost, S, sz)
    assert ops.launch_counts() == before          # CPU: the plain version
    assert got_pos.dtype == torch.int32
    assert got_pos.numpy().tobytes() == want_pos.numpy().tobytes()
    if lost is None:
        assert got_alive is None and want_alive is None
    else:
        assert got_alive.dtype == torch.bool
        assert torch.equal(got_alive, want_alive)
        if lost_mode == "all_false":
            assert bool(got_alive.all())
            plain, _ = ops.stitch_gather_rounds(pos, q, s0, slab, q_max)
            assert torch.equal(plain, got_pos)
    if mode == "q_zero":
        assert torch.equal(got_pos, pos)
    if mode == "s0_wraps":
        assert bool((s0.long() + q_max > I32_MAX).any())


def test_rounds_wrapper_refuses_bad_operands():
    (pos, q, s0, slab), sz = _rounds_inputs(10, 20, 3, 2, 4, "random", 0)
    lost = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.stitch_gather_rounds(pos, q, s0, slab, 4, impl="cuda")
    with pytest.raises(TypeError, match="q must be int32"):
        ops.stitch_gather_rounds(pos, q.long(), s0, slab, 4)
    with pytest.raises(ValueError, match="s0 has 5 elements"):
        ops.stitch_gather_rounds(pos, q, s0[:5], slab, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.stitch_gather_rounds(pos, q, s0, slab.t(), 4)
    with pytest.raises(ValueError, match="q_max"):
        ops.stitch_gather_rounds(pos, q, s0, slab, -1)
    with pytest.raises(ValueError, match="lost must be"):
        ops.stitch_gather_rounds(pos, q, s0, slab, 4, lost.int(), 2, sz)
    with pytest.raises(ValueError, match="lost must be"):
        ops.stitch_gather_rounds(pos, q, s0, slab, 4, lost, 3, sz)
    with pytest.raises(ValueError, match="sz ≥ 1"):
        ops.stitch_gather_rounds(pos, q, s0, slab, 4, lost, 2, 0)


def _wave_operands(n, W, Q, seed):
    rng = np.random.default_rng(seed)
    qid = np.full(W, Q, np.int32)
    live = W - W // 4                        # the tail idles in row Q
    qid[:live] = np.arange(live) * Q // live
    uniform = qid == 0
    start = np.where(uniform, 0, rng.integers(0, n, W)).astype(np.int32)
    t_cap = rng.integers(0, 16, W).astype(np.int32)
    return start, uniform, qid, t_cap


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("lost_shard", [None, 2])
def test_wave_program_equal_reference(impl, lost_shard):
    """The port's wave over a stacked ``[S·sz, R]`` slab, its rounds in
    one ``stitch_gather_rounds`` call, gives the reference's counts."""
    n, R, L, S, q_max, W, Q = 150, 5, 2, 4, 6, 200, 3
    gj = jgen.chung_lu_powerlaw(n, 5.0, seed=4)
    gt = tgen.chung_lu_powerlaw(n, 5.0, seed=4)
    sz = -(-n // S)
    slab = np.random.default_rng(7).integers(0, n, (S * sz, R)).astype(
        np.int32)
    operands = _wave_operands(n, W, Q, 3)
    lost = np.zeros(S, bool)
    if lost_shard is not None:
        lost[lost_shard] = True
    key = jax.random.PRNGKey(11)
    want = jengine.build_wave_program(jengine.WaveSpec(
        n=n, R=R, L=L, q_max=q_max, S=S, sz=sz, W=W, Q=Q, p_T=P_T,
        impl=impl, tally_impl="ref", donate=False))(
        jnp.asarray(slab).reshape(-1), gj.row_ptr, gj.col_idx, gj.out_deg,
        *map(jnp.asarray, operands), jax.random.key_data(key),
        jnp.asarray(lost))
    before = ops.launch_counts()
    got = tengine.build_wave_program(tengine.WaveSpec(
        n=n, R=R, L=L, q_max=q_max, W=W, Q=Q, p_T=P_T, impl="auto",
        tally_impl="auto", S=S, sz=sz))(
        torch.from_numpy(slab), gt.row_ptr, gt.col_idx, gt.out_deg,
        *map(torch.from_numpy, operands),
        convert.key_from_jax(jax.random.key_data(key), device="cpu"),
        None if lost_shard is None else torch.from_numpy(lost))
    assert ops.launch_counts() == before
    want = np.asarray(want)
    assert got.shape == want.shape == (Q, n)
    assert got.numpy().tobytes() == want.tobytes()
    live = int((operands[2] < Q).sum())
    if lost_shard is None:
        assert int(got.sum()) == live
    else:
        assert int(got.sum()) < live
