"""The chunked backward of Mamba-2's selective scan, replayed in plain
float32 torch, against ``jax.vjp`` of the reference's step and against
``ref.ssd_scan_bwd_ref``, on the CPU.

``csrc/ssd_scan_bwd.cu`` computes the gradients of ``ssd_scan`` in
Mamba-2's chunked (state-space dual) form: chunks of 32 steps, the
gradient of the state after every chunk walked from the last, then each
chunk's gradients from its starting state and that chunk-end gradient,
every decay exp of a sum over its own segment, the sums over heads in a
fixed order. :func:`chunked_ssd_bwd` is that algorithm written out in
torch; each of its six gradients is held to the reference within 1e-5
relative Frobenius error at S = 1, 31, 32, 33 and 200, B = 1 and 3, state
sizes 16 and 64, from a nonzero state with a nonzero final-state
gradient, with mild decays and with the forward test's strong schedule
(a chunk's sum of Δ·a reaches about −2,048). A planted form that takes
the decays as differences of the chunk's cumulative sums must miss the
same limit under the strong schedule.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as kref

L = 32
LIMIT = 1e-5
TINY = float(np.finfo(np.float32).tiny)
GRADS = ("dx", "dB", "dC", "ddt", "da", "dh0")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _inputs(B, S, n, decay, seed):
    """x, B, C, Δ, a, h0 and the two cotangents, numpy float32. ``strong``:
    a = −16 and Δ ≈ 8 over the first 16 steps of every 32, then Δ ≈ 0.002
    (``test_torch_mamba.py``'s schedule for the forward)."""
    H, D = 2, 4
    x = _rand((B, S, H, D), seed)
    Bv, Cv = _rand((B, S, n), seed + 1), _rand((B, S, n), seed + 2)
    if decay == "strong":
        burst = (np.arange(S) % L < 16)[None, :, None]
        dt = np.where(burst, 8.0, 0.002) * (1 + 0.1 * _rand((B, S, H),
                                                             seed + 3))
        dt = dt.astype(np.float32)
        a = np.full(H, -16.0, np.float32)
    else:
        dt = np.log1p(np.exp(_rand((B, S, H), seed + 3) - 2)).astype(
            np.float32)
        a = -np.linspace(1, 16, H).astype(np.float32)
    h0 = _rand((B, H, D, n), seed + 4)
    dy = _rand((B, S, H, D), seed + 5)
    dh = _rand((B, H, D, n), seed + 6, 0.5)
    return x, Bv, Cv, dt, a, h0, dy, dh


def _jax_vjp(*ins):
    """The six gradients from ``jax.vjp`` of the reference's step
    (``repro/models/mamba2.py:110-122``) through ``lax.scan``, in float64:
    the float32 inputs widened, so that the reference's own rounding (da
    is a sum of terms that nearly cancel, off by up to 2e-5 in float32)
    does not count against the replay."""
    import jax
    with jax.enable_x64(True):
        return _jax_vjp64(*(v.astype(np.float64) for v in ins))


def _jax_vjp64(x, Bv, Cv, dt, a, h0, dy, dh):
    import jax
    import jax.numpy as jnp

    def scan(x, Bv, Cv, dt, a, h0):
        def step(h, inp):
            xt, Bt, Ct, dlt = inp
            decay = jnp.exp(dlt * a[None, :])
            dBx = jnp.einsum("bhd,bn,bh->bhdn", xt, Bt, dlt)
            h_new = decay[..., None, None] * h + dBx
            return h_new, jnp.einsum("bhdn,bn->bhd", h_new, Ct)

        xs = (x.transpose(1, 0, 2, 3),
              *(t.transpose(1, 0, 2) for t in (Bv, Cv, dt)))
        h_last, ys = jax.lax.scan(step, h0, xs)
        return ys.transpose(1, 0, 2, 3), h_last

    @jax.jit
    def grads(ins, cots):
        return jax.vjp(scan, *ins)[1](cots)

    out = grads(tuple(jnp.asarray(t) for t in (x, Bv, Cv, dt, a, h0)),
                (jnp.asarray(dy), jnp.asarray(dh)))
    return [np.asarray(g) for g in out]


def _segments(da, stable):
    """A chunk's decays from its ``da = Δ·a`` ``[..., T]``: ``(E [..., i,
    j] = exp(seg) for j ≤ i and 0 above, exp(prefix) [..., i], exp(suffix)
    [..., j], exp(total) [...])``; ``seg[i][j]`` sums steps j + 1 … i, the
    prefix steps 0 … i, the suffix steps j + 1 … T − 1. ``stable``: each a
    running sum over its own segment, added in order; otherwise the planted
    form, differences of the chunk's cumulative sums."""
    T = da.shape[-1]
    low = torch.tril(torch.ones(T, T, dtype=torch.bool))
    pre = torch.cumsum(da, -1)
    if stable:
        seg = torch.zeros(*da.shape, T)
        for i in range(1, T):           # seg[i][j] = seg[i − 1][j] + da_i
            seg[..., i, :i] = seg[..., i - 1, :i] + da[..., i, None]
        suf = torch.zeros_like(da)
        for j in range(T - 2, -1, -1):
            suf[..., j] = suf[..., j + 1] + da[..., j + 1]
        total = pre[..., -1]
    else:
        seg = pre[..., :, None] - pre[..., None, :]
        suf = pre[..., -1:] - pre
        total = pre[..., -1]
    E = torch.exp(seg).masked_fill(~low, 0.0)
    return E, torch.exp(pre), torch.exp(suf), torch.exp(total)


def chunked_ssd_bwd(x, Bv, Cv, dt, a, h0, dy, dh_last, stable=True):
    """``ssd_scan_bwd.cu``'s algorithm in float32 torch → ``(dx, dB, dC,
    ddt, da, dh0)``.

    1. The chunk-start states (the forward's checkpoints), then the
       gradient of the state after every chunk from the last:
       ``dh_end(c − 1) = exp(total_c)·dh_end(c) + Σ_i exp(pre_i)·dy_iᵀ ⊗
       C_i``, from ``dh_last``; its last value is ``dh0``.
    2. Each chunk from ``h_start`` and ``dh_end``, with ``G = C·Bᵀ`` and
       ``A = dY·Xᵀ`` a head: ``dx = Δ ∘ ((G ∘ E)ᵀ·dY + exp(suf) ∘ B·dh_endᵀ)``,
       ``dB = Σ_h W2ᵀ·C + Δ·exp(suf) ∘ X·dh_end`` and ``dC = Σ_h W2·B +
       exp(pre) ∘ dY·h_start`` with ``W2 = A ∘ E ∘ Δ_j``, the heads added
       in order.
    3. The gradient of each step's log-decay ``ℓ_k = Δ_k·a``: with the
       chunk's terms in one matrix ``T`` (rows: the outputs i and the
       chunk's end; columns: the chunk's start and the inputs j; ``T[i][j]
       = G ∘ W2``, ``T[i][start] = exp(pre_i)·dy_i·(h_start·C_i)``,
       ``T[end][j] = exp(suf_j)·Δ_j·x_j·(dh_end·B_j)``, ``T[end][start] =
       exp(total)·Σ dh_end ∘ h_start``), ``dℓ_k`` is the sum over rows i ≥
       k and columns j < k: each row's running sums over its columns,
       then each column's sum over its rows. ``ddt_k = a·dℓ_k +
       x_k·gB_k``, ``da = Σ Δ_k·dℓ_k``."""
    Bn, S, H, _ = x.shape
    nch = -(-S // L)
    # 1. the chunk-start states, by the chunked forward
    hs, h = [], h0.clone()
    for c in range(nch):
        t0, t1 = c * L, min(S, (c + 1) * L)
        hs.append(h)
        da = (dt[:, t0:t1] * a).transpose(1, 2)            # [B, H, T]
        _, _, es, et = _segments(da, stable)
        wgt = es * dt[:, t0:t1].transpose(1, 2)
        h = et[..., None, None] * h + torch.einsum(
            "bhs,bshd,bsn->bhdn", wgt, x[:, t0:t1], Bv[:, t0:t1])
    # the chunk-end gradients, from the last chunk
    dhe = [None] * nch
    g = dh_last.clone()
    for c in reversed(range(nch)):
        t0, t1 = c * L, min(S, (c + 1) * L)
        dhe[c] = g
        da = (dt[:, t0:t1] * a).transpose(1, 2)
        _, ep, _, et = _segments(da, stable)
        g = et[..., None, None] * g + torch.einsum(
            "bhi,bihd,bin->bhdn", ep, dy[:, t0:t1], Cv[:, t0:t1])
    dh0 = g
    # 2.-3. each chunk
    dx = torch.zeros_like(x)
    dB, dC = torch.zeros_like(Bv), torch.zeros_like(Cv)
    ddt = torch.zeros_like(dt)
    dA = torch.zeros(H)
    for c in range(nch):
        t0, t1 = c * L, min(S, (c + 1) * L)
        T = t1 - t0
        xs, ys = x[:, t0:t1], dy[:, t0:t1]
        bs, cs = Bv[:, t0:t1], Cv[:, t0:t1]
        dts = dt[:, t0:t1].transpose(1, 2)                 # [B, H, T]
        E, ep, es, et = _segments(dts * a[:, None], stable)
        G = torch.einsum("bin,bjn->bij", cs, bs)[:, None]   # [B, 1, i, j]
        A = torch.einsum("bihd,bjhd->bhij", ys, xs)
        W2 = A * E * dts[..., None, :]
        V = torch.einsum("bjn,bhdn->bhjd", bs, dhe[c])
        gB = (torch.einsum("bhij,bihd->bhjd", G * E, ys)
              + es[..., None] * V)                          # [B, H, j, d]
        xh = xs.transpose(1, 2)                             # [B, H, j, d]
        dx[:, t0:t1] = (dts[..., None] * gB).transpose(1, 2)
        U = torch.einsum("bhjd,bhdn->bhjn", xh, dhe[c])
        Z = torch.einsum("bihd,bhdn->bhin", ys, hs[c])
        dBh = (torch.einsum("bhij,bin->bhjn", W2, cs)
               + (dts * es)[..., None] * U)
        dCh = torch.einsum("bhij,bjn->bhin", W2, bs) + ep[..., None] * Z
        for hh in range(H):                                # heads in order
            dB[:, t0:t1] += dBh[:, hh]
            dC[:, t0:t1] += dCh[:, hh]
        Tm = torch.zeros(Bn, H, T + 1, T + 1)               # [i | end, start | j]
        Tm[..., :T, 1:] = torch.tril(G * W2, -1)
        Tm[..., :T, 0] = ep * (Z * cs[:, None]).sum(-1)
        Tm[..., T, 1:] = es * dts * (xh * V).sum(-1)
        Tm[..., T, 0] = et * (dhe[c] * hs[c]).sum((-1, -2))
        pref = torch.cumsum(Tm, -1)                        # along each row
        dl = torch.stack([pref[..., k:, k].sum(-1) for k in range(T)], -1)
        ddt[:, t0:t1] = (a[:, None] * dl + (xh * gB).sum(-1)).transpose(1, 2)
        dA += (dts * dl).sum((0, 2))
    return dx, dB, dC, ddt, dA, dh0


def _rel(got, want) -> float:
    """Relative Frobenius error; absolute where the reference's norm is
    below float32's normal range (dh0 under the strong schedule, whose
    true value float32 cannot hold)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = float(np.linalg.norm(want))
    num = float(np.linalg.norm(got - want))
    return num / den if den > TINY else num


@pytest.mark.parametrize("decay", ["mild", "strong"])
@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 200])
def test_chunked_bwd_matches_reference(S, B, n, decay):
    ins = _inputs(B, S, n, decay, seed=S + 7 * B + n)
    want = _jax_vjp(*ins)
    t = [torch.from_numpy(v) for v in ins]
    got = chunked_ssd_bwd(*t)
    twin = kref.ssd_scan_bwd_ref(*t)
    for name, g, w, r in zip(GRADS, got, want, twin):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g.numpy(), w) <= LIMIT, (name, _rel(g.numpy(), w))
        assert _rel(g.numpy(), r.numpy()) <= LIMIT, (
            name, _rel(g.numpy(), r.numpy()))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", [32, 200])
def test_cumsum_difference_decays_miss(S, B):
    """The planted form (decays as differences of cumulative sums) under
    the strong schedule: some gradient misses 1e-5 against the
    reference."""
    ins = _inputs(B, S, 16, "strong", seed=S + 7 * B + 16)
    want = _jax_vjp(*ins)
    got = chunked_ssd_bwd(*(torch.from_numpy(v) for v in ins), stable=False)
    worst = max(_rel(g.numpy(), w) for g, w in zip(got, want))
    assert worst > LIMIT, worst
