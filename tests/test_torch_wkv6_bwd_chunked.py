"""The chunked backward of RWKV-6's time recurrence, replayed in plain
float32 torch, against ``jax.vjp`` of the reference's step and against
``ref.wkv6_scan_bwd_ref``, on the CPU.

``csrc/wkv6_bwd.cu`` computes the gradients of ``wkv6_scan`` in chunked
form: chunks of 32 steps, the gradient of the state after every chunk
walked from the last, then each chunk's gradients from its starting state
(the forward's checkpoint) and that chunk-end gradient. The decay is per
key channel, so a chunk runs as two sub-chunks of 16: a pair of steps in
different sub-chunks has its decay factored through the sub-chunk
boundary (two factors ≤ 1, products on the tensor cores), a pair inside
one sub-chunk is formed term by term, its decay the running product of the
w's between the two steps. Every decay is exp of a sum over its own
segment, or such a running product, never a difference of a chunk's
cumulative sums. The kernel returns the gradient of log w, which never
divides by w: ``dlw_m = w_m ∘ rowsum(G_m ∘ S_{m−1})`` is the sum of the
chunk's terms whose decay spans step m (the pairs s < m < t, the chunk's
starting state and its end's gradient standing in for s or t), each a
product through w_m, so that where w_m underflows dlw_m is 0 exactly. (The
identity ``dlw_m = Σ_{t>m} r_t ∘ dr_t − Σ_{s≥m} k_s ∘ dk_s + rowsum(S_e ∘
G_e)`` gives the same in exact arithmetic, but in float32 leaves a residue
there, about 1e-5 of the terms, which ``d raw`` multiplies by exp(raw).)
:func:`chunked_wkv6_bwd` is that algorithm written out in torch; each of
its six gradients is held to ``jax.vjp`` of the reference's step,
differentiated in log w in float64, within 1e-5 relative Frobenius error
at S = 1, 31, 32, 33 and 200, B = 1 and 3, from a nonzero state with a
nonzero final-state gradient, with mild decays and with a strong schedule
(a step of log w near −2,000 on half the channels at every chunk's fourth
step, and w underflowing to 0 in float32 on a quarter of them at step 20),
and to ``ref.wkv6_scan_bwd_ref`` within the same limit. Where w underflows
the true gradient of log w is 0; the gradient of the decay's raw input,
``d raw = dlw · log w``, is held there to the float64 reference's within
1e-5 of the whole tensor's norm (the replay's is 0). A planted form that
takes the decays as differences of the chunk's cumulative sums must miss
the limit under the strong schedule.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as kref

L = 32          # a chunk's steps
SUB = 16        # a sub-chunk's steps
LIMIT = 1e-5
GRADS = ("dr", "dk", "dv", "dlw", "du", "dS0")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _inputs(B, S, decay, seed, H=2, D=8):
    """r, k, v, log w, u, S0 and the two cotangents, numpy float32; log w
    = −exp(raw) as the model forms it. ``strong``: raw = 7.6 (log w ≈
    −2,000) on the even channels at every chunk's step 3, raw = 5 (log w
    ≈ −148: w = 0 in float32) on channels 1 mod 4 at every chunk's step
    20, mild elsewhere."""
    r, k, v = (_rand((B, S, H, D), seed + i) for i in range(3))
    raw = _rand((B, S, H, D), seed + 3) - 1.0
    if decay == "strong":
        t = np.arange(S)[None, :, None, None]
        ch = np.arange(D)[None, None, None, :]
        raw = np.where((t % L == 3) & (ch % 2 == 0), 7.6, raw)
        raw = np.where((t % L == 20) & (ch % 4 == 1), 5.0, raw)
    lw = (-np.exp(raw)).astype(np.float32)
    u = _rand((H, D), seed + 4)
    S0 = _rand((B, H, D, D), seed + 5, 0.5)
    do = _rand((B, S, H, D), seed + 6)
    dS = _rand((B, H, D, D), seed + 7, 0.5)
    return r, k, v, lw, u, S0, do, dS


@pytest.fixture(scope="module")
def jax_vjp():
    """The six gradients from ``jax.vjp`` of the reference's step
    (``repro/models/rwkv6.py:121-131``) through ``lax.scan``, with ``w =
    exp(log w)`` in the step and the gradient taken to log w, in float64:
    the float32 inputs widened, so that the reference's own rounding does
    not count against the replay. One jitted program, built here."""
    import jax
    import jax.numpy as jnp

    def scan(r, k, v, lw, u, S0):
        def step(st, inp):
            rt, kt, vt, lwt = inp
            kv = jnp.einsum("bhi,bhj->bhij", kt, vt)
            o = jnp.einsum("bhi,bhij->bhj", rt,
                           st + u[None, :, :, None] * kv)
            return jnp.exp(lwt)[..., None] * st + kv, o

        xs = tuple(t.transpose(1, 0, 2, 3) for t in (r, k, v, lw))
        last, o = jax.lax.scan(step, S0, xs)
        return o.transpose(1, 0, 2, 3), last

    @jax.jit
    def grads(ins, cots):
        return jax.vjp(scan, *ins)[1](cots)

    def run(r, k, v, lw, u, S0, do, dS):
        with jax.enable_x64(True):
            ins = tuple(jnp.asarray(t.astype(np.float64))
                        for t in (r, k, v, lw, u, S0))
            cots = tuple(jnp.asarray(t.astype(np.float64)) for t in (do, dS))
            return [np.asarray(g) for g in grads(ins, cots)]

    return run


def _decays(a, stable):
    """A chunk's decays from its log w ``a [..., 32, D]``: ``(pre,
    suf, tot, pb, sb)``: ``pre[t] = exp(Σ_{τ<t} a)``, ``suf[s] =
    exp(Σ_{τ>s} a)``, ``tot = exp(Σ a)``, and about the sub-chunk boundary
    16 ``pb[t] = exp(Σ_{16≤τ<t} a)`` (t ≥ 16) and ``sb[s] = exp(Σ_{s<τ<16}
    a)`` (s < 16). ``stable``: each a running sum from its own boundary;
    otherwise the planted form, differences of the chunk's cumulative
    sums."""
    if stable:
        def run(idx):          # a running sum over idx, in order
            out, acc = [], torch.zeros_like(a[..., 0, :])
            for i in idx:
                out.append(acc)
                acc = acc + a[..., i, :]
            return out, acc

        fwd, tot = run(range(L))
        pre = torch.stack(fwd, -2)
        back, _ = run(range(L - 1, -1, -1))
        suf = torch.stack(back[::-1], -2)
        pb = torch.stack(run(range(SUB, L))[0], -2)
        sb = torch.stack(run(range(SUB - 1, -1, -1))[0][::-1], -2)
    else:
        A = torch.cumsum(a, -2)                     # A[t] = Σ_{τ≤t} a
        Am1 = torch.cat([torch.zeros_like(A[..., :1, :]), A[..., :-1, :]],
                        -2)                         # A[t − 1]
        tot = A[..., -1, :]
        pre = Am1
        suf = tot[..., None, :] - A
        pb = Am1[..., SUB:, :] - A[..., SUB - 1:SUB, :]
        sb = A[..., SUB - 1:SUB, :] - A[..., :SUB, :]
    return tuple(torch.exp(x) for x in (pre, suf, tot, pb, sb))


def _pair_decays(a, w, t0, t1, stable):
    """``W[t, s] [..., D]`` for steps s < t of one sub-chunk [t0, t1):
    the product of w over s + 1 … t − 1 (stable: a running product,
    ``w = exp(a)`` the forward's own factors), or, planted, exp of a
    difference of the chunk's cumulative sums."""
    A = torch.cumsum(a, -2)
    W = {}
    for s in range(t0, t1):
        run = torch.ones_like(w[..., 0, :])
        for t in range(s + 1, t1):
            if stable:
                W[t, s] = run
                run = run * w[..., t, :]
            else:
                W[t, s] = torch.exp(A[..., t - 1, :] - A[..., s, :])
    return W


def chunked_wkv6_bwd(r, k, v, lw, u, S0, do, dS_last, stable=True):
    """``wkv6_bwd.cu``'s algorithm in float32 torch → ``(dr, dk, dv, dlw,
    du, dS0)``, per (batch, head), key rows i and value columns j.

    1. The chunk-start states S_c (the forward's checkpoints, stepped in
       float32 as the forward kernel steps them), then the gradient of the
       state after every chunk from the last: ``G_start = diag(tot)·G_e +
       (R ∘ pre)ᵀ·dO``, from ``dS_last``; its last value is ``dS0``.
    2. Each chunk from S_c and G_e: the inter-chunk products ``dO·S_cᵀ``
       (dr, scaled by pre), ``V·G_eᵀ`` (dk, by suf) and ``(K ∘ suf)·G_e``
       (dv); the scores Q and ``M = dO·Vᵀ`` between the steps, a pair
       across the sub-chunk boundary through ``R̂ = R ∘ pb`` and ``K̂ = K ∘
       sb`` (``Q = R̂·K̂ᵀ``, dr ``pb ∘ M·K̂``, dk ``sb ∘ Mᵀ·R̂``), a pair
       inside a sub-chunk term by term; dv's ``Qᵀ·dO``; the bonus terms.
    3. ``dlw_m = tot ∘ rowsum(S_c ∘ G_e) + Σ_{s<m} k_s ∘ suf_s ∘ (V·G_eᵀ)_s
       + Σ_{t>m} r_t ∘ pre_t ∘ (dO·S_cᵀ)_t``, plus the cross pairs' terms
       (``k ∘ sb ∘ Mᵀ·R̂`` summed over s < m for m < 16, ``r ∘ pb ∘ M·K̂``
       over t > m for m ≥ 16) and the sub-chunk's pairs s < m < t: every
       term whose decay spans step m."""
    B, S, H, D = r.shape
    nch = -(-S // L)
    pad = nch * L - S

    def tpad(t):   # [B, H, nch·L, D]; rows past S zeros (log w 0: w = 1)
        return torch.nn.functional.pad(t.transpose(1, 2), (0, 0, 0, pad))

    r, k, v, lw, do = map(tpad, (r, k, v, lw, do))
    w = torch.exp(lw)
    # 1. the checkpoints, then the chunk-end gradients
    ck, st = [], S0.clone()
    for t in range(nch * L):
        if t % L == 0:
            ck.append(st)
        st = w[:, :, t, :, None] * st + k[:, :, t, :, None] * v[:, :, t, None]
    ge, g = [None] * nch, dS_last.clone()
    for c in reversed(range(nch)):
        ge[c] = g
        sl = slice(c * L, (c + 1) * L)
        pre, _, tot, _, _ = _decays(lw[:, :, sl], stable)
        g = tot[..., None] * g + torch.einsum("bhti,bhtj->bhij",
                                              r[:, :, sl] * pre, do[:, :, sl])
    dS0 = g
    # 2.-3. each chunk
    dr, dk, dv, dlw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros(B, H, D)
    uh = u[None, :, None, :]
    for c in range(nch):
        sl = slice(c * L, (c + 1) * L)
        rc, kc, vc, oc, ac, wc = (t[:, :, sl] for t in (r, k, v, do, lw, w))
        Sc, G = ck[c], ge[c]
        pre, suf, tot, pb, sb = _decays(ac, stable)
        M = torch.einsum("bhtj,bhsj->bhts", oc, vc)
        X1 = torch.einsum("bhtj,bhij->bhti", oc, Sc)
        Y1 = torch.einsum("bhsj,bhij->bhsi", vc, G)
        Z1 = torch.einsum("bhsi,bhij->bhsj", kc * suf, G)
        Q = torch.zeros(B, H, L, L)
        dri, dki = torch.zeros_like(rc), torch.zeros_like(kc)
        span = torch.zeros_like(rc)
        # across the sub-chunk boundary
        Rh, Kh = rc[:, :, SUB:] * pb, kc[:, :, :SUB] * sb
        Mx = M[:, :, SUB:, :SUB]
        Q[:, :, SUB:, :SUB] = torch.einsum("bhti,bhsi->bhts", Rh, Kh)
        dri[:, :, SUB:] = pb * torch.einsum("bhts,bhsi->bhti", Mx, Kh)
        dki[:, :, :SUB] = sb * torch.einsum("bhts,bhti->bhsi", Mx, Rh)
        # inside each sub-chunk, term by term
        for t0 in (0, SUB):
            for (t, s), W in _pair_decays(ac, wc, t0, t0 + SUB,
                                          stable).items():
                Q[:, :, t, s] = (rc[:, :, t] * kc[:, :, s] * W).sum(-1)
                m = M[:, :, t, s, None]
                dri[:, :, t] += m * W * kc[:, :, s]
                dki[:, :, s] += m * W * rc[:, :, t]
                # the pair's term of dlw at every step strictly between
                span[:, :, s + 1:t] += rc[:, :, t, None] * m[..., None] * \
                    W[:, :, None] * kc[:, :, s, None]
        Z2 = torch.einsum("bhts,bhtj->bhsj", Q, oc)
        dov = torch.diagonal(M, dim1=-2, dim2=-1)[..., None]
        bonus = (rc * uh * kc).sum(-1, keepdim=True)
        dr[:, :, sl] = pre * X1 + dri + uh * kc * dov
        dk[:, :, sl] = suf * Y1 + dki + uh * rc * dov
        dv[:, :, sl] = Z1 + Z2 + oc * bonus
        du += (rc * kc * dov).sum(2)
        # dlw: the terms whose decay spans step m, each a product (none
        # cancels): the chunk's ends, the inter and cross parts' prefix /
        # suffix sums, the sub-chunks' pairs
        e0 = tot * (Sc * G).sum(-1)
        kin, rin = kc * suf * Y1, rc * pre * X1
        kx = kc[:, :, :SUB] * sb * torch.einsum("bhts,bhti->bhsi", Mx, Rh)
        rx = rc[:, :, SUB:] * pb * torch.einsum("bhts,bhsi->bhti", Mx, Kh)
        for m in range(L):
            cross = (kx[:, :, :m].sum(2) if m < SUB
                     else rx[:, :, m + 1 - SUB:].sum(2))
            dlw[:, :, c * L + m] = (e0 + kin[:, :, :m].sum(2)
                                    + rin[:, :, m + 1:].sum(2) + cross
                                    + span[:, :, m])

    def back(t):
        return t[:, :, :S].transpose(1, 2)

    return back(dr), back(dk), back(dv), back(dlw), du.sum(0), dS0


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = float(np.linalg.norm(want))
    num = float(np.linalg.norm(got - want))
    return num / den if den else num


@pytest.mark.parametrize("decay", ["mild", "strong"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 200])
def test_chunked_bwd_matches_reference(jax_vjp, S, B, decay):
    ins = _inputs(B, S, decay, seed=S + 7 * B)
    want = jax_vjp(*ins)
    t = [torch.from_numpy(x) for x in ins]
    got = chunked_wkv6_bwd(*t)
    r, k, v, lw, u, S0, do, dS = t
    twin = kref.wkv6_scan_bwd_ref(r, k, v, torch.exp(lw), u, S0, do, dS)
    for name, g, w, p in zip(GRADS, got, want, twin):
        assert g.shape == p.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g.numpy(), w) <= LIMIT, (name, _rel(g.numpy(), w))
        assert _rel(g.numpy(), p.numpy()) <= LIMIT, (
            name, _rel(g.numpy(), p.numpy()))
    if decay == "strong" and S > 20:
        # where w underflowed the gradient of log w is 0; the raw input's
        # gradient (dlw · log w, log w ≈ −148 there) stays within 1e-5 of
        # the whole tensor's norm of the float64 reference's
        draw, want_raw = got[3].numpy() * ins[3], want[3] * ins[3]
        under = np.exp(ins[3]) == 0
        assert under.any()
        err = np.abs(draw[under] - want_raw[under]).max()
        assert err <= LIMIT * np.linalg.norm(want_raw), err


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", [32, 200])
def test_cumsum_difference_decays_miss(jax_vjp, S, B):
    """The planted form (decays as differences of the chunk's cumulative
    sums) under the strong schedule: some gradient misses 1e-5 against
    the reference."""
    ins = _inputs(B, S, "strong", seed=S + 7 * B)
    want = jax_vjp(*ins)
    got = chunked_wkv6_bwd(*(torch.from_numpy(x) for x in ins), stable=False)
    worst = max(_rel(g.numpy(), w) for g, w in zip(got, want))
    assert worst > LIMIT, worst
