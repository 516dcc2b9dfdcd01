"""The gradient of the port's attention: the autograd Function around
``ops.attention``, its LSE and the plain backward ``ref.attention_bwd_ref``.

On the CPU: the Function's gradients (the plain route: the chunked
forward with its LSE, then ``attention_bwd_ref``) and ``attention_bwd_ref``
called on its own, against ``jax.vjp`` of the reference's
``repro.kernels.ref.attention_ref`` on the same numpy-seeded inputs and
output gradient, float32, relative Frobenius error ≤ 1e-5 for each of dq,
dk and dv: causal, non-causal, window, soft cap, GQA 4/2 and 4/1, Sq ≠ Skv
with ``q_offset``, Skv off the tile (37), and rows with no live key (whose
gradient is 0). The LSE against the reference's logits' logsumexp, the
Function's plumbing (dtypes, which inputs need grad, no Function without
grad) and the refusal under autograd of the kernels without a backward
(the scans, the ELL slab product) on CUDA tensors.

On the card (marker ``cuda``, skipped elsewhere inside a fixture): the
``flash_attention_bwd`` kernel against ``attention_bwd_ref`` at head dims
64, 120, 128 and 256 in float32 (1e-5) and bfloat16 (1e-2 against the
plain backward in float32 on the same bf16 inputs), at S up to 4,097
(many tiles of both passes, off every tile size), each call on the route
``ops.attention_bwd_route`` names (bf16 at head_dim ≤ 128 on the tensor
cores), the tensor-core route's strided reads equal to contiguous ones,
the forward's LSE against the plain one, the no-grad output byte-equal
to the LSE-writing one, gradients the same bytes run to run, and the
scans and the ELL slab product raising under grad. The bf16 schedule's
CPU replay is ``tests/test_torch_attention_bwd_tc.py``. JAX is imported inside the reference comparisons only:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention_grad.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

GRAD_REL = 1e-5
# B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, cap
CASES = {
    "causal": (2, 4, 4, 48, 48, 16, True, None, 0, None),
    "non_causal": (1, 4, 4, 40, 40, 16, False, None, 0, None),
    "window": (1, 4, 2, 50, 50, 16, True, 7, 0, None),
    "soft_cap": (1, 4, 2, 33, 33, 16, True, None, 0, 5.0),
    "gqa_4_2": (2, 4, 2, 37, 37, 8, True, None, 0, None),
    "gqa_4_1": (1, 4, 1, 37, 37, 8, True, None, 0, None),
    "cross_q_offset": (1, 4, 2, 11, 37, 16, True, None, 26, None),
    "cross_non_causal": (1, 4, 2, 20, 37, 16, False, None, 0, None),
    "skv_off_tile": (1, 2, 1, 37, 37, 24, True, None, 0, None),
    "masked_rows": (1, 4, 2, 8, 37, 16, True, 3, 33, None),
}


def _inputs(B, Hq, Hkv, Sq, Skv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    g = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    return q, k, v, g


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _reference_vjp(q, k, v, g, causal, window, q_offset, cap):
    """(out, dq, dk, dv) of the reference's attention_ref through
    ``jax.vjp``."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ref import attention_ref

    def f(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, logit_soft_cap=cap)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(g))
    return (np.asarray(out),) + tuple(np.asarray(x) for x in grads)


@pytest.mark.parametrize("case", list(CASES))
def test_function_gradient_matches_reference_vjp(case):
    B, Hq, Hkv, Sq, Skv, D, causal, window, qo, cap = CASES[case]
    q, k, v, g = _inputs(B, Hq, Hkv, Sq, Skv, D)
    want = _reference_vjp(q, k, v, g, causal, window, qo, cap)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.attention(tq, tk, tv, causal=causal, window=window,
                        q_offset=qo, soft_cap=cap, chunk=16)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert _rel(out.detach(), want[0]) <= GRAD_REL
    for name, a, b in zip(("dq", "dk", "dv"), got, want[1:]):
        assert _rel(a, b) <= GRAD_REL, (case, name, _rel(a, b))
    # the plain backward on its own, from the chunked forward's LSE
    o, lse = kref.attention_chunked(tq.detach(), tk.detach(), tv.detach(),
                                    causal=causal, window=window,
                                    q_offset=qo, logit_soft_cap=cap,
                                    chunk=16, return_lse=True)
    direct = kref.attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                    o, lse, torch.from_numpy(g),
                                    causal=causal, window=window,
                                    q_offset=qo, soft_cap=cap, chunk=8)
    for name, a, b in zip(("dq", "dk", "dv"), direct, want[1:]):
        assert _rel(a, b) <= GRAD_REL, (case, name, _rel(a, b))


def test_masked_rows_get_zero_gradient():
    B, Hq, Hkv, Sq, Skv, D, causal, window, qo, cap = CASES["masked_rows"]
    q, k, v, g = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.attention(tq, tk, tv, causal=causal, window=window,
                        q_offset=qo)
    dq, = torch.autograd.grad(out, (tq,), torch.from_numpy(g))
    # queries at 39 and 40 see no key below 37 within a window of 3
    assert torch.equal(out[:, :, 6:], torch.zeros_like(out[:, :, 6:]))
    assert torch.equal(dq[:, :, 6:], torch.zeros_like(dq[:, :, 6:]))
    assert bool(torch.isfinite(dq).all())
    assert float(dq[:, :, :6].abs().max()) > 0
    _, lse = kref.attention_chunked(tq.detach(), tk, tv, window=window,
                                    q_offset=qo, return_lse=True)
    assert bool(torch.isinf(lse[:, :, 6:]).all()) and \
        bool((lse[:, :, 6:] > 0).all())


@pytest.mark.parametrize("case", ["causal", "window", "soft_cap",
                                  "cross_q_offset"])
def test_lse_matches_reference_logsumexp(case):
    import jax
    import jax.numpy as jnp
    B, Hq, Hkv, Sq, Skv, D, causal, window, qo, cap = CASES[case]
    q, k, v, _ = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=1)
    G = Hq // Hkv
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q),
                        jnp.repeat(jnp.asarray(k), G, axis=1))
    logits = logits * (1.0 / jnp.sqrt(jnp.asarray(D, jnp.float32)))
    if cap is not None:
        logits = cap * jnp.tanh(logits / cap)
    qpos = qo + np.arange(Sq)[:, None]
    kpos = np.arange(Skv)[None]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    want = jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1)
    _, lse = kref.attention_chunked(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal, window=window,
                                    q_offset=qo, logit_soft_cap=cap,
                                    chunk=16, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_function_plumbing():
    """dtypes, partial requires_grad, the ``"torch"`` and ``"ref"`` routes
    under grad, and no Function without grad."""
    q, k, v, g = _inputs(1, 4, 2, 20, 20, 8, seed=2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with torch.no_grad():
        plain = ops.attention(tq, tk, tv)
    assert plain.grad_fn is None
    assert ops.attention(tq, tk, tv).grad_fn is None     # nothing needs grad
    kk = tk.clone().requires_grad_()
    out = ops.attention(tq, kk, tv)
    assert torch.equal(out.detach(), plain)
    dk, = torch.autograd.grad(out, (kk,), torch.from_numpy(g))
    assert dk.shape == kk.shape and dk.dtype == torch.float32
    for impl in ("torch", "ref"):
        qq = tq.clone().requires_grad_()
        o2 = ops.attention(qq, tk, tv, impl=impl)
        assert type(o2.grad_fn).__name__ == "_AttentionBackward"
        torch.testing.assert_close(o2.detach(), plain, rtol=1e-6, atol=1e-6)
    # bf16 in, bf16 gradients out
    qb, kb, vb = (t.to(torch.bfloat16).requires_grad_() for t in (tq, tk, tv))
    ob = ops.attention(qb, kb, vb)
    grads = torch.autograd.grad(ob, (qb, kb, vb),
                                torch.from_numpy(g).to(torch.bfloat16))
    assert all(x.dtype == torch.bfloat16 for x in grads)
    f32 = [t.detach().float().requires_grad_() for t in (qb, kb, vb)]
    want = torch.autograd.grad(ops.attention(*f32), f32,
                               torch.from_numpy(g).to(torch.bfloat16).float())
    for a, b in zip(grads, want):
        assert _rel(a.float(), b) <= 2e-2
    with pytest.raises(ValueError, match="o .* must be q's shape"):
        ops.attention_bwd(tq, tk, tv, tq[:, :, :3], torch.zeros(1, 4, 20),
                          tq)


def test_kernels_without_backward_refuse_autograd(monkeypatch):
    """The ELL slab product has no backward: under grad with an input that
    needs grad it raises before launching (here the CPU tensors stand in
    for CUDA ones by routing the wrappers to the kernel), and without grad
    it goes on to the launch. The scan kernels have their backward: under
    grad their forwards launch with the chunk checkpoints (a ninth pointer
    that is not null) and the backward launches ``wkv6_scan_bwd`` /
    ``ssd_scan_bwd``; without grad the forwards launch without them."""
    monkeypatch.setattr(ops, "_use_kernel", lambda *a: True)
    launched = []
    monkeypatch.setattr(ops, "_launch", lambda name, dev, *a: launched.append(
        (name, a[8] is not None if name in ("wkv6_scan", "ssd_scan")
         else None)))
    B, S, H, D = 1, 40, 2, 32
    r = torch.zeros(B, S, H, D, requires_grad=True)
    args = (r, torch.zeros(B, S, H, D), torch.zeros(B, S, H, D),
            torch.zeros(B, S, H, D), torch.zeros(H, D))
    o, _ = ops.wkv6_scan(*args)
    assert o.requires_grad
    (dr,) = torch.autograd.grad(o.sum(), r)
    assert dr.shape == r.shape
    x = torch.zeros(B, S, H, D, requires_grad=True)
    sargs = (x, torch.zeros(B, S, 16), torch.zeros(B, S, 16),
             torch.zeros(B, S, H), torch.zeros(H))
    y, _ = ops.ssd_scan(*sargs)
    (dx,) = torch.autograd.grad(y.sum(), x)
    assert dx.shape == x.shape
    assert launched == [("wkv6_scan", True), ("wkv6_scan_bwd", None),
                        ("ssd_scan", True), ("ssd_scan_bwd", None)]
    idx = torch.zeros(3, 2, dtype=torch.int32)
    weight = torch.ones(3, 2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.spmv_ell_slab(idx, weight, torch.ones(3))
    launched.clear()
    with torch.no_grad():
        ops.wkv6_scan(*args)
        ops.ssd_scan(*sargs)
        ops.spmv_ell_slab(idx, weight, torch.ones(3))
    assert launched == [("wkv6_scan", False), ("ssd_scan", False),
                        ("spmv_ell_slab", None)]


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


def _cuda_inputs(dev, dtype, B, Hq, Hkv, Sq, Skv, D, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                               (B, Hkv, Skv, D), (B, Hq, Sq, D)))


def _trel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, cap
CUDA_CASES = {
    "llama_d64": (1, 8, 2, 300, 300, 64, True, None, 0, None),
    "d120": (1, 4, 2, 200, 200, 120, True, None, 0, None),
    "d128_window": (1, 4, 1, 260, 260, 128, True, 100, 0, None),
    "d256_cap": (1, 4, 2, 150, 150, 256, True, None, 0, 50.0),
    "cross_1500": (1, 4, 4, 129, 1500, 64, False, None, 0, None),
    "q_offset": (2, 4, 2, 70, 333, 64, True, None, 263, None),
    "masked_rows": (1, 4, 2, 40, 37, 64, True, 3, 33, None),
    # many tiles of both passes, Sq and Skv off every tile (64, 128, 192)
    "llama_1000": (1, 32, 8, 1000, 1000, 64, True, None, 0, None),
    "llama_4097": (1, 32, 8, 4097, 4097, 64, True, None, 0, None),
    "mha128_1000": (1, 16, 16, 1000, 1000, 128, True, None, 0, None),
    "mha128_4097": (1, 16, 16, 4097, 4097, 128, True, None, 0, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_backward_kernel_matches_plain(cuda, case, dtype):
    B, Hq, Hkv, Sq, Skv, D, causal, window, qo, cap = CUDA_CASES[case]
    dt = getattr(torch, dtype)
    q, k, v, do = _cuda_inputs(cuda, dt, B, Hq, Hkv, Sq, Skv, D)
    kw = dict(causal=causal, window=window, q_offset=qo, soft_cap=cap)
    ops.reset_launch_counts()
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.attention(qq, kk, vv, **kw)
    got = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    # bf16 at head_dim <= 128 runs the tensor-core kernels, the rest SIMT
    route = "wgmma" if dtype == "bfloat16" and D <= 128 else "simt"
    assert ops.BWD_ROUTES == {"wgmma": 0, "simt": 0, route: 1}
    assert all(g.dtype == dt for g in got)
    # the forward's LSE against the plain one, then the plain backward in
    # float32 on the same inputs, output and LSE
    o32, lse32 = kref.attention_chunked(q, k, v, causal=causal,
                                        window=window, q_offset=qo,
                                        logit_soft_cap=cap, return_lse=True)
    _, lse = ops._attention_kernel(q, k, v, causal, window, qo, cap, True)
    live = torch.isfinite(lse32)
    assert torch.equal(live, torch.isfinite(lse))
    assert float((lse - lse32)[live].abs().max()) <= 1e-4
    want = kref.attention_bwd_ref(*(t.float() for t in (q, k, v)),
                                  out.detach().float(), lse, do.float(),
                                  causal=causal, window=window, q_offset=qo,
                                  soft_cap=cap)
    lim = 1e-5 if dtype == "float32" else 1e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _trel(a, b) <= lim, (case, dtype, name, _trel(a, b))
    again = ops.attention_bwd(q, k, v, out.detach(), lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 120, 128])
def test_cuda_backward_reads_strided_views(cuda, D):
    """The tensor-core route reads q, k, v and dO through their strides:
    the model's transposed views (``[B, S, H, D]`` storage) give the same
    bytes as contiguous copies."""
    q, k, v, do = _cuda_inputs(cuda, torch.bfloat16, 2, 8, 2, 333, 333, D,
                               seed=D)
    o, lse = ops._attention_kernel(q, k, v, True, None, 0, None, True)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v, do)]
    assert not any(t.is_contiguous() for t in views)
    want = ops.attention_bwd(q, k, v, o, lse, do)
    got = ops.attention_bwd(views[0], views[1], views[2], o, lse, views[3])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(a.is_contiguous() for a in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_forward_output_same_with_lse(cuda, dtype):
    dt = getattr(torch, dtype)
    for D in (64, 120, 128, 256):
        q, k, v, _ = _cuda_inputs(cuda, dt, 1, 4, 2, 333, 333, D, seed=D)
        with torch.no_grad():
            plain = ops.attention(q, k, v)
        out, lse = ops._attention_kernel(q, k, v, True, None, 0, None, True)
        assert torch.equal(plain, out), D
        assert bool(torch.isfinite(lse).all())


@pytest.mark.cuda
def test_cuda_scans_raise_under_grad(cuda):
    """The scans carry autograd history on the card (their backward
    kernels): every input's gradient against autograd through the plain
    loops, float32, within 1e-5 (wkv6's decay given as its log, as the
    model gives it: the kernel route returns the gradient of log w); the
    ELL slab product still raises."""
    B, S, H, D = 2, 70, 2, 64
    g = torch.Generator(device=cuda).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=cuda)

    def grads(fn, inputs, cots, impl):
        ins = [t.clone().requires_grad_() for t in inputs]
        out = fn(*ins, impl=impl)
        assert all(t.requires_grad for t in out)
        return torch.autograd.grad(out, ins, cots)

    def wkv6_in_log_w(r, k, v, lw, u, S0, impl):
        return ops.wkv6_scan(r, k, v, torch.exp(lw), u, S0, impl=impl,
                             log_w=lw)

    wkv = [rn(B, S, H, D), rn(B, S, H, D), rn(B, S, H, D),
           torch.log(torch.sigmoid(rn(B, S, H, D))), rn(H, D),
           rn(B, H, D, D)]
    ssd = [rn(B, S, H, D), rn(B, S, 16), rn(B, S, 16),
           torch.nn.functional.softplus(rn(B, S, H)),
           -torch.linspace(1, 4, H, device=cuda), rn(B, H, D, 16)]
    for fn, inputs, last in ((wkv6_in_log_w, wkv, (B, H, D, D)),
                             (ops.ssd_scan, ssd, (B, H, D, 16))):
        cots = (rn(B, S, H, D), rn(*last))
        got = grads(fn, inputs, cots, "cuda")
        want = grads(fn, inputs, cots, "torch")
        for a, b in zip(got, want):
            err = _rel(a.cpu(), b.cpu())
            assert err <= 1e-5, (fn.__name__, err)
    idx = torch.zeros(16, 4, dtype=torch.int32, device=cuda)
    weight = torch.rand(16, 4, device=cuda, requires_grad=True)
    xs = torch.rand(16, device=cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.spmv_ell_slab(idx, weight, xs)
    with torch.no_grad():
        ops.spmv_ell_slab(idx, weight, xs)
