"""The recurrent families' gradients: ``models/scan_utils.chunked_scan``,
the plain backward twins of the two scans, and the RWKV-6 and Mamba-2
blocks' gradients against the reference's, on the CPU.

* ``chunked_scan`` gives the plain loop's values (the same bytes) and
  gradients at S ≤ chunk, S % chunk ≠ 0 and three whole chunks; under
  autograd its segments run under ``torch.utils.checkpoint``, handed the
  carries at the segment boundaries, and nothing inside a segment is
  saved for the backward (counted with ``saved_tensors_hooks``).
* ``ref.wkv6_scan_bwd_ref`` and ``ref.ssd_scan_bwd_ref`` (the backward
  kernels' plain twins: chunks of 32 steps, states recomputed from the
  chunk checkpoints, the reverse recurrence) equal ``torch.autograd.grad``
  through the plain loops within 1e-5 relative Frobenius error, at S = 1,
  31, 32, 33 and 65, B = 2, from a nonzero state with a nonzero state
  gradient, and with strong decays (w = 0 at some steps; Δ·a below −87 at
  some steps), every gradient finite; the wkv6 twin's decay gradient is
  that of log w (the loop fed ``exp(log w)``).
* ``rwkv_time_mix`` and ``mamba2_forward`` of the reduced rwkv6-3b and
  zamba2-1.2b: the gradient of every parameter and of x (cotangents on
  the output and the final state) against ``jax.vjp`` of the reference's
  blocks, float32, within 1e-4 relative Frobenius error; at S = 512 and
  128 both sides run their chunked scans with checkpoints.

Marker ``cuda``: the ``wkv6_scan_bwd`` and ``ssd_scan_bwd`` kernels
against their plain twins at every head dim and state size the forwards
accept, S = 1, 33 and 4,097, B = 2, float32 (1e-5) and bf16 (1e-2 against
the float32 twin on the same inputs), repeats byte-equal, and each
backward's chunk-end state gradients (its scratch) against the twin's
gradient of the state that starts the steps after each; each chunked
backward's own cases (``WKV6_BWD_CASES``: strong decays with w = 0 on
some channels, where dlw must be 0 exactly, D = 128 off the chunk, B = 1
at S = 4,097; ``SSD_BWD_CASES``); the forwards' chunk checkpoints
against the plain states, and their outputs byte-equal with and without
them. JAX is imported inside the reference comparisons only. The CPU
tests also hold the time mix's ``w`` to ``exp(−exp(raw))`` byte for byte
and the wkv6 kernel route to its ``log_w`` contract.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import scan_utils


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain loops run thousands of small torch ops: on one thread
    they do not wait on a thread pool that XLA's workers also hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float(a.norm())


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


# --- chunked_scan -----------------------------------------------------------


def _step(carry, inp):
    a, b = inp
    carry = a * carry + torch.tanh(b)
    return carry, carry * b


def _linear_inputs(S):
    a = torch.sigmoid(_rand((S, 2, 3), 1)).requires_grad_()
    b = _rand((S, 2, 3), 2).requires_grad_()
    c0 = _rand((2, 3), 3).requires_grad_()
    return c0, a, b


@pytest.mark.parametrize("S", [8, 12, 24])
def test_chunked_scan_matches_plain_loop(S):
    """S = 8: one chunk (the plain loop); 12: not a multiple of the chunk
    (the plain loop); 24: three checkpointed segments."""
    c0, a, b = _linear_inputs(S)
    carry, ys = scan_utils.chunked_scan(_step, c0, (a, b), chunk=8)
    want_c, want_y = scan_utils._scan(_step, c0, (a, b))
    assert torch.equal(carry, want_c) and torch.equal(ys, want_y)
    g = _rand(ys.shape, 4)
    got = torch.autograd.grad((ys, carry), (c0, a, b), (g, carry))
    want = torch.autograd.grad((want_y, want_c), (c0, a, b), (g, want_c))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        nc, ny = scan_utils.chunked_scan(_step, c0, (a, b), chunk=8)
    assert torch.equal(nc, want_c) and torch.equal(ny, want_y)


def test_chunked_scan_keeps_segment_boundaries(monkeypatch):
    """Three segments of 8: ``checkpoint`` is called once a segment with
    the carry at its start (the plain loop's states at t = 0, 8 and 16),
    and what is packed for the backward is each segment's inputs alone,
    that carry and its slices of the inputs, where the plain loop packs
    tensors of every step."""
    S, chunk = 24, 8
    c0, a, b = _linear_inputs(S)
    states = [c0]
    with torch.no_grad():
        for t in range(S):
            states.append(_step(states[-1], (a[t], b[t]))[0])
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, carry, *xs, **kw):
        calls.append(carry.detach().clone())
        return real(fn, carry, *xs, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)

    def packed(run):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.detach().clone()) or t,
                lambda t: t):
            out = run()
        return saved, out

    chunked, (carry, ys) = packed(
        lambda: scan_utils.chunked_scan(_step, c0, (a, b), chunk=chunk))
    plain, _ = packed(lambda: scan_utils._scan(_step, c0, (a, b)))
    assert len(calls) == S // chunk
    for i, c in enumerate(calls):
        assert torch.equal(c, states[i * chunk]), i
    assert len(plain) >= S
    assert len(chunked) == 3 * (S // chunk), [t.shape for t in chunked]
    for i in range(S // chunk):
        carry_i, a_i, b_i = chunked[3 * i:3 * i + 3]
        assert torch.equal(carry_i, states[i * chunk]), i
        assert torch.equal(a_i, a[i * chunk:(i + 1) * chunk].detach())
        assert torch.equal(b_i, b[i * chunk:(i + 1) * chunk].detach())
    # the backward runs each segment again and gives the plain gradients
    g = torch.autograd.grad(ys.sum(), (c0, a, b))
    want_c, want_y = scan_utils._scan(_step, c0, (a, b))
    want = torch.autograd.grad(want_y.sum(), (c0, a, b))
    for x, y in zip(g, want):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


# --- the backward twins ------------------------------------------------------


def _wkv6_inputs(B, S, H, D, strong, seed):
    r, k, v = (_rand((B, S, H, D), seed + i) for i in range(3))
    w = torch.sigmoid(_rand((B, S, H, D), seed + 3))
    if strong:   # w = exp(−exp(·)) underflowed to 0 at every third step
        w[:, ::3] = 0.0
    u = _rand((H, D), seed + 4)
    S0 = _rand((B, H, D, D), seed + 5, 0.5)
    return r, k, v, w, u, S0


def _ssd_inputs(B, S, H, D, n, strong, seed):
    x = _rand((B, S, H, D), seed)
    Bv, Cv = _rand((B, S, n), seed + 1), _rand((B, S, n), seed + 2)
    dt = torch.nn.functional.softplus(_rand((B, S, H), seed + 3) - 1)
    a = -torch.linspace(1.0, 4.0, H)
    if strong:   # Δ·a ≈ −120 at every fourth step: the decay underflows
        dt[:, ::4] = 40.0
    h0 = _rand((B, H, D, n), seed + 4, 0.5)
    return x, Bv, Cv, dt, a, h0


def _autograd(fn, inputs, seed):
    """The plain loop's gradients under autograd, with random cotangents
    on the output and the final state: ``(cotangents, gradients)``."""
    ins = [t.clone().requires_grad_() for t in inputs]
    out, last = fn(*ins)
    cots = (_rand(out.shape, seed + 10), _rand(last.shape, seed + 11))
    return cots, torch.autograd.grad((out, last), ins, cots)


def _wkv6_in_log_w(r, k, v, lw, u, S0):
    """``ref.wkv6_scan_ref`` with the decay given as its log (``w =
    exp(log w)``, as the model forms it), so that autograd's gradient of
    the fourth input is the gradient of log w."""
    return kref.wkv6_scan_ref(r, k, v, torch.exp(lw), u, S0)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 65])
def test_wkv6_bwd_ref_matches_autograd(S, strong):
    r, k, v, w, u, S0 = _wkv6_inputs(2, S, 3, 8, strong, seed=S)
    inputs = (r, k, v, torch.log(w), u, S0)   # log 0 = −inf: w = 0
    (do, dS), want = _autograd(_wkv6_in_log_w, inputs, seed=S)
    got = kref.wkv6_scan_bwd_ref(r, k, v, torch.exp(inputs[3]), u, S0, do,
                                 dS)
    assert [g.shape for g in got] == [t.shape for t in inputs]
    for name, g, w in zip(("dr", "dk", "dv", "dlw", "du", "dS0"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 65])
def test_ssd_bwd_ref_matches_autograd(S, strong):
    inputs = _ssd_inputs(2, S, 3, 8, 4, strong, seed=S)
    (dy, dh), want = _autograd(kref.ssd_scan_ref, inputs, seed=S)
    got = kref.ssd_scan_bwd_ref(*inputs, dy, dh)
    assert [g.shape for g in got] == [t.shape for t in inputs]
    for name, g, w in zip(("dx", "dB", "dC", "ddt", "da", "dh0"), got,
                          want):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


def test_bwd_refs_without_state():
    """No starting state and no state gradient: zeros for both, and the
    carried gradient is still returned (the gradient of a zero start)."""
    r, k, v, w, u, _ = _wkv6_inputs(1, 5, 2, 4, False, seed=7)
    do = _rand(r.shape, 8)
    got = kref.wkv6_scan_bwd_ref(r, k, v, w, u, None, do)
    want = kref.wkv6_scan_bwd_ref(r, k, v, w, u, torch.zeros(1, 2, 4, 4),
                                  do, torch.zeros(1, 2, 4, 4))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x, Bv, Cv, dt, a, _ = _ssd_inputs(1, 5, 2, 4, 4, False, seed=9)
    dy = _rand(x.shape, 10)
    got = kref.ssd_scan_bwd_ref(x, Bv, Cv, dt, a, None, dy)
    want = kref.ssd_scan_bwd_ref(x, Bv, Cv, dt, a, torch.zeros(1, 2, 4, 4),
                                 dy, torch.zeros(1, 2, 4, 4))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_decay_is_exp_of_log_decay():
    """The time mix forms ``log w = −exp(raw)`` and ``w = exp(log w)``: the
    same two torch operations as ``exp(−exp(raw))``, so w keeps its
    bytes."""
    from repro_torch.configs.registry import get_config, reduced_config
    cfg = reduced_config(get_config("rwkv6-3b"))
    params = trwkv.RWKVTimeMix(cfg, torch.device("cpu"),
                               torch.Generator().manual_seed(4))
    with torch.no_grad():
        params.w0.copy_(_rand(params.w0.shape, 5, 3.0))
        xw = _rand((2, 7, cfg.d_model), 6)
        lw = trwkv._log_decay(params, xw, cfg)
        a = torch.tanh(torch.nn.functional.linear(
            xw, trwkv.compute_weight(params, "w_lora_a", cfg)))
        raw = params.w0.float() + torch.nn.functional.linear(
            a, trwkv.compute_weight(params, "w_lora_b", cfg)).float()
        w = trwkv._decay(params, xw, cfg)
    assert lw.dtype == w.dtype == torch.float32
    assert torch.equal(w, torch.exp(-torch.exp(raw)))
    assert torch.equal(w, torch.exp(lw))


def test_wkv6_kernel_route_needs_log_w(monkeypatch):
    """On the kernel route (the CPU tensors routed to it, launches
    recorded) a call whose w requires grad raises a ValueError naming
    log_w; given log_w, the backward kernel launches and the decay's
    gradient reaches log_w, none reaching w; called directly, the backward
    refuses a missing log_w."""
    monkeypatch.setattr(ops, "_use_kernel", lambda *a: True)
    launched = []
    monkeypatch.setattr(ops, "_launch",
                        lambda name, dev, *a: launched.append(name))
    B, S, H, D = 1, 40, 2, 32
    r, k, v, u = (_rand(shape, i) for i, shape in enumerate(
        ((B, S, H, D),) * 3 + ((H, D),)))
    raw = _rand((B, S, H, D), 9).requires_grad_()
    lw = -torch.exp(raw)
    w = torch.exp(lw)
    with pytest.raises(ValueError, match="log_w"):
        ops.wkv6_scan(r, k, v, w, u)
    assert launched == []
    o, _ = ops.wkv6_scan(r, k, v, w, u, log_w=lw)
    (graw,) = torch.autograd.grad(o.sum(), raw)
    assert graw.shape == raw.shape
    assert launched == ["wkv6_scan", "wkv6_scan_bwd"]
    with pytest.raises(ValueError, match="log_w"):
        ops.wkv6_scan_bwd(r, k, v, w.detach(), u, None, torch.zeros_like(r),
                          ckpt=torch.zeros(B, H, 2, D, D), impl="cuda")


# --- the blocks against jax.vjp of the reference's ---------------------------


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


@pytest.fixture(scope="module")
def blocks():
    """Reduced rwkv6-3b and zamba2-1.2b: the reference's config and
    parameters, the port's config and parameters carried across."""
    jax, _ = _jax()
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    from repro.models.transformer import init_params as jinit
    out = {}
    for arch in ("rwkv6-3b", "zamba2-1.2b"):
        jcfg = jreduced(jget(arch))
        jp = jax.jit(jinit, static_argnums=0)(jcfg, jax.random.PRNGKey(2))
        tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
        tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                             tcfg, device="cpu")
        out[arch] = (jcfg, jp, tcfg, tp)
    return out


def _vjp_check(jfn, jlayer, tmodule, tfn, x, transpose, seed):
    """The reference block's ``jax.vjp`` against the port's autograd, with
    the same cotangents on the output and the final state: every
    parameter's gradient and x's within 1e-4 relative Frobenius error
    (float32 sums over B·S terms in another order on each side)."""
    jax, jnp = _jax()
    out, (carry, last) = jax.eval_shape(jfn, jlayer, jnp.asarray(x))
    g_out = np.asarray(_rand(out.shape, seed))
    g_last = np.asarray(_rand(last.shape, seed + 1, 0.1))

    @jax.jit
    def grads(p, xx, go, gl):    # one compiled program: eager vjp is slow
        _, vjp = jax.vjp(jfn, p, xx)
        return vjp((go, (jnp.zeros(carry.shape, carry.dtype), gl)))

    jgp, jgx = grads(jlayer, jnp.asarray(x), jnp.asarray(g_out),
                     jnp.asarray(g_last))
    want = convert._leaves("", jax.tree.map(np.asarray, jgp),
                           transpose=transpose)
    xt = torch.from_numpy(x).requires_grad_()
    tout, (_, tlast) = tfn(tmodule, xt)
    names = [n for n, _ in tmodule.named_parameters()]
    grads = torch.autograd.grad(
        (tout, tlast), [*tmodule.parameters(), xt],
        (torch.from_numpy(g_out), torch.from_numpy(g_last)))
    assert set(names) == set(want)
    want = dict(want, x=np.asarray(jgx))
    for name, g in zip(names + ["x"], grads):
        err = _rel(g, torch.from_numpy(np.array(want[name])))
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("S", [512])
def test_time_mix_grads_match_reference(blocks, S):
    jax, _ = _jax()
    from repro.models.rwkv6 import rwkv_time_mix as jmix
    jcfg, jp, tcfg, tp = blocks["rwkv6-3b"]
    layer = jax.tree.map(lambda a: a[1], jp["blocks"]["time_mix"])
    x = _rand((2, S, jcfg.d_model), 21).numpy()
    _vjp_check(lambda p, xx: jmix(p, xx, jcfg), layer,
               tp.blocks[1].time_mix,
               lambda m, xx: trwkv.rwkv_time_mix(m, xx, tcfg), x,
               convert._TIME_MIX_MATRICES, seed=S)


@pytest.mark.parametrize("S", [128])
def test_mamba2_grads_match_reference(blocks, S):
    jax, _ = _jax()
    from repro.models.mamba2 import mamba2_forward as jmamba
    jcfg, jp, tcfg, tp = blocks["zamba2-1.2b"]
    layer = jax.tree.map(lambda a: a[1], jp["blocks"]["mamba"])
    x = _rand((2, S, jcfg.d_model), 22).numpy()
    _vjp_check(lambda p, xx: jmamba(p, xx, jcfg), layer,
               tp.blocks[1].mamba,
               lambda m, xx: tmamba.mamba2_forward(m, xx, tcfg), x,
               convert._MAMBA_MATRICES, seed=S)


@pytest.mark.parametrize("B,S,H,D,n", [(2, 4096, 64, 64, 64),
                                         (1, 32768, 64, 64, 64),
                                         (2, 33, 2, 64, 128),
                                         (3, 1, 5, 32, 16)])
def test_ssd_bwd_groups_and_scratch(B, S, H, D, n):
    """The chunk pass's head groups fill the card (two CTAs for each of 132
    SMs, or one group a head) and every group holds a head; at zamba2-1.2b's
    heads (64 of 64, n = 64; training 2 × 4,096 and 1 × 32,768) the scratch
    is at most the serial design's (2·H·NR·B·S·n + NR·B·S·H + NR·B·H
    float32, NR = D / 32 row blocks), 537 MB at the training shape."""
    nch = -(-S // 32)
    groups = ops.ssd_bwd_groups(B, nch, H)
    hpc = -(-H // groups)
    assert 1 <= groups <= H and -(-H // hpc) == groups
    assert B * nch * groups >= 264 or hpc == 1
    if (H, D, n) == (64, 64, 64):
        serial = 2 * H * 2 * B * S * n + 2 * B * S * H + 2 * B * H
        assert ops.ssd_bwd_scratch(B, S, H, D, n) <= serial


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


def _cuda_scan_inputs(kernel, dev, B, S, H, D, n, dtype, seed,
                      strong=False):
    """A kernel's inputs on the card (r, k, v or x, B, C in ``dtype``; a
    nonzero starting state), float32 cotangents of its outputs and the
    backward's keywords (wkv6: ``log_w``, w = exp(log w)). ``strong``
    (ssd): a = −16 and Δ = 8 over the first 16 steps of every 32, so that
    a chunk's sum of Δ·a reaches −2,048 (each burst step's decay
    underflows to 0), then Δ ≈ 0.002; (wkv6) log w = −exp(raw) with raw =
    7.6 (log w ≈ −2,000) on the even key channels at every chunk's step
    3 and raw = 5 (w = 0 in float32) on channels 1 mod 4 at its step 20."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    if kernel == "wkv6":
        r, k, v = (rn(B, S, H, D).to(dtype) for _ in range(3))
        raw = rn(B, S, H, D) - 1
        if strong:
            t = torch.arange(S, device=dev)[None, :, None, None] % 32
            ch = torch.arange(D, device=dev)
            raw = torch.where((t == 3) & (ch % 2 == 0), 7.6, raw)
            raw = torch.where((t == 20) & (ch % 4 == 1), 5.0, raw)
        lw = -torch.exp(raw)
        args = [r, k, v, torch.exp(lw), rn(H, D), rn(B, H, D, D, scale=0.5)]
        cot = [rn(B, S, H, D).to(dtype), rn(B, H, D, D)]
        return args, cot, {"log_w": lw}
    else:
        x = rn(B, S, H, D).to(dtype)
        Bv, Cv = (rn(B, S, n).to(dtype) for _ in range(2))
        dt = torch.nn.functional.softplus(rn(B, S, H) - 2)
        a = -torch.linspace(1, 16, H, device=dev)
        if strong:
            burst = (torch.arange(S, device=dev) % 32 < 16)[None, :, None]
            dt = torch.where(burst, 8.0, 0.002 * (1 + 0.1 * rn(B, S, H)))
            a = torch.full((H,), -16.0, device=dev)
        args = [x, Bv, Cv, dt, a, rn(B, H, D, n, scale=0.5)]
        cot = [rn(B, S, H, D), rn(B, H, D, n)]
    return args, cot, {}


class _DevicePointer:
    """``count`` float32 values at a device address, for ``torch.as_tensor``
    (``__cuda_array_interface__``)."""

    def __init__(self, ptr, count):
        self.__cuda_array_interface__ = {"shape": (count,), "typestr": "<f4",
                                         "data": (ptr, False), "version": 2}


def _bwd_chunk_ends(kernel, args, cot, ckpt, kw):
    """One backward launch on the card and a copy of the chunk-end state
    gradients it left in its scratch (the first B·H·⌈S/32⌉·D·n floats,
    ``[B, H, ⌈S/32⌉, D, n]``, n = D for wkv6), taken while the call holds
    it."""
    ends = []
    orig = ops._launch
    name = f"{kernel}_scan_bwd"

    def launch(nm, device, *a):
        orig(nm, device, *a)
        if nm == name:
            B, S, H, D = a[15:19]
            n = D if kernel == "wkv6" else a[19]
            shape = (B, H, -(-S // 32), D, n)
            view = _DevicePointer(a[14], int(np.prod(shape)))
            ends.append(torch.as_tensor(view, device=device).clone()
                        .view(shape))

    ops._launch = launch
    try:
        getattr(ops, name)(*args, *cot, ckpt=ckpt, impl="cuda", **kw)
    finally:
        ops._launch = orig
    return ends[0]


def _check_scan_bwd(kernel, dev, S, D, n, dtype, strong=False, B=2):
    dt = getattr(torch, dtype)
    H = 2
    args, cot, kw = _cuda_scan_inputs(kernel, dev, B, S, H, D, n, dt,
                                      seed=S + D + n, strong=strong)
    bwd, fwd, checked = ((ops.wkv6_scan_bwd, ops._wkv6_kernel,
                          ops._wkv6_operands) if kernel == "wkv6" else
                         (ops.ssd_scan_bwd, ops._ssd_kernel,
                          ops._ssd_operands))
    ckpt = fwd(*checked(kernel, *args), checkpoints=True)[2]
    name = f"{kernel}_scan_bwd"
    before = ops.launch_counts()[name]
    got = bwd(*args, *cot, ckpt=ckpt, impl="cuda", **kw)
    again = bwd(*args, *cot, ckpt=ckpt, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 2
    f32 = [t if t is None else t.float() for t in args + cot]
    want = bwd(*f32, ckpt=None, impl="torch")
    lim = 1e-5 if dtype == "float32" else 1e-2
    for i, (a, b, c) in enumerate(zip(got, again, want)):
        assert a.dtype == (args[i].dtype if i < 5 else torch.float32), i
        assert torch.equal(a, b), f"gradient {i} differs run to run"
        assert bool(torch.isfinite(a).all()), i
        assert _rel(a, c) <= lim, (i, _rel(a, c))
    if kernel == "wkv6" and strong:
        # where w underflowed, the gradient of log w (and of raw, dlw · log
        # w) is 0, as the twin's w ∘ rowsum(G ∘ S) is: no residue
        under = args[3] == 0
        assert bool(under.any())
        assert not bool(got[3][under].any()), got[3][under].abs().max()
        assert not bool(want[3][under].any())
    # the chunked route: the gradient of the state after each chunk, in
    # its scratch, is the final state's for the last chunk and, for the
    # three before it, the plain twin's dS0 / dh0 of the steps that follow
    ends = _bwd_chunk_ends(kernel, args, cot, ckpt, kw)
    nch = ends.shape[2]
    assert torch.equal(ends[:, :, -1], cot[1])
    for c in range(max(nch - 4, 0), nch - 1):
        s0 = 32 * (c + 1)
        tail = [t[:, s0:] for t in f32[:4]]
        dh = bwd(*tail, f32[4], ckpt[:, :, c + 1], f32[6][:, s0:],
                 f32[7], ckpt=None, impl="torch")[5]
        assert _rel(ends[:, :, c], dh) <= lim, (c, _rel(ends[:, :, c], dh))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 33, 4097])
@pytest.mark.parametrize("D", ops.WKV6_HEAD_DIMS)
def test_cuda_wkv6_bwd_matches_plain(cuda, D, S, dtype):
    _check_scan_bwd("wkv6", cuda, S, D, 0, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 33, 4097])
@pytest.mark.parametrize("n", ops.SSD_STATES)
def test_cuda_ssd_bwd_matches_plain(cuda, n, S, dtype):
    _check_scan_bwd("ssd", cuda, S, 64 if n > 16 else 32, n, dtype)


# the chunked wkv6 backward's own cases: strong decays, w underflowing to
# 0 on some channels; D = 128 (S_c and G_e in slices) off the chunk (3
# chunks and a step); one batch row a chunk and a step past 4,096
WKV6_BWD_CASES = {"strong": dict(S=200, D=64, strong=True),
                  "d128_off_chunk": dict(S=97, D=128),
                  "b1_long": dict(S=4097, D=64, B=1)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(WKV6_BWD_CASES))
def test_cuda_wkv6_bwd_chunked_cases(cuda, case, dtype):
    c = WKV6_BWD_CASES[case]
    _check_scan_bwd("wkv6", cuda, c["S"], c["D"], 0, dtype,
                    strong=c.get("strong", False), B=c.get("B", 2))


# the chunked ssd backward's own cases: strong decays; n = 128 off the
# chunk (3 chunks and a step); a grid with one head group (B · chunks ≥
# 264: dB and dC written by the chunk pass, no partials)
SSD_BWD_CASES = {"strong": dict(S=200, n=64, strong=True),
                 "n128_off_chunk": dict(S=97, n=128),
                 "one_head_group": dict(S=8448, n=16)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SSD_BWD_CASES))
def test_cuda_ssd_bwd_chunked_cases(cuda, case, dtype):
    c = SSD_BWD_CASES[case]
    if case == "one_head_group":
        assert ops.ssd_bwd_groups(2, -(-c["S"] // 32), 2) == 1
    _check_scan_bwd("ssd", cuda, c["S"], 64 if c["n"] > 16 else 32, c["n"],
                    dtype, strong=c.get("strong", False))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 33, 4097])
def test_cuda_forward_checkpoints(cuda, S):
    """The forwards' chunk checkpoints equal the plain states before every
    32-step chunk (1e-5), and the outputs written beside them are the
    no-grad call's bytes."""
    for kernel, D, n in (("wkv6", 64, 0), ("ssd", 64, 64)):
        args, _, _ = _cuda_scan_inputs(kernel, cuda, 2, S, 3, D, n,
                                       torch.float32, seed=S)
        fwd, ops_args = ((ops._wkv6_kernel, ops._wkv6_operands)
                         if kernel == "wkv6" else
                         (ops._ssd_kernel, ops._ssd_operands))
        checked = ops_args(kernel, *args)
        out, last, ckpt = fwd(*checked, checkpoints=True)
        plain_out, plain_last, none = fwd(*checked, checkpoints=False)
        torch.cuda.synchronize()
        assert none is None
        assert torch.equal(out, plain_out) and torch.equal(last, plain_last)
        ref_fn = kref.wkv6_scan_ref if kernel == "wkv6" else kref.ssd_scan_ref
        want = args[5]
        for c in range(ckpt.shape[2]):
            assert _rel(ckpt[:, :, c], want) <= 1e-5, (kernel, c)
            cut = [t[:, 32 * c:32 * (c + 1)] if i < 4 else t
                   for i, t in enumerate(args[:5])]
            want = ref_fn(*cut, want)[1]
