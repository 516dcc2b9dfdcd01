"""The port's RWKV-6 family (``"ssm"``, rwkv6-3b) against the reference,
on the CPU.

The reference's parameters are carried across with
``convert.model_params_from_numpy`` and the same numpy-seeded inputs go
through both packages, float32, within 1e-4: ``rwkv_time_mix`` from a
fresh and from a carried state at S = 1, 7 and 512 (512 runs the
reference's chunked scan), ``rwkv_channel_mix``, ``_group_norm``, the
plain recurrence ``ref.wkv6_scan_ref`` against the reference's step
through ``lax.scan``, and ``forward_train`` / ``decode_step`` of the
reduced rwkv6-3b. Then decode against the forward, a sequence cut in two
with its state carried against one run, the configs, ``param_count``, the
``meta`` tree against the reference's tree, and the launcher's tokens
against the reference launcher's. Marker ``cuda``: ``wkv6_scan`` against
its plain version (S = 1, 32, 33, 4,096 and 4,097; B = 1 and 4; float32
and bf16 inputs; a nonzero state) and the reduced model through the kernel
against the plain path. JAX is imported inside the reference comparisons only.
"""
import dataclasses
import functools
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.registry import (get_config, reduced_config,
                                          shape_applicable)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (ModelConfig, decode_step, forward_train,
                                init_decode_state, init_params)
from repro_torch.models import rwkv6 as trwkv

ARCH = "rwkv6-3b"
ATOL = 1e-4


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _carry(jcfg, seed=1):
    """(reference params, the port's config, its params): one set of
    weights in both packages."""
    jax, _ = _jax()
    from repro.models.transformer import init_params as jinit
    jp = jax.jit(jinit, static_argnums=0)(jcfg, jax.random.PRNGKey(seed))
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")
    return jp, tcfg, tp


@pytest.fixture(scope="module")
def reduced():
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    jcfg = jreduced(jget(ARCH))
    return (jcfg,) + _carry(jcfg)


def _layer(jp, i, name):
    jax, _ = _jax()
    return jax.tree.map(lambda a: a[i], jp["blocks"][name])


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [1, 7, 512])
def test_time_mix_matches_reference(reduced, S, carried):
    _, jnp = _jax()
    from repro.models.rwkv6 import rwkv_time_mix as jmix
    jcfg, jp, tcfg, tp = reduced
    B, d = 2, jcfg.d_model
    H, D = jcfg.ssm_heads, jcfg.ssm_head_dim
    x = _rand((B, S, d), 1)
    jstate = tstate = None
    if carried:
        xp, S0 = _rand((B, d), 2), _rand((B, H, D, D), 3, 0.1)
        jstate = (jnp.asarray(xp), jnp.asarray(S0))
        tstate = (torch.from_numpy(xp), torch.from_numpy(S0))
    want, (jx, jS) = jmix(_layer(jp, 1, "time_mix"), jnp.asarray(x), jcfg,
                          state=jstate)
    with torch.no_grad():
        got, (tx, tS) = trwkv.rwkv_time_mix(tp.blocks[1].time_mix,
                                            torch.from_numpy(x), tcfg,
                                            state=tstate)
    assert got.shape == (B, S, d) and tS.dtype == torch.float32
    _close(got, want)
    _close(tx, jx, atol=0)
    _close(tS, jS)


@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix_matches_reference(reduced, carried):
    _, jnp = _jax()
    from repro.models.rwkv6 import rwkv_channel_mix as jcm
    jcfg, jp, tcfg, tp = reduced
    x = _rand((2, 6, jcfg.d_model), 4)
    xp = _rand((2, jcfg.d_model), 5) if carried else None
    want, jx = jcm(_layer(jp, 0, "channel_mix"), jnp.asarray(x), jcfg,
                   x_prev=None if xp is None else jnp.asarray(xp))
    with torch.no_grad():
        got, tx = trwkv.rwkv_channel_mix(
            tp.blocks[0].channel_mix, torch.from_numpy(x), tcfg,
            x_prev=None if xp is None else torch.from_numpy(xp))
    _close(got, want)
    _close(tx, jx, atol=0)


def test_group_norm_and_decay_match_reference(reduced):
    _, jnp = _jax()
    from repro.models import rwkv6 as jrwkv
    jcfg, jp, tcfg, tp = reduced
    x = _rand((3, jcfg.d_model), 6) * 3 + 1
    scale = _rand((jcfg.d_model,), 7)
    want = jrwkv._group_norm(jnp.asarray(x), jnp.asarray(scale),
                             jcfg.ssm_heads, 1e-5)
    got = trwkv._group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            tcfg.ssm_heads, 1e-5)
    _close(got, want)
    xw = _rand((2, 5, jcfg.d_model), 8)
    want = jrwkv._decay(_layer(jp, 2, "time_mix"), jnp.asarray(xw),
                        jnp.float32)
    with torch.no_grad():
        got = trwkv._decay(tp.blocks[2].time_mix, torch.from_numpy(xw), tcfg)
    assert got.dtype == torch.float32
    _close(got, want, atol=1e-6)


def _jax_wkv6(r, k, v, w, u, S0):
    """The reference's step (``repro/models/rwkv6.py:121-132``) through
    ``lax.scan`` over time-major inputs."""
    jax, jnp = _jax()
    uh = jnp.asarray(u)

    def step(st, inp):
        rt, kt, vt, wt = inp
        kv = jnp.einsum("bhi,bhj->bhij", kt, vt)
        o = jnp.einsum("bhi,bhij->bhj", rt, st + uh[None, :, :, None] * kv)
        return wt[..., None] * st + kv, o

    xs = tuple(jnp.asarray(a).transpose(1, 0, 2, 3) for a in (r, k, v, w))
    S_last, outs = jax.lax.scan(step, jnp.asarray(S0), xs)
    return outs.transpose(1, 0, 2, 3), S_last


@pytest.mark.parametrize("S", [1, 7, 40])
def test_wkv6_scan_ref_matches_reference_step(S):
    B, H, D = 2, 3, 16
    r, k, v = (_rand((B, S, H, D), s) for s in (10, 11, 12))
    w = np.exp(-np.exp(_rand((B, S, H, D), 13) - 2)).astype(np.float32)
    u, S0 = _rand((H, D), 14), _rand((B, H, D, D), 15)
    want_o, want_S = _jax_wkv6(r, k, v, w, u, S0)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, S0)]
    got_o, got_S = kref.wkv6_scan_ref(*t)
    _close(got_o, want_o)
    _close(got_S, want_S)
    # the wrapper takes it for CPU tensors, and from a zero state
    o2, S2 = ops.wkv6_scan(*t[:5], None)
    o3, S3 = kref.wkv6_scan_ref(*t[:5], torch.zeros(B, H, D, D))
    assert torch.equal(o2, o3) and torch.equal(S2, S3)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.wkv6_scan(*t, impl="cuda")


def test_forward_train_matches_reference(reduced):
    jax, jnp = _jax()
    from repro.models.transformer import forward_train as jfwd
    jcfg, jp, tcfg, tp = reduced
    toks = _tokens(jcfg, 2, 16)
    want, jaux = jax.jit(jfwd, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        got, taux = forward_train(tp, {"tokens": torch.from_numpy(toks)},
                                  tcfg)
    assert got.shape == (2, 16, jcfg.vocab_size)
    assert taux == {} and dict(jaux) == {}
    _close(got, want)


def test_decode_step_matches_reference(reduced):
    jax, jnp = _jax()
    from repro.models import transformer as jt
    jcfg, jp, tcfg, tp = reduced
    toks = _tokens(jcfg, 2, 6, seed=5)
    jst = jt.init_decode_state(jp, jcfg, 2, 6)
    tst = init_decode_state(tp, tcfg, 2, 6)
    for (a, b) in zip(tst.layers, jst.layers):
        assert set(a) == set(b) == {"x_prev_tm", "S", "x_prev_cm"}
        for key in a:
            assert tuple(a[key].shape) == b[key].shape
    jstep = jax.jit(jt.decode_step, static_argnums=3)
    for t in range(6):
        want, jst = jstep(jp, jst, jnp.asarray(toks[:, t]), jcfg)
        got, tst = decode_step(tp, tst, torch.from_numpy(toks[:, t]), tcfg)
        _close(got, want)
    assert tst.pos == int(jst.pos) == 6
    for a, b in zip(tst.layers, jst.layers):
        _close(a["S"], b["S"])


def test_decode_matches_forward():
    """The serving invariant: step-by-step decode reproduces the forward's
    logits at every position."""
    cfg = reduced_config(get_config(ARCH))
    params = init_params(cfg, 3, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=9))
    with torch.no_grad():
        logits, _ = forward_train(params, {"tokens": toks}, cfg)
    st = init_decode_state(params, cfg, 2, 12)
    errs = []
    for t in range(12):
        lg, st = decode_step(params, st, toks[:, t], cfg)
        errs.append(float((lg - logits[:, t]).abs().max()))
    assert max(errs) < 3e-4, errs
    assert st.layers[0]["S"].dtype == torch.float32
    assert st.layers[0]["x_prev_tm"].dtype == torch.float32   # cfg.dtype


@pytest.mark.parametrize("S", [2, 9, 24])
def test_state_carry_equals_full_run(S):
    """``tests/test_models.py::test_rwkv_state_carry_equals_full_run`` on
    the port: a sequence split at S // 2 with its state carried gives the
    one run's output."""
    cfg = ModelConfig(family="ssm", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=4, d_ff=128, vocab_size=128,
                      ssm_head_dim=16, dtype="float32")
    layer = init_params(cfg, 2, device="cpu").blocks[0].time_mix
    x = torch.from_numpy(_rand((1, S, cfg.d_model), 16))
    with torch.no_grad():
        full, (_, S_full) = trwkv.rwkv_time_mix(layer, x, cfg)
        cut = S // 2
        a, st = trwkv.rwkv_time_mix(layer, x[:, :cut], cfg)
        b, (_, S_b) = trwkv.rwkv_time_mix(layer, x[:, cut:], cfg, state=st)
    _close(torch.cat([a, b], dim=1), full.numpy())
    _close(S_b, S_full.numpy())


@pytest.mark.parametrize("full", [True, False])
def test_configs_match_reference(full):
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    from repro.configs.registry import shape_applicable as japplicable
    jc = jget(ARCH) if full else jreduced(jget(ARCH))
    tc = get_config(ARCH) if full else reduced_config(get_config(ARCH))
    for f in dataclasses.fields(ModelConfig):
        if f.name != "attn_impl":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.param_count == jc.param_count
    assert tc.is_attention_free and jc.is_attention_free
    assert tc.subquadratic and jc.subquadratic
    assert shape_applicable(tc, "long_500k") == \
        japplicable(jc, "long_500k") == (True, "")
    assert convert.model_config_from_reference(
        dataclasses.asdict(jc)) == dataclasses.replace(tc, attn_impl="torch")
    if full:
        assert (tc.ssm_heads, tc.ssm_head_dim) == (40, 64)
        assert tc.param_count == 2_862_612_480


def test_param_tree_matches_reference_tree():
    """The full config's tree (built without storage) holds the
    reference's tree, leaf for leaf: 2,863,516,160 parameters, 903,680
    more than the analytic count."""
    jax, _ = _jax()
    from repro.configs.registry import get_config as jget
    from repro.models.transformer import init_params as jinit
    jcfg, cfg = jget(ARCH), get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jinit(jcfg, k),
                            jax.ShapeDtypeStruct((2,), np.uint32))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    params = init_params(cfg, device="meta")
    named = dict(params.named_parameters())
    assert sum(p.numel() for p in named.values()) == want == 2_863_516_160
    assert want - cfg.param_count == 903_680
    tm = shapes["blocks"]["time_mix"]
    for name, leaf in tm.items():
        got = tuple(named["blocks.0.time_mix." + name].shape)
        assert got == (leaf.shape[1:][::-1]), name       # [out, in] or [d]
    assert not any(".attn." in n for n in named)


def test_launcher_tokens_equal_reference_launcher(monkeypatch, capsys):
    """``--arch rwkv6-3b --smoke --device cpu`` with the reference
    launcher's weights carried across: its tokens are the reference
    launcher's, request for request."""
    jax, _ = _jax()
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    from repro.launch import serve as jserve
    from repro.models.transformer import init_params as jinit
    from repro.serving import scheduler as jsched
    jinit = jax.jit(jinit, static_argnums=0)
    monkeypatch.setattr(jserve, "init_params", jinit)
    monkeypatch.setattr(jsched, "serve_step", jax.jit(
        jsched.serve_step, static_argnames=("cfg", "temperature", "top_k")))
    argv = ["--arch", ARCH, "--smoke", "--requests", "3", "--max-new", "4"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    lines = capsys.readouterr().out
    want = {int(r): [int(t) for t in toks.split(",")]
            for r, toks in re.findall(r"req (\d+): \d+ tokens → \[([^]]*)\]",
                                      lines)}
    assert sorted(want) == list(range(3))
    jcfg = jreduced(jget(ARCH))

    def carried(cfg, seed, device):
        assert cfg.name == jcfg.name
        tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
        return convert.model_params_from_numpy(tree, cfg, device=device)

    monkeypatch.setattr(launch_serve, "init_params", carried)
    done = launch_serve.main(argv + ["--device", "cpu"])
    assert "rwkv6-3b-smoke on cpu" in capsys.readouterr().out
    assert {r.rid: r.output for r in done} == want


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _check_wkv6_scan(cuda, B, S, H, D, dtype, seed):
    """The kernel against its plain version on the same inputs (r, k, v in
    ``dtype``, w, u, a nonzero state and a zero one): the outputs and the
    final state within 1e-5 relative Frobenius error (float32 sums in
    another order; bf16 outputs within one rounding, 4e-3)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    r, k, v = (torch.randn(B, S, H, D, generator=g, device=cuda).to(dt)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, S, H, D, generator=g,
                                         device=cuda) - 4))
    u = torch.randn(H, D, generator=g, device=cuda) * 0.1
    S0 = torch.randn(B, H, D, D, generator=g, device=cuda)
    before = ops.launch_counts()["wkv6_scan"]
    o, S_last = ops.wkv6_scan(r, k, v, w, u, S0, impl="cuda")
    torch.cuda.synchronize()
    assert ops.launch_counts()["wkv6_scan"] == before + 1
    want_o, want_S = kref.wkv6_scan_ref(r, k, v, w, u, S0)
    assert o.dtype == dt and S_last.dtype == torch.float32
    assert _rel(S_last, want_S) <= 1e-5
    assert _rel(o.float(), want_o.float()) <= (1e-5 if dtype == "float32"
                                               else 4e-3)
    o0, _ = ops.wkv6_scan(r, k, v, w, u, None, impl="cuda")
    want0, _ = kref.wkv6_scan_ref(r, k, v, w, u, None)
    assert _rel(o0.float(), want0.float()) <= (1e-5 if dtype == "float32"
                                               else 4e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [1, 32, 33, 4096, 4097])
def test_cuda_wkv6_scan_matches_plain(cuda, S, B, dtype):
    """:func:`_check_wkv6_scan` at rwkv6-3b's head shape. S = 1 runs the
    serial kernel, the rest the pipelined one: one chunk of 32 steps, one
    and a step, whole chunks, and a last chunk of one step."""
    _check_wkv6_scan(cuda, B, S, 40, 64, dtype, seed=S + B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 33, 4097])
@pytest.mark.parametrize("D", ops.WKV6_HEAD_DIMS)
def test_cuda_wkv6_scan_every_head_dim(cuda, D, S, dtype):
    """:func:`_check_wkv6_scan` at every head dim the wrapper accepts (the
    kernel's lanes are D / 4 row groups × 128 / D column groups, and
    D = 128 sums its readout with one more shuffle stage), 4 heads."""
    _check_wkv6_scan(cuda, 2, S, 4, D, dtype, seed=S + D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_forward_kernel_matches_plain_path(cuda, dtype, monkeypatch):
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dtype)
    params = init_params(cfg, 0, device=cuda)
    toks = torch.from_numpy(_tokens(cfg, 2, 100)).to(cuda)
    before = ops.launch_counts()["wkv6_scan"]
    with torch.inference_mode():
        got, _ = forward_train(params, {"tokens": toks}, cfg)
        with monkeypatch.context() as m:
            m.setattr(ops, "wkv6_scan",
                      functools.partial(ops.wkv6_scan, impl="torch"))
            want, _ = forward_train(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["wkv6_scan"] == before + cfg.num_layers
    assert _rel(got.float(), want.float()) <= (
        5e-2 if dtype == "bfloat16" else 1e-5)
    st = init_decode_state(params, cfg, 2, 100)
    if dtype == "float32":
        for t in range(8):
            lg, st = decode_step(params, st, toks[:, t], cfg)
            assert float((lg - got[:, t]).abs().max()) < 3e-4
