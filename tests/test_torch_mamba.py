"""The port's Mamba-2 hybrid family (``"hybrid"``, zamba2-1.2b) against the
reference, on the CPU.

The reference's parameters are carried across with
``convert.model_params_from_numpy`` and the same numpy-seeded inputs go
through both packages, float32, within 1e-4: ``mamba2_forward`` at S = 1,
7 and 128 with and without a carried conv buffer and state (128 runs the
reference's chunked scan), ``_causal_conv``, ``_gated_rmsnorm``, the plain
recurrence ``ref.ssd_scan_ref`` against the reference's step through
``lax.scan``, and ``forward_train`` / ``decode_step`` of the reduced
zamba2-1.2b (4 layers, the shared block after layers 1 and 3) and of a
hybrid with a tail (5 layers, period 2: layer 4 has no shared block).
Then decode against the forward, a sequence cut in two with its state
carried against one run, the configs, ``param_count``, the ``meta`` tree
against the reference's tree, the decode state's layout (one KV cache a
site) and the launcher's tokens against the reference launcher's. Marker
``cuda``: ``ssd_scan`` against its plain version (S = 1, 32, 33, 4,096 and
4,097; B = 1 and 4; float32 and bf16 inputs; a nonzero state; mild and
strong decays) and the reduced models through the kernels against the
plain path. The chunked form the kernel computes is checked on the CPU
too, in plain torch against the reference's step. JAX is imported inside
the reference comparisons only.
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
from repro_torch.models import mamba2 as tm2

ARCH = "zamba2-1.2b"
ATOL = 1e-4
# the reduced zamba2 (no tail) and a hybrid whose last layer has no
# shared block
HYBRIDS = {"reduced": {}, "tail": {"num_layers": 5}}


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
def hybrids():
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    out = {}
    for name, over in HYBRIDS.items():
        jcfg = dataclasses.replace(jreduced(jget(ARCH)), **over)
        out[name] = (jcfg,) + _carry(jcfg)
    return out


def _layer(jp, i):
    jax, _ = _jax()
    return jax.tree.map(lambda a: a[i], jp["blocks"]["mamba"])


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
@pytest.mark.parametrize("S", [1, 7, 128])
def test_mamba2_forward_matches_reference(hybrids, S, carried):
    _, jnp = _jax()
    from repro.models.mamba2 import mamba2_forward as jfwd
    jcfg, jp, tcfg, tp = hybrids["reduced"]
    B, d = 2, jcfg.d_model
    d_inner, H, D, n = tm2._dims(tcfg)
    assert (d_inner, H, D, n) == (256, 8, 32, 16)
    x = _rand((B, S, d), 1)
    jstate = tstate = None
    if carried:
        buf = _rand((B, jcfg.conv_width - 1, d_inner), 2)
        h0 = _rand((B, H, D, n), 3, 0.3)
        jstate = (jnp.asarray(buf), jnp.asarray(h0))
        tstate = (torch.from_numpy(buf), torch.from_numpy(h0))
    want, (jbuf, jh) = jfwd(_layer(jp, 1), jnp.asarray(x), jcfg,
                            state=jstate)
    with torch.no_grad():
        got, (tbuf, th) = tm2.mamba2_forward(tp.blocks[1].mamba,
                                             torch.from_numpy(x), tcfg,
                                             state=tstate)
    assert got.shape == (B, S, d) and th.dtype == torch.float32
    _close(got, want)
    _close(tbuf, jbuf)
    _close(th, jh)


@pytest.mark.parametrize("with_buf", [False, True])
def test_causal_conv_and_gated_rmsnorm_match_reference(with_buf):
    _, jnp = _jax()
    from repro.models import mamba2 as jm2
    x, w = _rand((2, 6, 24), 4), _rand((4, 24), 5)
    buf = _rand((2, 3, 24), 6) if with_buf else None
    want, jbuf = jm2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if buf is None else jnp.asarray(buf))
    got, tbuf = tm2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 None if buf is None else
                                 torch.from_numpy(buf))
    _close(got, want, atol=1e-6)
    _close(tbuf, jbuf, atol=0)
    z, scale = _rand((2, 6, 24), 7), _rand((24,), 8)
    want = jm2._gated_rmsnorm(jnp.asarray(x), jnp.asarray(z),
                              jnp.asarray(scale), 1e-6)
    got = tm2._gated_rmsnorm(torch.from_numpy(x), torch.from_numpy(z),
                             torch.from_numpy(scale), 1e-6)
    _close(got, want, atol=1e-5)


def _jax_ssd(x, Bv, Cv, dt, a, h0):
    """The reference's step (``repro/models/mamba2.py:110-122``) through
    ``lax.scan`` over time-major inputs."""
    jax, jnp = _jax()
    aj = jnp.asarray(a)

    def step(h, inp):
        xt, Bt, Ct, dlt = inp
        decay = jnp.exp(dlt * aj[None, :])
        dBx = jnp.einsum("bhd,bn,bh->bhdn", xt, Bt, dlt)
        h_new = decay[..., None, None] * h + dBx
        return h_new, jnp.einsum("bhdn,bn->bhd", h_new, Ct)

    xs = (jnp.asarray(x).transpose(1, 0, 2, 3),
          *(jnp.asarray(t).transpose(1, 0, 2) for t in (Bv, Cv, dt)))
    h_last, ys = jax.lax.scan(step, jnp.asarray(h0), xs)
    return ys.transpose(1, 0, 2, 3), h_last


@pytest.mark.parametrize("S", [1, 7, 40])
def test_ssd_scan_ref_matches_reference_step(S):
    B, H, D, n = 2, 3, 8, 16
    x = _rand((B, S, H, D), 10)
    Bv, Cv = _rand((B, S, n), 11), _rand((B, S, n), 12)
    dt = np.log1p(np.exp(_rand((B, S, H), 13))).astype(np.float32)
    a = -np.exp(np.log(np.linspace(1, 16, H))).astype(np.float32)
    h0 = _rand((B, H, D, n), 14)
    want_y, want_h = _jax_ssd(x, Bv, Cv, dt, a, h0)
    t = [torch.from_numpy(v) for v in (x, Bv, Cv, dt, a, h0)]
    got_y, got_h = kref.ssd_scan_ref(*t)
    _close(got_y, want_y)
    _close(got_h, want_h)
    y2, h2 = ops.ssd_scan(*t[:5], None)
    y3, h3 = kref.ssd_scan_ref(*t[:5], torch.zeros(B, H, D, n))
    assert torch.equal(y2, y3) and torch.equal(h2, h3)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.ssd_scan(*t, impl="cuda")


def _segsum(da):
    """``seg[..., i, j]`` = the sum of ``da[..., k]`` over k = j + 1 … i
    (−inf above the diagonal): each a running sum over its own segment,
    Mamba-2's ``segsum`` (arXiv:2405.21060, its listing of the SSD
    minimal code)."""
    T = da.shape[-1]
    x = da[..., :, None].expand(*da.shape, T)       # x[..., i, j] = da_i
    x = x.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool), -1),
                      0.0)
    seg = torch.cumsum(x, dim=-2)
    return seg.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool)),
                           -torch.inf)


def _chunked_ssd(x, Bv, Cv, dt, a, h0, L=32, stable=True):
    """Mamba-2's chunked (state-space dual) form of the selective scan in
    plain torch, as ``csrc/ssd_scan.cu``'s chunked kernel computes it:
    per chunk of ``L`` steps the causal G = C·Bᵀ weighted by exp(segment
    sums)·dt, the inter-chunk output exp(prefix)·C·hᵀ, and one state
    update exp(total)·h + Σ_s exp(suffix_s)·dt_s·x_s ⊗ B_s. ``stable``
    False takes every decay as a difference of the chunk's cumulative
    sums instead (the form the kernel must not use)."""
    B, S, H, D = x.shape
    h, ys = h0.clone(), []
    for t0 in range(0, S, L):
        xs, bs, cs = x[:, t0:t0 + L], Bv[:, t0:t0 + L], Cv[:, t0:t0 + L]
        da = (dt[:, t0:t0 + L] * a).transpose(1, 2)        # [B, H, T]
        dth = dt[:, t0:t0 + L].transpose(1, 2)
        pre = torch.cumsum(da, -1)                         # steps 0 … s
        if stable:
            seg = _segsum(da)
            suf = torch.flip(torch.cumsum(torch.flip(da, [-1]), -1), [-1])
            suf = torch.cat([suf[..., 1:], torch.zeros_like(suf[..., :1])],
                            -1)                            # steps s + 1 …
        else:
            seg = (pre[..., :, None] - pre[..., None, :]).masked_fill(
                ~torch.tril(torch.ones(da.shape[-1], da.shape[-1],
                                       dtype=torch.bool)), -torch.inf)
            suf = pre[..., -1:] - pre
        m = (torch.einsum("bin,bjn->bij", cs, bs)[:, None]
             * torch.exp(seg) * dth[..., None, :])          # [B, H, i, j]
        y = (torch.einsum("bhij,bjhd->bihd", m, xs)
             + torch.einsum("bin,bhdn->bihd", cs, h)
             * torch.exp(pre).transpose(1, 2)[..., None])
        wgt = (torch.exp(suf) * dth).transpose(1, 2)        # [B, T, H]
        h = (torch.exp(pre[..., -1])[..., None, None] * h
             + torch.einsum("bshd,bsn->bhdn", xs * wgt[..., None], bs))
        ys.append(y)
    return torch.cat(ys, 1), h


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", [1, 32, 33, 200])
@pytest.mark.parametrize("decay", ["mild", "strong"])
def test_chunked_ssd_matches_reference_step(S, B, decay):
    """The chunked algorithm of the card's kernel (chunks of 32 steps, so
    S = 1, one chunk, one and a step, and 6¼ chunks) against the
    reference's step through ``lax.scan``, from a nonzero state, within
    1e-5 relative Frobenius error. ``strong``: a = −16 and Δ ≈ 8 over
    the first 16 steps of every 32, so that a chunk's sum of Δ·a passes
    −87 (it reaches about −2,048), then Δ ≈ 0.002: the later steps'
    decays are near 1 and matter, and taken as differences of two
    cumulative sums near −2,048 they cancel to about 1e-4 and miss the
    same limit, so the test tells the two forms apart. (At Δ ≈ 2 on every
    step only decays formed exactly would matter, and both forms pass.)"""
    H, D, n = 3, 4, 8
    x = _rand((B, S, H, D), 20)
    Bv, Cv = _rand((B, S, n), 21), _rand((B, S, n), 22)
    if decay == "strong":
        burst = (np.arange(S) % 32 < 16)[None, :, None]
        dt = np.where(burst, 8.0, 0.002) * (1 + 0.1 * _rand((B, S, H), 23))
        dt = dt.astype(np.float32)
        a = np.full(H, -16.0, np.float32)
    else:
        dt = np.log1p(np.exp(_rand((B, S, H), 23) - 2)).astype(np.float32)
        a = -np.linspace(1, 16, H).astype(np.float32)
    h0 = _rand((B, H, D, n), 24)
    want_y, want_h = (np.asarray(v) for v in _jax_ssd(x, Bv, Cv, dt, a, h0))
    t = [torch.from_numpy(v) for v in (x, Bv, Cv, dt, a, h0)]
    got_y, got_h = _chunked_ssd(*t)

    def rel(got, want):
        return float(np.linalg.norm(got.numpy() - want)
                     / np.linalg.norm(want))

    assert rel(got_y, want_y) <= 1e-5 and rel(got_h, want_h) <= 1e-5
    if decay == "strong" and S >= 32:
        dy, dh = _chunked_ssd(*t, stable=False)
        assert max(rel(dy, want_y), rel(dh, want_h)) > 1e-5


@pytest.mark.parametrize("name", list(HYBRIDS))
def test_forward_train_matches_reference(hybrids, name):
    jax, jnp = _jax()
    from repro.models.transformer import forward_train as jfwd
    jcfg, jp, tcfg, tp = hybrids[name]
    toks = _tokens(jcfg, 2, 16)
    want, _ = jax.jit(jfwd, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        got, taux = forward_train(tp, {"tokens": torch.from_numpy(toks)},
                                  tcfg)
    assert got.shape == (2, 16, jcfg.vocab_size) and taux == {}
    _close(got, want)


@pytest.mark.parametrize("name", list(HYBRIDS))
def test_decode_step_matches_reference(hybrids, name):
    jax, jnp = _jax()
    from repro.models import transformer as jt
    jcfg, jp, tcfg, tp = hybrids[name]
    toks = _tokens(jcfg, 2, 6, seed=5)
    jst = jt.init_decode_state(jp, jcfg, 2, 6)
    tst = init_decode_state(tp, tcfg, 2, 6)
    assert len(tst.shared) == len(jst.shared) == 2
    for a, b in zip(tst.layers, jst.layers):
        assert {k: tuple(v.shape) for k, v in a.items()} == \
            {k: v.shape for k, v in b.items()}
    jstep = jax.jit(jt.decode_step, static_argnums=3)
    for t in range(6):
        want, jst = jstep(jp, jst, jnp.asarray(toks[:, t]), jcfg)
        got, tst = decode_step(tp, tst, torch.from_numpy(toks[:, t]), tcfg)
        _close(got, want)
    assert tst.pos == int(jst.pos) == 6
    for a, b in zip(tst.shared, jst.shared):
        _close(a["k"], b["k"])
        _close(a["v"], b["v"])


@pytest.mark.parametrize("name", list(HYBRIDS))
def test_decode_matches_forward(name):
    """The serving invariant: step-by-step decode reproduces the forward's
    logits at every position; each site's attention writes its own
    cache."""
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              **HYBRIDS[name])
    params = init_params(cfg, 3, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=9))
    with torch.no_grad():
        logits, _ = forward_train(params, {"tokens": toks}, cfg)
    st = init_decode_state(params, cfg, 2, 12)
    first = st.shared
    errs = []
    for t in range(12):
        lg, st = decode_step(params, st, toks[:, t], cfg)
        errs.append(float((lg - logits[:, t]).abs().max()))
    assert max(errs) < 3e-4, errs
    assert all(a is b for a, b in zip(st.shared, first))
    assert not torch.equal(st.shared[0]["k"], st.shared[1]["k"])
    assert st.layers[-1]["h"].dtype == torch.float32


@pytest.mark.parametrize("S", [2, 9, 24])
def test_state_carry_equals_full_run(S):
    """``tests/test_models.py::test_mamba_state_carry_equals_full_run`` on
    the port: a sequence split at S // 2 with its conv buffer and state
    carried gives the one run's output."""
    cfg = ModelConfig(family="hybrid", num_layers=4, d_model=64,
                      num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
                      ssm_head_dim=16, ssm_state=8, shared_attn_every=2,
                      dtype="float32")
    layer = init_params(cfg, 4, device="cpu").blocks[0].mamba
    x = torch.from_numpy(_rand((1, S, cfg.d_model), 16))
    with torch.no_grad():
        full, (_, h_full) = tm2.mamba2_forward(layer, x, cfg)
        cut = S // 2
        a, st = tm2.mamba2_forward(layer, x[:, :cut], cfg)
        b, (_, h_b) = tm2.mamba2_forward(layer, x[:, cut:], cfg, state=st)
    _close(torch.cat([a, b], dim=1), full.numpy(), atol=2e-4)
    _close(h_b, h_full.numpy())


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
    assert not tc.is_attention_free and not jc.is_attention_free
    assert shape_applicable(tc, "long_500k") == \
        japplicable(jc, "long_500k") == (True, "")
    assert convert.model_config_from_reference(
        dataclasses.asdict(jc)) == dataclasses.replace(tc, attn_impl="torch")
    if full:
        # _dims' heads are 2·d_model // ssm_head_dim, not ssm_heads
        assert tm2._dims(tc) == (4096, 64, 64, 64) and tc.ssm_heads == 32
        assert tc.param_count == 1_164_599_296
    else:
        assert (tc.shared_attn_every, tc.num_layers) == (2, 4)


def test_param_tree_matches_reference_tree():
    """The full config's tree (built without storage) holds the
    reference's tree, leaf for leaf: 1,170,293,888 parameters, 5,694,592
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
    assert sum(p.numel() for p in named.values()) == want == 1_170_293_888
    assert want - cfg.param_count == 5_694_592
    for name, leaf in shapes["blocks"]["mamba"].items():
        got = tuple(named["blocks.0.mamba." + name].shape)
        want_shape = leaf.shape[1:] if name == "conv_w" else \
            leaf.shape[1:][::-1]
        assert got == want_shape, name
    assert tuple(named["shared_attn.attn.wq"].shape) == (2048, 2048)
    assert sum(".attn." in n for n in named) == 4      # one shared block


def test_long_500k_state_bytes():
    """``init_decode_state`` at ``long_500k``'s length on the ``meta``
    device: 38 layers of conv buffer and float32 state, and one bf16 KV
    cache a site (6)."""
    cfg = get_config(ARCH)
    params = init_params(cfg, device="meta")
    st = init_decode_state(params, cfg, 1, 524_288)

    def nbytes(d):
        return sum(t.numel() * t.element_size() for t in d.values())

    assert sum(nbytes(lc) for lc in st.layers) == 38 * 1_073_152 == \
        40_779_776
    assert len(st.shared) == 6
    assert sum(nbytes(c) for c in st.shared) == 25_769_803_776


def test_launcher_tokens_equal_reference_launcher(monkeypatch, capsys):
    """``--arch zamba2-1.2b --smoke --device cpu`` with the reference
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
    assert "zamba2-1.2b-smoke on cpu" in capsys.readouterr().out
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


def _check_ssd_scan(cuda, B, S, H, D, n, dtype, decay, seed):
    """The kernel against its plain version on the same inputs (x, B, C in
    ``dtype``, a nonzero state and a zero one): the outputs and the final
    state within 1e-5 relative Frobenius error (float32 sums in another
    order). ``strong``: Δ ≈ 8 over the first 16 steps of every 32, then
    Δ ≈ 0.002, so that a chunk's sum of Δ·a passes −87 at every head and
    the later steps' decays, near 1, would cancel if taken as differences
    of cumulative sums (``test_chunked_ssd_matches_reference_step``)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = torch.randn(B, S, H, D, generator=g, device=cuda).to(dt)
    Bv, Cv = (torch.randn(B, S, n, generator=g, device=cuda).to(dt)
              for _ in range(2))
    noise = torch.randn(B, S, H, generator=g, device=cuda)
    if decay == "strong":
        burst = (torch.arange(S, device=cuda) % 32 < 16)[None, :, None]
        delta = torch.where(burst, 8.0, 0.002) * (1 + 0.1 * noise)
    else:
        delta = torch.nn.functional.softplus(noise - 2)
    a = -torch.linspace(1, 16, H, device=cuda)
    h0 = torch.randn(B, H, D, n, generator=g, device=cuda)
    before = ops.launch_counts()["ssd_scan"]
    y, h_last = ops.ssd_scan(x, Bv, Cv, delta, a, h0, impl="cuda")
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    want_y, want_h = kref.ssd_scan_ref(x, Bv, Cv, delta, a, h0)
    assert y.dtype == h_last.dtype == torch.float32
    assert _rel(y, want_y) <= 1e-5 and _rel(h_last, want_h) <= 1e-5
    y0, _ = ops.ssd_scan(x, Bv, Cv, delta, a, None, impl="cuda")
    assert _rel(y0, kref.ssd_scan_ref(x, Bv, Cv, delta, a)[0]) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["mild", "strong"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [1, 32, 33, 4096, 4097])
def test_cuda_ssd_scan_matches_plain(cuda, S, B, dtype, decay):
    """:func:`_check_ssd_scan` at zamba2-1.2b's head shape. S = 1 runs the
    serial kernel, the rest the chunked one: one chunk of 32 steps, one
    and a step, whole chunks and a last chunk of one step."""
    _check_ssd_scan(cuda, B, S, 64, 64, 64, dtype, decay, seed=S + B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 33, 4097])
@pytest.mark.parametrize("n", ops.SSD_STATES)
def test_cuda_ssd_scan_every_state_size(cuda, n, S, dtype):
    """:func:`_check_ssd_scan` at every state size the wrapper accepts
    (the chunked kernel gives a consumer warp n / 32 state tiles of 8
    columns, at least one, and at n = 16 some warps none), 4 heads of
    64."""
    _check_ssd_scan(cuda, 2, S, 4, 64, n, dtype, "mild", seed=S + n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HYBRIDS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_forward_kernels_match_plain_path(cuda, dtype, name,
                                               monkeypatch):
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dtype,
                              **HYBRIDS[name])
    params = init_params(cfg, 0, device=cuda)
    toks = torch.from_numpy(_tokens(cfg, 2, 100)).to(cuda)
    before = ops.launch_counts()
    with torch.inference_mode():
        got, _ = forward_train(params, {"tokens": toks}, cfg)
        with monkeypatch.context() as m:
            m.setattr(ops, "ssd_scan",
                      functools.partial(ops.ssd_scan, impl="torch"))
            want, _ = forward_train(params, {"tokens": toks},
                                    dataclasses.replace(cfg,
                                                        attn_impl="torch"))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["ssd_scan"] == before["ssd_scan"] + cfg.num_layers
    assert after["flash_attention"] == before["flash_attention"] + 2
    assert _rel(got.float(), want.float()) <= (
        5e-2 if dtype == "bfloat16" else 1e-5)
    if dtype == "float32":
        st = init_decode_state(params, cfg, 2, 100)
        for t in range(8):
            lg, st = decode_step(params, st, toks[:, t], cfg)
            assert float((lg - got[:, t]).abs().max()) < 3e-4
