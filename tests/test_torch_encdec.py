"""The port's encoder-decoder family (``"encdec"``, whisper-medium) against
the reference, on the CPU.

The reference's parameters are carried across with
``convert.model_params_from_numpy`` and the same numpy-seeded tokens and
frame embeddings go through both packages, float32, within 1e-4: the
sinusoidal tables (within 1e-6), the encoder's output, ``forward_train``,
``decode_step`` from ``init_decode_state(encoder_frames=)`` at every
step, its caches, and ``prefill(encoder_frames=)`` of the reduced
whisper-medium. The reference's programs run once, in a module fixture.
Then the configs, ``shape_applicable``, the ``meta`` tree of the full
config against the reference's tree, the scheduler and launcher raising
the reference's error (they pass no frames), the cross caches' bytes, and
the port's own invariant (decode reproduces the forward). Marker
``cuda``: ``flash_attention`` non-causal at 1,500 and 1,000 keys (not
multiples of the kernel's 64-key tile) and as cross-attention (32,768 and
1 queries over 1,500 keys) against the chunked version, with the
reference's padding fault planted to show the gate sees it; the reduced
model through the kernel against the plain path, and decode against the
forward. JAX is imported inside the reference comparisons only.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.registry import (SHAPES, get_config, reduced_config,
                                          shape_applicable)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (ModelConfig, decode_step, forward_train,
                                init_decode_state, init_params)
from repro_torch.models import transformer as tt
from repro_torch.serving import BatchScheduler, Request, prefill

ARCH = "whisper-medium"
ATOL = 1e-4
B, S = 2, 12


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.fixture(scope="module")
def ref():
    """The reduced whisper in both packages (one set of weights), the
    inputs, and the reference's outputs: the encoder, the forward's
    logits, each decode step's logits, the final decode state and
    ``prefill``'s logits."""
    jax, jnp = _jax()
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    from repro.models import transformer as jt
    from repro.serving.prefill import prefill as jprefill
    jcfg = jreduced(jget(ARCH))
    jp = jax.jit(jt.init_params, static_argnums=0)(jcfg,
                                                    jax.random.PRNGKey(1))
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal(
        (B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    fr = jnp.asarray(frames)
    out = dict(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp, toks=toks, frames=frames)
    out["enc"] = np.asarray(jt._encoder_forward(jp, fr, jcfg, remat=False))
    out["logits"] = np.asarray(jt.forward_train(
        jp, {"tokens": jnp.asarray(toks), "encoder_frames": fr}, jcfg)[0])
    step = jax.jit(jt.decode_step, static_argnums=3)
    st = jt.init_decode_state(jp, jcfg, B, S, encoder_frames=fr)
    steps = []
    for t in range(S):
        lg, st = step(jp, st, jnp.asarray(toks[:, t]), jcfg)
        steps.append(np.asarray(lg))
    out["steps"], out["state"] = steps, jax.tree.map(np.asarray, st)
    out["prefill"] = np.asarray(jprefill(jp, jcfg, jnp.asarray(toks), S,
                                         encoder_frames=fr)[0])
    return out


def _frames(ref):
    return torch.from_numpy(ref["frames"])


@pytest.mark.parametrize("S_,d", [(16, 128), (1500, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_matches_reference(S_, d, dtype):
    """The table (``[sin, cos]``, float32, then cast) within 1e-6, and at
    single positions up to prefill_32k's last, in float32."""
    _, jnp = _jax()
    from repro.models import transformer as jt
    tdt = getattr(torch, dtype)
    got = tt._sinusoidal(S_, d, tdt, torch.device("cpu"))
    assert got.shape == (S_, d) and got.dtype == tdt
    _close(got, jt._sinusoidal(S_, d, getattr(jnp, dtype)).astype(
        jnp.float32), atol=1e-6)
    for pos in (0, 7, S_ - 1, 32_767):
        _close(tt._sinusoidal_at(torch.tensor(pos), d, torch.float32),
               jt._sinusoidal_at(jnp.asarray(pos, jnp.int32), d,
                                 jnp.float32), atol=1e-6)


def test_encoder_matches_reference(ref):
    with torch.no_grad():
        got = tt._encoder_forward(ref["tp"], _frames(ref), ref["tcfg"])
    assert got.shape == (B, ref["jcfg"].encoder_seq, ref["jcfg"].d_model)
    _close(got, ref["enc"])


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_forward_train_matches_reference(ref, impl):
    cfg = dataclasses.replace(ref["tcfg"], attn_impl=impl)
    with torch.no_grad():
        got, aux = forward_train(
            ref["tp"], {"tokens": torch.from_numpy(ref["toks"]),
                        "encoder_frames": _frames(ref)}, cfg)
    assert got.shape == (B, S, cfg.vocab_size) and aux == {}
    _close(got, ref["logits"])


def test_decode_step_matches_reference(ref):
    """Every step's logits, then the caches: each layer's self K/V and
    cross ``(k, v)`` from ``project_kv`` of the encoder's output."""
    cfg, tp = ref["tcfg"], ref["tp"]
    st = init_decode_state(tp, cfg, B, S, encoder_frames=_frames(ref))
    assert len(st.cross) == cfg.num_layers and st.shared is None
    for t in range(S):
        got, st = decode_step(tp, st, torch.from_numpy(ref["toks"][:, t]),
                              cfg)
        _close(got, ref["steps"][t])
    want = ref["state"]
    assert st.pos == int(want.pos) == S
    for i in range(cfg.num_layers):
        for name in ("k", "v"):
            _close(st.layers[i][name], want.layers[i][name], atol=1e-5)
        for got, w in zip(st.cross[i], want.cross[i], strict=True):
            assert tuple(got.shape) == w.shape
            _close(got, w, atol=1e-5)


def test_prefill_matches_reference(ref):
    logits, st = prefill(ref["tp"], ref["tcfg"],
                         torch.from_numpy(ref["toks"]), S,
                         encoder_frames=_frames(ref))
    _close(logits, ref["prefill"])
    assert st.pos == S and len(st.cross) == ref["tcfg"].num_layers


def test_scheduler_and_launcher_raise_reference_error(ref, monkeypatch):
    """``BatchScheduler`` and the launcher pass no frames, in both
    packages: the reference's ``ValueError``, the port's the same."""
    from repro.launch import serve as jserve
    from repro.serving.scheduler import BatchScheduler as JScheduler
    from repro.serving.scheduler import Request as JRequest
    msg = "whisper decode needs encoder_frames"
    for sched, req in ((JScheduler(ref["jp"], ref["jcfg"], max_len=32),
                        JRequest), (BatchScheduler(ref["tp"], ref["tcfg"],
                                                   max_len=32), Request)):
        sched.submit(req(rid=0, prompt=[3, 4, 5], max_new_tokens=2))
        with pytest.raises(ValueError, match=msg):
            sched.run()
    argv = ["--arch", ARCH, "--smoke", "--requests", "1", "--max-new", "2"]
    monkeypatch.setattr(jserve, "init_params",
                        lambda cfg, key: ref["jp"])
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(ValueError, match=msg):
        jserve.main()
    with pytest.raises(ValueError, match=msg):
        launch_serve.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match=msg):
        init_decode_state(ref["tp"], ref["tcfg"], 1, 8)


def test_decode_matches_forward():
    """The serving invariant: step-by-step decode from the encoder's
    frames reproduces the forward's logits at every position within 3e-4
    (``tests/test_models.py``'s, on the port)."""
    cfg = reduced_config(get_config(ARCH))
    params = init_params(cfg, 3, device="cpu")
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 10)))
    frames = torch.from_numpy(rng.standard_normal(
        (B, 13, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        logits, _ = forward_train(params, {"tokens": toks,
                                           "encoder_frames": frames}, cfg)
    st = init_decode_state(params, cfg, B, 10, encoder_frames=frames)
    errs = []
    for t in range(10):
        lg, st = decode_step(params, st, toks[:, t], cfg)
        errs.append(float((lg - logits[:, t]).abs().max()))
    assert max(errs) < 3e-4, errs


def test_cross_cache_bytes():
    """One ``(k, v)`` a decoder layer over the T frames:
    ``L · 2 · B · Hkv · T · hd`` elements of the compute dtype."""
    cfg = reduced_config(get_config(ARCH))
    params = init_params(cfg, 0, device="cpu")
    frames = torch.zeros(3, cfg.encoder_seq, cfg.d_model)
    st = init_decode_state(params, cfg, 3, 8, encoder_frames=frames)
    got = sum(t.numel() * t.element_size() for kv in st.cross for t in kv)
    assert got == (cfg.num_layers * 2 * 3 * cfg.num_kv_heads
                   * cfg.encoder_seq * cfg.head_dim * 4)


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
    assert tc.subquadratic == jc.subquadratic
    for shape in SHAPES:
        assert shape_applicable(tc, shape) == japplicable(jc, shape), shape
    if full:
        assert tc.param_count == 811_597_824


def reference_tree_shapes(shapes, stacks):
    """``{port name: shape}`` of a reference ``eval_shape`` tree: the
    ``[L, …]`` leaves of the ``stacks`` (``{name: L}``) one a layer, the
    matrices (2-D, the embedding table aside) as the port's
    ``[out, in]``."""
    out = {}

    def walk(prefix, node, stacked):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v, stacked)
                continue
            shape = tuple(v.shape[1:] if stacked else v.shape)
            out[prefix + k] = shape[::-1] if (
                len(shape) == 2 and k != "embedding") else shape

    for k, v in shapes.items():
        for i in range(stacks.get(k, 0)):
            walk(f"{k}.{i}.", v, True)
        if k not in stacks:
            walk(f"{k}.", v, False)
    return out


def test_param_tree_matches_reference_tree():
    """The full config's tree (built without storage) equals the
    reference's tree leaf for leaf, in names and shapes: 811,722,752
    parameters, the analytic count and 122 norm scales of 1,024."""
    jax, _ = _jax()
    from repro.configs.registry import get_config as jget
    from repro.models.transformer import init_params as jinit
    shapes = jax.eval_shape(lambda k: jinit(jget(ARCH), k),
                            jax.ShapeDtypeStruct((2,), np.uint32))
    want = reference_tree_shapes(shapes, {"enc_blocks": 24,
                                          "dec_blocks": 24})
    params = init_params(get_config(ARCH), device="meta")
    got = {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert got == want
    total = sum(int(np.prod(s)) for s in got.values())
    norms = sum(int(np.prod(s)) for n, s in got.items()
                if n.endswith(".scale"))
    assert total == 811_722_752 and norms == 122 * 1024
    assert total - norms == get_config(ARCH).param_count


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


ATTN_REL = {"bfloat16": 1e-3, "float32": 1e-5}
# (Hq, Hkv, Sq, Skv, D): whisper-medium's encoder (1,500 frames, 16 heads
# of 64), a length that is not a multiple of the 64-key tile either, and
# cross-attention at prefill_32k's decoder length and at one query
ENCDEC_SHAPES = {
    "encoder_1500": (16, 16, 1500, 1500, 64),
    "noncausal_1000": (16, 16, 1000, 1000, 64),
    "cross_32k_1500": (16, 16, 32_768, 1500, 64),
    "cross_1_1500": (16, 16, 1, 1500, 64),
}


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(ENCDEC_SHAPES))
def test_cuda_noncausal_attention_matches_chunked(cuda, shape, dtype):
    """Non-causal ``flash_attention`` at whisper's shapes within
    ``ATTN_REL`` of the chunked version; the reference's padding fault
    (K/V zero-padded to a multiple of 64, the padding read as live keys)
    planted on the same inputs must fail that gate."""
    Hq, Hkv, Sq, Skv, D = ENCDEC_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(Sq + Skv)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((1, h, n, D), generator=gen, device=cuda,
                           dtype=dt)
               for h, n in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
    before = ops.launch_counts()["flash_attention"]
    got = ops.attention(q, k, v, causal=False, impl="cuda")
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = kref.attention_chunked(q, k, v, causal=False)
    assert got.dtype == dt and got.shape == q.shape
    assert _rel(got, want) <= ATTN_REL[dtype]
    pad = -Skv % 64
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    bad = ops.attention(q, kp, vp, causal=False, impl="cuda")
    assert _rel(bad, want) > ATTN_REL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_forward_kernel_matches_plain_path(cuda, dtype):
    """The reduced whisper through ``flash_attention`` (one launch an
    encoder layer, two a decoder layer) against ``attn_impl="torch"``,
    at 200 decoder tokens and 150 frames."""
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dtype)
    params = init_params(cfg, 0, device=cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 200))).to(
        cuda)
    frames = torch.from_numpy(rng.standard_normal(
        (2, 150, cfg.d_model)).astype(np.float32)).to(cuda)
    batch = {"tokens": toks, "encoder_frames": frames}
    before = ops.launch_counts()["flash_attention"]
    with torch.inference_mode():
        got, _ = forward_train(params, batch, cfg)
        want, _ = forward_train(params, batch,
                                dataclasses.replace(cfg, attn_impl="torch"))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == \
        before + cfg.encoder_layers + 2 * cfg.num_layers
    assert _rel(got, want) <= (5e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.cuda
def test_cuda_decode_matches_forward(cuda):
    cfg = reduced_config(get_config(ARCH))
    params = init_params(cfg, 3, device=cuda)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))).to(
        cuda)
    frames = torch.from_numpy(rng.standard_normal(
        (2, 100, cfg.d_model)).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        logits, _ = forward_train(params, {"tokens": toks,
                                           "encoder_frames": frames}, cfg)
    st = init_decode_state(params, cfg, 2, 12, encoder_frames=frames)
    for t in range(12):
        lg, st = decode_step(params, st, toks[:, t], cfg)
        assert float((lg - logits[:, t]).abs().max()) < 3e-4
