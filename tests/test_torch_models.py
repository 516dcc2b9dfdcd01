"""The port's dense LM stack against the reference, on the CPU.

The reference's parameters are carried across with
``convert.model_params_from_numpy`` and the same numpy-seeded tokens go
through both packages, float32: layers, MLP (the tanh gelu included),
``attention_forward``, the ring and int8 caches, ``decode_attention``,
and ``forward_train`` / ``decode_step`` of the reduced llama3.2-1b,
gemma3-4b (local:global), h2o-danube-3-4b (sliding window) and
starcoder2-7b (the reduced config keeps no MLP flavour, so its plain gelu
MLP is set on both sides) within 1e-4. Then the port's own invariants
(decode reproduces the forward; the int8 cache stays close to the float
one), ``param_count`` against the full configs' module trees built on
the ``meta`` device, and the names that raise. Marker ``cuda``: the
forward through the ``flash_attention`` kernel against the plain path
and decode against the forward on the card. JAX is imported inside the
reference comparisons only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.models import (ModelConfig, decode_step, forward_train,
                                init_decode_state, init_params)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp

DENSE = ["llama3.2-1b", "gemma3-4b", "h2o-danube-3-4b", "starcoder2-7b"]
ATOL = 1e-4


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _reference_pair(arch, **overrides):
    """(reference config, its params, the port's config, its params)."""
    jax, _ = _jax()
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    from repro.models.transformer import init_params as jinit
    jcfg = dataclasses.replace(jreduced(jget(arch)), **overrides)
    if arch == "starcoder2-7b":
        jcfg = dataclasses.replace(jcfg, mlp_gated=False, act="gelu")
    jp = jinit(jcfg, jax.random.PRNGKey(1))
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def pairs():
    return {arch: _reference_pair(arch) for arch in DENSE}


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _x(B, S, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def test_reduced_configs_match_reference():
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    for arch in DENSE + ["whisper-medium", "llava-next-mistral-7b"]:
        for full in (False, True):
            jc = jget(arch) if full else jreduced(jget(arch))
            tc = get_config(arch) if full else reduced_config(get_config(arch))
            for f in dataclasses.fields(ModelConfig):
                if f.name != "attn_impl":
                    assert getattr(tc, f.name) == getattr(jc, f.name), (
                        arch, full, f.name)
            assert tc.param_count == jc.param_count
            assert tc.subquadratic == jc.subquadratic
            assert [tc.layer_is_global(i) for i in range(tc.num_layers)] == \
                [jc.layer_is_global(i) for i in range(jc.num_layers)]


def test_layers_match_reference(pairs):
    _, jnp = _jax()
    from repro.models import layers as jl
    jcfg, jp, tcfg, tp = pairs["h2o-danube-3-4b"]       # untied head
    x = _x(2, 6, jcfg.d_model)
    bp = jp["blocks"]
    scale = np.asarray(bp["ln1"]["scale"])[0] * 1.5
    tnorm = tlayers.RMSNorm(jcfg.d_model, torch.float32, torch.device("cpu"))
    tnorm.scale.data = torch.from_numpy(scale.copy())
    _close(tlayers.rmsnorm(tnorm, torch.from_numpy(x), 1e-6),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    q = np.random.default_rng(2).standard_normal((2, 4, 6, 32)).astype(
        np.float32)
    for pos in (np.arange(6, dtype=np.int32) + 100,
                np.arange(12, dtype=np.int32).reshape(2, 6) * 7):
        _close(tlayers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos),
                                  500_000.0),
               jl.apply_rope(jnp.asarray(q), jnp.asarray(pos), 500_000.0))
    toks = _tokens(jcfg, 2, 6)
    for dt in ("float32", "bfloat16"):
        jc, tc = (dataclasses.replace(c, dtype=dt) for c in (jcfg, tcfg))
        got = tlayers.embed_tokens(tp.embed, torch.from_numpy(toks), tc)
        assert got.dtype == tlayers.dtype_of(tc)
        _close(got, jl.embed_tokens(jp["embed"], jnp.asarray(toks), jc),
               atol=ATOL if dt == "float32" else 1e-2)
    h = _x(2, 6, jcfg.d_model, seed=3)
    for tied in (False, True):
        jc, tc = (dataclasses.replace(c, tie_embeddings=tied)
                  for c in (jcfg, tcfg))
        _close(tlayers.unembed(tp.embed, torch.from_numpy(h), tc, tp.head),
               jl.unembed(jp["embed"], jnp.asarray(h), jc, jp.get("head")))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "starcoder2-7b"])
def test_mlp_matches_reference(pairs, arch):
    jax, jnp = _jax()
    from repro.models.mlp import mlp_forward as jmlp
    jcfg, jp, tcfg, tp = pairs[arch]
    x = _x(2, 5, jcfg.d_model)
    want = jmlp(jax.tree.map(lambda a: a[0], jp["blocks"]["mlp"]),
                jnp.asarray(x), jcfg)
    _close(tmlp.mlp_forward(tp.blocks[0].mlp, torch.from_numpy(x), tcfg),
           want)
    assert (tcfg.act, tcfg.mlp_gated) == (
        ("gelu", False) if arch == "starcoder2-7b" else ("silu", True))


@pytest.mark.parametrize("impl", ["torch", "ref"])
@pytest.mark.parametrize("is_global", [True, False])
def test_attention_forward_matches_reference(pairs, impl, is_global):
    jax, jnp = _jax()
    from repro.models.attention import attention_forward as jfwd
    jcfg, jp, tcfg, tp = pairs["gemma3-4b"]
    jcfg = dataclasses.replace(jcfg, attn_chunk=8)
    tcfg = dataclasses.replace(tcfg, attn_chunk=8, attn_impl=impl)
    x = _x(2, 20, jcfg.d_model)
    want = jfwd(jax.tree.map(lambda a: a[1], jp["blocks"]["attn"]),
                jnp.asarray(x), jcfg, is_global=is_global)
    got = tattn.attention_forward(tp.blocks[1].attn, torch.from_numpy(x),
                                  tcfg, is_global=is_global)
    _close(got, want)


@pytest.mark.parametrize("kv_cache_dtype", ["compute", "int8"])
@pytest.mark.parametrize("is_global", [True, False])
def test_decode_attention_and_caches_match_reference(pairs, kv_cache_dtype,
                                                     is_global):
    """Ring (windowed layer, 12 positions through an 8-slot ring) and full
    caches, float and int8: the cache contents and each step's output."""
    jax, jnp = _jax()
    from repro.models import attention as ja
    jcfg, jp, tcfg, tp = pairs["gemma3-4b"]
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype=kv_cache_dtype)
                  for c in (jcfg, tcfg))
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    jcache = ja.init_kv_cache(jcfg, 2, 16, is_global)
    tcache = tattn.init_kv_cache(tcfg, 2, 16, is_global, torch.device("cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tcache.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
    assert tcache["k"].shape[2] == (16 if is_global else tcfg.sliding_window)
    xs = _x(2, 12, jcfg.d_model)
    for pos in range(12):
        x = xs[:, pos:pos + 1]
        want, jcache = ja.decode_attention(jparams, jnp.asarray(x), jcache,
                                           jnp.asarray(pos, jnp.int32), jcfg,
                                           is_global=is_global)
        got, tcache = tattn.decode_attention(tp.blocks[0].attn,
                                             torch.from_numpy(x), tcache,
                                             pos, tcfg, is_global=is_global)
        _close(got, want)
    for k in jcache:
        if k in ("k", "v") and kv_cache_dtype == "int8":
            diff = np.abs(tcache[k].numpy().astype(np.int32)
                          - np.asarray(jcache[k]).astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() > 0.999, k
        else:
            _close(tcache[k], jcache[k], atol=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_reference(pairs, arch):
    _, jnp = _jax()
    from repro.models.transformer import forward_train as jfwd
    jcfg, jp, tcfg, tp = pairs[arch]
    toks = _tokens(jcfg, 2, 16)
    want, aux = jfwd(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, taux = forward_train(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (2, 16, jcfg.vocab_size) and taux == aux == {}
    _close(got, want)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(pairs, arch):
    _, jnp = _jax()
    from repro.models import transformer as jt
    jcfg, jp, tcfg, tp = pairs[arch]
    toks = _tokens(jcfg, 2, 10, seed=5)
    jst = jt.init_decode_state(jp, jcfg, 2, 10)
    tst = init_decode_state(tp, tcfg, 2, 10)
    for t in range(10):
        want, jst = jt.decode_step(jp, jst, jnp.asarray(toks[:, t]), jcfg)
        got, tst = decode_step(tp, tst, torch.from_numpy(toks[:, t]), tcfg)
        _close(got, want)
    assert tst.pos == int(jst.pos) == 10


TINY = {
    "dense": ModelConfig(num_layers=2, d_model=64, num_heads=4,
                         num_kv_heads=2, d_ff=128, vocab_size=128,
                         dtype="float32"),
    "swa-local-global": ModelConfig(num_layers=4, d_model=64, num_heads=4,
                                    num_kv_heads=2, d_ff=128,
                                    vocab_size=128, sliding_window=4,
                                    global_every=2, dtype="float32"),
    "soft-cap-gelu": ModelConfig(num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=1, d_ff=128, vocab_size=128,
                                 logit_soft_cap=20.0, act="gelu",
                                 mlp_gated=False, tie_embeddings=True,
                                 dtype="float32"),
}


@pytest.mark.parametrize("name", list(TINY))
def test_decode_matches_forward(name):
    """The serving invariant: step-by-step decode reproduces the forward's
    logits at every position (``tests/test_models.py``'s, on the port)."""
    cfg = TINY[name]
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


def test_int8_kv_cache_decode_close_to_fp():
    cfg = TINY["dense"]
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    params = init_params(cfg, 11, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=1))
    with torch.no_grad():
        logits, _ = forward_train(params, {"tokens": toks}, cfg)
    st8 = init_decode_state(params, cfg8, 2, 12)
    assert st8.layers[0]["k"].dtype == torch.int8
    errs = []
    for t in range(12):
        lg, st8 = decode_step(params, st8, toks[:, t], cfg8)
        errs.append(float((lg - logits[:, t]).abs().max()))
    assert max(errs) < 0.15, errs


def test_compute_weight_copy_follows_the_weight():
    """Without autograd a bfloat16 config casts each float32 weight once
    and casts again after an in-place write or a new tensor; with autograd
    it casts anew, so the gradient reaches the weight. The forward with
    kept copies equals the one that casts every weight at use."""
    cfg = dataclasses.replace(TINY["dense"], dtype="bfloat16")
    params = init_params(cfg, 5, device="cpu")
    attn = params.blocks[0].attn
    with torch.no_grad():
        a = tlayers.compute_weight(attn, "wq", cfg)
        assert a.dtype == torch.bfloat16
        assert tlayers.compute_weight(attn, "wq", cfg) is a
        assert torch.equal(a, attn.wq.to(torch.bfloat16))
        attn.wq.mul_(2.0)
        b = tlayers.compute_weight(attn, "wq", cfg)
        assert b is not a and torch.equal(b, attn.wq.to(torch.bfloat16))
        attn.wq = torch.nn.Parameter(attn.wq * 0.5)
        c = tlayers.compute_weight(attn, "wq", cfg)
        assert torch.equal(c, attn.wq.to(torch.bfloat16))
    f32 = dataclasses.replace(cfg, dtype="float32")
    assert tlayers.compute_weight(attn, "wq", f32) is attn.wq
    w = tlayers.compute_weight(attn, "wk", cfg)
    w.float().sum().backward()
    assert attn.wk.grad is not None
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=2))
    with torch.inference_mode():
        kept, _ = forward_train(params, {"tokens": toks}, cfg)
    fresh, _ = forward_train(params, {"tokens": toks}, cfg)
    assert torch.equal(kept, fresh.detach())
    st = init_decode_state(params, cfg, 2, 12)
    for t in range(12):
        lg, st = decode_step(params, st, toks[:, t], cfg)
    assert torch.isfinite(lg.float()).all()


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_module_tree(arch):
    """The analytic count leaves the norm scales out, as the reference's
    does; the rest of the full config's tree (built without storage)
    matches it exactly."""
    cfg = get_config(arch)
    params = init_params(cfg, device="meta")
    total = sum(p.numel() for p in params.parameters())
    norms = sum(p.numel() for n, p in params.named_parameters()
                if n.endswith(".scale"))
    assert norms == (2 * cfg.num_layers + 1) * cfg.d_model
    assert total - norms == cfg.param_count
    assert params.embed.embedding.device.type == "meta"
    assert (params.head is None) == cfg.tie_embeddings
    if arch == "llama3.2-1b":
        assert total == 1_235_814_400


MOE = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
RECURRENT = {"rwkv6-3b": "ssm", "zamba2-1.2b": "hybrid"}
ENCDEC_VLM = {"whisper-medium": "encdec", "llava-next-mistral-7b": "vlm"}


def test_unported_names_raise():
    """Every family and config of the reference is ported and builds (an
    MoE config without experts is refused); what is still to port raises
    naming its item, and a field of the reference the port lacks is a
    ``TypeError``."""
    for fam in ("moe", "ssm", "hybrid", "encdec", "vlm"):
        if fam == "moe":
            with pytest.raises(ValueError, match="num_experts_per_tok"):
                ModelConfig(family=fam)
            with pytest.raises(ValueError, match="num_experts_per_tok"):
                convert.model_config_from_reference({"family": fam})
            continue
        assert ModelConfig(family=fam).family == fam
        assert convert.model_config_from_reference(
            {"family": fam}).family == fam
    assert set(ARCHS) == set(DENSE) | set(MOE) | set(RECURRENT) | set(
        ENCDEC_VLM)
    for arch in ("olmoe-1b-7b", "rwkv6-3b", "zamba2-1.2b", "whisper-medium",
                 "llava-next-mistral-7b", "phi3.5-moe-42b-a6.6b"):
        assert get_config(arch).family == {
            **dict.fromkeys(MOE, "moe"), **RECURRENT, **ENCDEC_VLM}[arch]
    with pytest.raises(KeyError):
        get_config("gpt-5")
    with pytest.raises(ValueError, match="attn_impl='auto'"):
        ModelConfig(attn_impl="pallas")
    with pytest.raises(ValueError, match="attn_impl='torch'"):
        ModelConfig(attn_impl="jnp_flash")
    with pytest.raises(NotImplementedError, match="item 8"):
        ModelConfig(attn_impl="cp_kv")
    assert ModelConfig(encoder_layers=2).encoder_layers == 2
    with pytest.raises(TypeError):
        ModelConfig(attn_bf16_probs=True)
    with pytest.raises(TypeError):
        ModelConfig(ssm_state_sharding=True)
    cfg = TINY["dense"]
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="training"):
        forward_train(params, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                      cfg, remat=True)


def test_model_config_from_reference_renames_attn_impl():
    from repro.models.config import ModelConfig as JConfig
    for jimpl, timpl in (("pallas", "auto"), ("jnp_flash", "torch"),
                         ("ref", "ref")):
        fields = dataclasses.asdict(JConfig(attn_impl=jimpl))
        assert convert.model_config_from_reference(fields).attn_impl == timpl
    with pytest.raises(NotImplementedError, match="item 8"):
        convert.model_config_from_reference(
            dataclasses.asdict(JConfig(attn_impl="cp_kv")))


def test_convert_helpers_default_to_the_card(monkeypatch):
    """Every helper puts its result on the card unless asked for the CPU:
    with no card they raise, naming ``device='cpu'``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TINY["dense"]
    i32 = np.zeros((2, 3), np.int32)
    calls = {
        "graph_from_numpy": lambda **kw: convert.graph_from_numpy(
            2, [0, 1, 2], [1, 0], **kw),
        "walk_index_from_numpy": lambda **kw: convert.walk_index_from_numpy(
            i32, 4, 0, **kw),
        "sharded_walk_index_from_numpy":
            lambda **kw: convert.sharded_walk_index_from_numpy(
                i32[None], 2, 4, 0, **kw),
        "blocked_csr_from_numpy": lambda **kw: convert.blocked_csr_from_numpy(
            3, i32, i32, i32, **kw),
        "ell_from_numpy": lambda **kw: convert.ell_from_numpy(
            2, 3, i32, i32.astype(bool), i32.astype(np.float32), [], [], [],
            **kw),
        "key_from_jax": lambda **kw: convert.key_from_jax([0, 1], **kw),
        "model_params_from_numpy":
            lambda **kw: convert.model_params_from_numpy({}, cfg, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        if name != "model_params_from_numpy":
            call(device="cpu")


def test_init_draws_truncated_normals_from_a_generator():
    cfg = TINY["dense"]
    a = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = init_params(cfg, 5, device="cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        assert p.dtype == torch.float32
    w = a.blocks[0].mlp.w_down.detach()         # [d, d_ff], fan_in d_ff
    assert float(w.abs().max()) <= 2 * cfg.d_ff ** -0.5
    assert abs(float(w.std()) * cfg.d_ff ** 0.5 - 0.88) < 0.05
    emb = a.embed.embedding.detach()
    assert float(emb.abs().max()) <= 2.0 and float(emb.abs().max()) > 1.5


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_forward_kernel_matches_plain_path(cuda, arch, dtype):
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype,
                              attn_chunk=64)
    params = init_params(cfg, 0, device=cuda)
    toks = torch.from_numpy(_tokens(cfg, 2, 200)).to(cuda)
    before = ops.launch_counts()["flash_attention"]
    with torch.inference_mode():
        got, _ = forward_train(params, {"tokens": toks}, cfg)
        want, _ = forward_train(params, {"tokens": toks},
                                dataclasses.replace(cfg, attn_impl="torch"))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + cfg.num_layers
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= (5e-2 if dtype == "bfloat16" else 1e-5), rel


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TINY))
def test_cuda_decode_matches_forward(cuda, name):
    cfg = TINY[name]
    params = init_params(cfg, 3, device=cuda)
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=9)).to(cuda)
    with torch.inference_mode():
        logits, _ = forward_train(params, {"tokens": toks}, cfg)
    st = init_decode_state(params, cfg, 2, 12)
    for t in range(12):
        lg, st = decode_step(params, st, toks[:, t], cfg)
        assert float((lg - logits[:, t]).abs().max()) < 3e-4
