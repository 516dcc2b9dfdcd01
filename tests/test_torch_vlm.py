"""The port's VLM family (``"vlm"``, llava-next-mistral-7b) against the
reference, on the CPU.

The reference's parameters are carried across with
``convert.model_params_from_numpy`` (the d×d projector transposed like
every dense matrix: it is square, so only the values can show a missed
transpose) and the same numpy-seeded tokens and patch embeddings go
through both packages, float32, within 1e-4: ``forward_train``'s logits
at every prefix and text position, and ``decode_step`` at every step
(the dense path over text, as the reference's). The reference's programs
run once, in a module fixture. Then the reference's own invariant
(decode reproduces a forward with an empty prefix), the configs,
``shape_applicable``, the ``meta`` tree of the full config against the
reference's tree and the launcher's tokens (text only) against the
reference launcher's. Marker ``cuda``: ``flash_attention`` at llava's
32/8 heads of 128 over 32,768 positions against the chunked version; the
reduced model through the kernel against the plain path and decode
against the forward; and the int8 KV cache decoding on the card (reduced
llama3.2-1b and llava) against the CPU's and the float cache. JAX is
imported inside the reference comparisons only.
"""
import copy
import dataclasses
import re
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

from test_torch_encdec import reference_tree_shapes

ARCH = "llava-next-mistral-7b"
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
    """The reduced llava in both packages (one set of weights), the
    inputs, and the reference's forward logits and decode steps."""
    jax, jnp = _jax()
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    from repro.models import transformer as jt
    jcfg = jreduced(jget(ARCH))
    jp = jax.jit(jt.init_params, static_argnums=0)(jcfg,
                                                    jax.random.PRNGKey(1))
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    prefix = rng.standard_normal(
        (B, jcfg.num_prefix_embeddings, jcfg.d_model)).astype(np.float32)
    out = dict(jcfg=jcfg, tcfg=tcfg, tp=tp, toks=toks, prefix=prefix)
    out["logits"] = np.asarray(jt.forward_train(
        jp, {"tokens": jnp.asarray(toks),
             "prefix_embeds": jnp.asarray(prefix)}, jcfg)[0])
    step = jax.jit(jt.decode_step, static_argnums=3)
    st = jt.init_decode_state(jp, jcfg, B, S)
    steps = []
    for t in range(S):
        lg, st = step(jp, st, jnp.asarray(toks[:, t]), jcfg)
        steps.append(np.asarray(lg))
    out["steps"] = steps
    return out


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_forward_train_matches_reference(ref, impl):
    """``[B, P + S, V]`` logits, the P prefix positions included."""
    cfg = dataclasses.replace(ref["tcfg"], attn_impl=impl)
    P = cfg.num_prefix_embeddings
    with torch.no_grad():
        got, aux = forward_train(
            ref["tp"], {"tokens": torch.from_numpy(ref["toks"]),
                        "prefix_embeds": torch.from_numpy(ref["prefix"])},
            cfg)
    assert got.shape == (B, P + S, cfg.vocab_size) and aux == {}
    _close(got[:, :P], ref["logits"][:, :P])
    _close(got, ref["logits"])


def test_decode_step_matches_reference(ref):
    cfg, tp = ref["tcfg"], ref["tp"]
    st = init_decode_state(tp, cfg, B, S)
    assert st.cross is None and st.shared is None
    for t in range(S):
        got, st = decode_step(tp, st, torch.from_numpy(ref["toks"][:, t]),
                              cfg)
        _close(got, ref["steps"][t])
    assert st.pos == S


def test_prefix_goes_through_the_projector(ref):
    """The text attends to the projected prefix: with the projector
    zeroed, the text positions' logits move."""
    cfg, tp = ref["tcfg"], copy.deepcopy(ref["tp"])
    batch = {"tokens": torch.from_numpy(ref["toks"]),
             "prefix_embeds": torch.from_numpy(ref["prefix"])}
    with torch.no_grad():
        tp.vision_proj.kernel.zero_()
        got, _ = forward_train(tp, batch, cfg)
    P = cfg.num_prefix_embeddings
    assert not np.allclose(got[:, P:].numpy(), ref["logits"][:, P:],
                           atol=1e-3)
    assert tuple(tp.vision_proj.kernel.shape) == (cfg.d_model, cfg.d_model)


def test_decode_matches_forward():
    """The reference's invariant, on the port: step-by-step decode
    reproduces a forward with an empty prefix within 3e-4."""
    cfg = reduced_config(get_config(ARCH))
    params = init_params(cfg, 3, device="cpu")
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 10)))
    empty = torch.zeros(B, 0, cfg.d_model)
    with torch.no_grad():
        logits, _ = forward_train(params, {"tokens": toks,
                                           "prefix_embeds": empty}, cfg)
    assert logits.shape[1] == 10
    st = init_decode_state(params, cfg, B, 10)
    errs = []
    for t in range(10):
        lg, st = decode_step(params, st, toks[:, t], cfg)
        errs.append(float((lg - logits[:, t]).abs().max()))
    assert max(errs) < 3e-4, errs


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
        assert tc.param_count == 7_258_243_072


def test_param_tree_matches_reference_tree():
    """The full config's tree (built without storage) equals the
    reference's tree leaf for leaf, in names and shapes: 7,258,509,312
    parameters, the analytic count and 65 norm scales of 4,096."""
    jax, _ = _jax()
    from repro.configs.registry import get_config as jget
    from repro.models.transformer import init_params as jinit
    shapes = jax.eval_shape(lambda k: jinit(jget(ARCH), k),
                            jax.ShapeDtypeStruct((2,), np.uint32))
    want = reference_tree_shapes(shapes, {"blocks": 32})
    params = init_params(get_config(ARCH), device="meta")
    got = {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert got == want
    total = sum(int(np.prod(s)) for s in got.values())
    norms = sum(int(np.prod(s)) for n, s in got.items()
                if n.endswith(".scale"))
    assert total == 7_258_509_312 and norms == 65 * 4096
    assert total - norms == get_config(ARCH).param_count


def test_launcher_tokens_equal_reference_launcher(monkeypatch, capsys):
    """``--arch llava-next-mistral-7b --smoke --device cpu`` (text only,
    as the reference's launcher serves it) with the reference launcher's
    weights carried across: its tokens are the reference launcher's,
    request for request."""
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
    assert "llava-next-mistral-7b-smoke on cpu" in capsys.readouterr().out
    assert {r.rid: r.output for r in done} == want


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


ATTN_REL = {"bfloat16": 1e-3, "float32": 1e-5}


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_gqa_128_attention_at_32k_matches_chunked(cuda, dtype):
    """Causal ``flash_attention`` at llava's 32 query heads over 8 K/V
    heads of 128, S = 32,768, within ``ATTN_REL`` of the chunked
    version, over all rows and the last eighth."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    dt = getattr(torch, dtype)
    Sq = 32_768
    q, k, v = (torch.randn((1, h, Sq, 128), generator=gen, device=cuda,
                           dtype=dt) for h in (32, 8, 8))
    got = ops.attention(q, k, v, causal=True, impl="cuda")
    want = kref.attention_chunked(q, k, v, causal=True)
    torch.cuda.synchronize()
    tail = slice(Sq - Sq // 8, Sq)
    assert _rel(got, want) <= ATTN_REL[dtype]
    assert _rel(got[:, :, tail], want[:, :, tail]) <= ATTN_REL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_forward_kernel_matches_plain_path(cuda, dtype):
    """The reduced llava (4 prefix embeddings + 196 tokens) through
    ``flash_attention``, one launch a layer, against the plain path."""
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dtype)
    params = init_params(cfg, 0, device=cuda)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 196))).to(cuda),
        "prefix_embeds": torch.from_numpy(rng.standard_normal(
            (2, cfg.num_prefix_embeddings, cfg.d_model)).astype(
                np.float32)).to(cuda)}
    before = ops.launch_counts()["flash_attention"]
    with torch.inference_mode():
        got, _ = forward_train(params, batch, cfg)
        want, _ = forward_train(params, batch,
                                dataclasses.replace(cfg, attn_impl="torch"))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + cfg.num_layers
    assert got.shape[1] == 200
    assert _rel(got, want) <= (5e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.cuda
def test_cuda_decode_matches_forward(cuda):
    cfg = reduced_config(get_config(ARCH))
    params = init_params(cfg, 3, device=cuda)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))).to(
        cuda)
    empty = torch.zeros(2, 0, cfg.d_model, device=cuda)
    with torch.inference_mode():
        logits, _ = forward_train(params, {"tokens": toks,
                                           "prefix_embeds": empty}, cfg)
    st = init_decode_state(params, cfg, 2, 12)
    for t in range(12):
        lg, st = decode_step(params, st, toks[:, t], cfg)
        assert float((lg - logits[:, t]).abs().max()) < 3e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", ARCH])
def test_cuda_int8_kv_cache_decode_matches_cpu(cuda, arch):
    """Decode with ``kv_cache_dtype="int8"`` on the card against the CPU
    (one set of weights, the same tokens), each step from the card's
    caches (copied into the CPU's state first): the int8 K/V each step
    writes equal the CPU's but for isolated one-quantum flips (a value
    within an ulp of a rounding boundary, the two devices summing in
    another order, rounds either way; at most 0.1% of the values, the
    reference comparison's allowance); the logits within 1e-5 in
    relative error at every step whose writes agree; and within the CPU
    test's 0.15 of the float cache's forward at every step."""
    cfg = reduced_config(get_config(arch))
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    cpu_params = init_params(cfg, 11, device="cpu")
    card_params = copy.deepcopy(cpu_params).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.zeros(2, 0, cfg.d_model)
    with torch.no_grad():
        logits, _ = forward_train(cpu_params, batch, cfg)
    st_cpu = init_decode_state(cpu_params, cfg8, 2, 12)
    st_card = init_decode_state(card_params, cfg8, 2, 12)
    assert st_card.layers[0]["k"].dtype == torch.int8
    flips = written = strict = 0
    for t in range(12):
        for lc, lg in zip(st_cpu.layers, st_card.layers, strict=True):
            for name, tensor in lc.items():
                tensor.copy_(lg[name].cpu())
        want, st_cpu = decode_step(cpu_params, st_cpu, toks[:, t], cfg8)
        got, st_card = decode_step(card_params, st_card,
                                   toks[:, t].to(cuda), cfg8)
        step_flips = 0
        for lc, lg in zip(st_cpu.layers, st_card.layers, strict=True):
            for name in ("k", "v"):
                diff = (lc[name][:, :, t].int()
                        - lg[name][:, :, t].cpu().int()).abs()
                assert int(diff.max()) <= 1, (t, name)
                step_flips += int((diff > 0).sum())
                written += diff.numel()
        if step_flips == 0:
            assert _rel(got.cpu(), want) <= 1e-5, t
            strict += 1
        flips += step_flips
        assert float((got.cpu() - logits[:, t]).abs().max()) < 0.15, t
    assert flips <= 1e-3 * written and strict >= 10, (flips, strict)
