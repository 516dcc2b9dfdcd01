"""The port's MoE family against the reference, on the CPU.

The reference's parameters are carried across with
``convert.model_params_from_numpy`` and the same numpy-seeded inputs go
through both packages, float32: ``moe_forward`` at the reference's tiny
MoE config (``tests/test_models.py``) within 1e-5, ``aux_loss`` within
1e-6 and ``dropped`` equal, at capacity factors 4.0 and 0.1, with and
without an ``expert_mask`` (one that leaves fewer than k experts makes
ties, which go to the lower index as ``lax.top_k``'s do), through the
group split (S = 8,192) and two dispatch chunks (B = 64); the port's
``moe_forward`` against the plain mixture ``moe_mixture_ref`` within
1e-4; ``forward_train`` (logits and ``moe_aux_loss``) and
``decode_step`` of the reduced olmoe-1b-7b and phi3.5-moe within 1e-4;
decode against the forward; the configs and ``param_count`` /
``active_param_count`` against the reference's and the ``meta``-device
module trees; the launcher's tokens against the reference launcher's;
and ``examples/torch_serve_lm.py`` on the CPU. Marker ``cuda``: the MoE
forward through ``flash_attention`` against the plain path, and the MoE
layer on the card against the CPU. JAX is imported inside the reference
comparisons only.
"""
import copy
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (ModelConfig, decode_step, forward_train,
                                init_decode_state, init_params)
from repro_torch.models import moe as tmoe

MOE = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
REPO = pathlib.Path(__file__).resolve().parents[1]
# tests/test_models.py's tiny MoE config
TINY = dict(family="moe", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=4, d_ff=64, vocab_size=128, num_experts=8,
            num_experts_per_tok=2, moe_capacity_factor=4.0, dtype="float32")


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


def _tiny(**overrides):
    from repro.models.config import ModelConfig as JConfig
    return JConfig(**{**TINY, **overrides})


@pytest.fixture(scope="module")
def tiny():
    return (_tiny(),) + _carry(_tiny())


@pytest.fixture(scope="module")
def reduced():
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    return {arch: (jreduced(jget(arch)),) + _carry(jreduced(jget(arch)))
            for arch in MOE}


def _x(B, S, d, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _layer(jp, tp, i=0):
    jax, _ = _jax()
    return jax.tree.map(lambda a: a[i], jp["blocks"]["moe"]), tp.blocks[i].moe


# (capacity factor, B, S, expert mask): no drop, drops, a mask, a mask
# leaving one expert for k = 2 (ties), the group split, two chunks
CASES = {
    "cf4": (4.0, 2, 8, None),
    "cf0.1": (0.1, 2, 64, None),
    "cf4_mask": (4.0, 2, 16, [1, 0, 1, 1, 0, 1, 1, 1]),
    "cf0.1_mask": (0.1, 2, 64, [1, 1, 0, 1, 1, 0, 1, 1]),
    "mask_below_k": (0.5, 2, 16, [0, 0, 0, 1, 0, 0, 0, 0]),
    "group_split": (0.5, 1, 8192, None),
    "chunks": (0.5, 64, 16, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_matches_reference(tiny, case):
    jax, jnp = _jax()
    from repro.models.moe import moe_forward as jmoe
    cf, B, S, mask = CASES[case]
    _, jp, tcfg, tp = tiny
    jcfg = _tiny(moe_capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cf)
    jl, tl = _layer(jp, tp)
    x = _x(B, S, jcfg.d_model)
    jm = None if mask is None else jnp.asarray(np.array(mask, bool))
    tm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
    want, jaux = jax.jit(jmoe, static_argnums=2)(jl, jnp.asarray(x), jcfg,
                                                 jm)
    with torch.no_grad():
        got, taux = tmoe.moe_forward(tl, torch.from_numpy(x), tcfg, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert abs(float(taux["aux_loss"]) - float(jaux["aux_loss"])) <= 1e-6
    dropped = int(taux["dropped"])
    assert dropped == int(jaux["dropped"])
    assert (dropped > 0) == (cf < 1.0), dropped
    if case == "group_split":
        assert tmoe.group_size(S) == 4096
    if case == "chunks":
        assert min(tcfg.moe_dispatch_chunks, B // 32) == 2


def test_route_ties_go_to_the_lower_index(tiny):
    """A mask leaving one expert for k = 2: every other expert sits at
    probability 0, and the second pick is the lowest masked index, as
    ``lax.top_k`` picks it."""
    jax, jnp = _jax()
    _, jp, tcfg, tp = tiny
    jl, tl = _layer(jp, tp)
    x = _x(2, 16, tcfg.d_model)
    mask = np.zeros(8, bool)
    mask[3] = True
    logits = np.where(mask, x @ np.asarray(jl["router"]), -np.inf)
    want_p, want_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), 2)
    with torch.no_grad():
        _, top_p, top_e = tmoe.route(tl, torch.from_numpy(x), tcfg,
                                     torch.from_numpy(mask))
    assert top_e.tolist() == np.asarray(want_e).tolist()
    assert (top_e[..., 0] == 3).all() and (top_e[..., 1] == 0).all()
    np.testing.assert_allclose(top_p.numpy(), np.asarray(want_p), atol=1e-6)


@pytest.mark.parametrize("cf", [4.0, 0.1])
def test_moe_forward_matches_mixture_ref(tiny, cf):
    """Where no pair dropped, the capacity dispatch is the plain per-token
    mixture; at factor 0.1 only the tokens that kept every pick are."""
    _, _, tcfg, tp = tiny
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cf)
    tl = tp.blocks[1].moe
    x = torch.from_numpy(_x(2, 64, tcfg.d_model, seed=7))
    with torch.no_grad():
        got, aux = tmoe.moe_forward(tl, x, tcfg)
        want = tmoe.moe_mixture_ref(tl, x, tcfg)
    if cf > 1:
        assert int(aux["dropped"]) == 0
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
        return
    # the kept pairs by a plain count: a pair's rank is the number of
    # earlier pairs of its group on its expert
    _, _, top_e = tmoe.route(tl, x, tcfg)
    E, C = tcfg.num_experts, tmoe.capacity(tcfg, 64)
    flat = top_e.reshape(2, -1)
    onehot = torch.nn.functional.one_hot(flat, E)
    rank = (onehot.cumsum(1) - 1).gather(2, flat[..., None])[..., 0]
    kept = (rank < C).reshape(2, 64, -1).all(-1)
    assert int(aux["dropped"]) == int((rank >= C).sum()) > 0
    assert 0 < int(kept.sum()) < 128
    np.testing.assert_allclose(got[kept].numpy(), want[kept].numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_forward_train_matches_reference(reduced, arch):
    _, jnp = _jax()
    from repro.models.transformer import forward_train as jfwd
    jcfg, jp, tcfg, tp = reduced[arch]
    toks = _tokens(jcfg, 2, 16)
    want, jaux = jfwd(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        got, taux = forward_train(tp, {"tokens": torch.from_numpy(toks)},
                                  tcfg)
    assert got.shape == (2, 16, jcfg.vocab_size)
    assert set(taux) == set(jaux) == {"moe_aux_loss"}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert abs(float(taux["moe_aux_loss"])
               - float(jaux["moe_aux_loss"])) <= 1e-6


@pytest.mark.parametrize("arch", MOE)
def test_decode_step_matches_reference(reduced, arch):
    jax, jnp = _jax()
    from repro.models import transformer as jt
    jcfg, jp, tcfg, tp = reduced[arch]
    toks = _tokens(jcfg, 2, 8, seed=5)
    jst = jt.init_decode_state(jp, jcfg, 2, 8)
    tst = init_decode_state(tp, tcfg, 2, 8)
    jstep = jax.jit(jt.decode_step, static_argnums=3)
    for t in range(8):
        want, jst = jstep(jp, jst, jnp.asarray(toks[:, t]), jcfg)
        got, tst = decode_step(tp, tst, torch.from_numpy(toks[:, t]), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert tst.pos == int(jst.pos) == 8


def test_decode_matches_forward():
    """The serving invariant for the tiny MoE config: decode (each token a
    group of its own) reproduces the forward's logits at every position."""
    cfg = ModelConfig(**TINY)
    params = init_params(cfg, 3, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=9))
    with torch.no_grad():
        logits, aux = forward_train(params, {"tokens": toks}, cfg)
    assert torch.isfinite(aux["moe_aux_loss"])
    st = init_decode_state(params, cfg, 2, 12)
    errs = []
    for t in range(12):
        lg, st = decode_step(params, st, toks[:, t], cfg)
        errs.append(float((lg - logits[:, t]).abs().max()))
    assert max(errs) < 3e-4, errs


@pytest.mark.parametrize("full", [True, False])
def test_configs_match_reference(full):
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    for arch in MOE:
        jc = jget(arch) if full else jreduced(jget(arch))
        tc = get_config(arch) if full else reduced_config(get_config(arch))
        for f in dataclasses.fields(ModelConfig):
            if f.name != "attn_impl":
                assert getattr(tc, f.name) == getattr(jc, f.name), (
                    arch, f.name)
        assert tc.param_count == jc.param_count
        assert tc.active_param_count == jc.active_param_count
        assert convert.model_config_from_reference(
            dataclasses.asdict(jc)) == dataclasses.replace(
                tc, attn_impl="torch")


@pytest.mark.parametrize("arch", MOE)
def test_param_counts_match_module_tree(arch):
    """The analytic counts leave the norm scales out, as the reference's
    do; the full config's tree (built without storage) matches them, and
    the active count is the tree less the unpicked experts."""
    cfg = get_config(arch)
    params = init_params(cfg, device="meta")
    total = sum(p.numel() for p in params.parameters())
    norms = sum(p.numel() for n, p in params.named_parameters()
                if n.endswith(".scale"))
    experts = sum(p.numel() for n, p in params.named_parameters()
                  if ".moe.w_" in n)
    assert total - norms == cfg.param_count
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    assert total - norms - experts * (E - k) // E == cfg.active_param_count
    assert params.blocks[0].moe.router.shape == (E, cfg.d_model)
    assert params.blocks[0].moe.w_down.shape == (E, cfg.d_ff, cfg.d_model)
    if arch == "olmoe-1b-7b":
        assert (cfg.param_count, cfg.active_param_count) == (
            6_919_028_736, 1_281_884_160)


def test_moe_config_validation():
    for k, E in ((0, 8), (9, 8), (2, 0)):
        with pytest.raises(ValueError, match="num_experts_per_tok"):
            ModelConfig(family="moe", num_experts=E, num_experts_per_tok=k)
    dense = ModelConfig()
    assert dense.active_param_count == dense.param_count


def test_launcher_tokens_equal_reference_launcher(monkeypatch, capsys):
    """``--arch olmoe-1b-7b --smoke --device cpu`` with the reference
    launcher's weights carried across: its tokens are the reference
    launcher's, request for request."""
    jax, _ = _jax()
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    from repro.launch import serve as jserve
    from repro.models.transformer import init_params as jinit
    from repro.serving import scheduler as jsched
    # the reference launcher's init and step, compiled once (the same
    # values as its eager calls, in a fraction of the time)
    jinit = jax.jit(jinit, static_argnums=0)
    monkeypatch.setattr(jserve, "init_params", jinit)
    monkeypatch.setattr(jsched, "serve_step", jax.jit(
        jsched.serve_step, static_argnames=("cfg", "temperature", "top_k")))
    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--requests", "4",
            "--max-new", "5"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    lines = capsys.readouterr().out
    want = {int(r): [int(t) for t in toks.split(",")]
            for r, toks in re.findall(r"req (\d+): \d+ tokens → \[([^]]*)\]",
                                      lines)}
    assert sorted(want) == list(range(4))
    jcfg = jreduced(jget("olmoe-1b-7b"))

    def carried(cfg, seed, device):
        assert cfg.name == jcfg.name
        tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
        return convert.model_params_from_numpy(tree, cfg, device=device)

    monkeypatch.setattr(launch_serve, "init_params", carried)
    done = launch_serve.main(argv + ["--device", "cpu"])
    assert "on cpu" in capsys.readouterr().out
    assert {r.rid: r.output for r in done} == want


def test_example_serves_olmoe_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_serve_lm.py"),
         "--arch", "olmoe-1b-7b", "--requests", "3", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    assert out.stdout.count("[serve] req") == 3
    assert "olmoe-1b-7b-smoke on cpu: 3 requests" in out.stdout


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_forward_kernel_matches_plain_path(cuda, arch, dtype):
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype,
                              attn_chunk=64)
    params = init_params(cfg, 0, device=cuda)
    toks = torch.from_numpy(_tokens(cfg, 2, 200)).to(cuda)
    before = ops.launch_counts()["flash_attention"]
    with torch.inference_mode():
        got, aux = forward_train(params, {"tokens": toks}, cfg)
        want, _ = forward_train(params, {"tokens": toks},
                                dataclasses.replace(cfg, attn_impl="torch"))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + cfg.num_layers
    assert torch.isfinite(aux["moe_aux_loss"])
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= (5e-2 if dtype == "bfloat16" else 1e-5), rel


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [4.0, 0.1])
def test_cuda_moe_layer_matches_cpu(cuda, cf):
    """The MoE layer in float32 on the card against the CPU: the same
    dropped pairs, outputs within 1e-5, and 1e-4 of the plain mixture
    where nothing dropped."""
    cfg = ModelConfig(**{**TINY, "moe_capacity_factor": cf})
    layer = init_params(cfg, 0, device="cpu").blocks[0].moe
    x = torch.from_numpy(_x(4, 512, cfg.d_model))
    with torch.inference_mode():
        want, waux = tmoe.moe_forward(layer, x, cfg)
        ref = tmoe.moe_mixture_ref(layer, x, cfg)
        got, gaux = tmoe.moe_forward(copy.deepcopy(layer).to(cuda),
                                     x.to(cuda), cfg)
    assert int(gaux["dropped"]) == int(waux["dropped"])
    assert (int(waux["dropped"]) > 0) == (cf < 1.0)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    assert abs(float(gaux["aux_loss"]) - float(waux["aux_loss"])) <= 1e-6
    if cf > 1:
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(),
                                   atol=1e-4)
