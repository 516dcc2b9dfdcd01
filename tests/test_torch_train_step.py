"""One training step of the port against the reference's, on the CPU.

The reduced llama3.2-1b, olmoe-1b-7b (its load-balancing loss weighted
into the loss), llava-next-mistral-7b (its prefix positions dropped from
the loss) and whisper-medium (encoder frames in the batch) start from the
reference's train state carried across with
``convert.train_state_from_numpy`` (step 3, non-zero moments), take one
step on the same numpy-seeded batch with ``weight_decay=0.1``, and give
the reference's loss within 1e-5 relative and its updated parameters and
moments within 1e-4. ``remat=True`` gives the bytes of ``remat=False``;
``accum_steps=2`` gives the full batch's update within 1e-4 (as the
reference's ``tests/test_training.py`` holds its own) and the reference's
``accum_steps=2`` step; ``partial_sync`` raises (the recurrent families
train: ``tests/test_torch_recurrent_train.py``).

On the card (marker ``cuda``, skipped elsewhere inside a fixture): the
reduced llama's float32 step through the ``flash_attention`` and
``flash_attention_bwd`` kernels against the CPU's plain step, and a
repeat of it giving the same bytes. JAX is imported inside the reference
comparisons only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.training import (AdamWConfig, TrainStepConfig,
                                  make_train_step)
from repro_torch.training.train_step import init_train_state

ARCHS = ["llama3.2-1b", "olmoe-1b-7b", "llava-next-mistral-7b",
         "whisper-medium"]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
B, S, FRAMES = 4, 16, 12


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.num_prefix_embeddings, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["encoder_frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def _reference_state(jcfg):
    jax, jnp = _jax()
    from repro.training.train_step import init_train_state as jinit
    state = jinit(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)

    def rand(scale, positive=False):
        def f(p):
            x = rng.standard_normal(p.shape).astype(np.float32) * scale
            return jnp.asarray(np.abs(x) if positive else x)
        return f

    state["opt"] = {"m": jax.tree.map(rand(1e-3), state["params"]),
                    "v": jax.tree.map(rand(1e-5, True), state["params"]),
                    "step": jnp.asarray(3, jnp.int32)}
    return state


def _reference_step(jcfg, state, batch, accum=1):
    jax, jnp = _jax()
    from repro.training import AdamWConfig as JAdamW
    from repro.training import TrainStepConfig as JConfig
    from repro.training.train_step import make_train_step as jmake
    step = jax.jit(jmake(jcfg, JConfig(opt=JAdamW(**OPT), remat=False,
                                       accum_steps=accum)))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, new),
            {k: float(v) for k, v in metrics.items()})


class Case:
    """An architecture's reference config, start state, batch and step."""

    def __init__(self, arch):
        jax, _ = _jax()
        from repro.configs.registry import get_config as jget
        from repro.configs.registry import reduced_config as jreduced
        self.jcfg = jreduced(jget(arch))
        self.tcfg = convert.model_config_from_reference(
            dataclasses.asdict(self.jcfg))
        self.state = _reference_state(self.jcfg)
        self.np_state = jax.tree.map(np.asarray, self.state)
        self.batch = _batch(self.jcfg)
        self.want, self.want_metrics = _reference_step(self.jcfg, self.state,
                                                       self.batch)

    def port_step(self, device="cpu", **kw):
        state = convert.train_state_from_numpy(self.np_state, self.tcfg,
                                               device=device)
        tc = TrainStepConfig(opt=AdamWConfig(**OPT), **{
            "remat": False, **kw})
        step = make_train_step(self.tcfg, tc)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in self.batch.items()}
        return step(state, batch)


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, arch) -> Case:
    if arch not in cases:
        cases[arch] = Case(arch)
    return cases[arch]


def _want_tree(case, tree):
    """A reference tree of the parameters' shape as the port's tensors by
    name."""
    return {k: p.detach() for k, p in convert.model_params_from_numpy(
        tree, case.tcfg, device="cpu").named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(cases, arch):
    case = _case(cases, arch)
    state, metrics = case.port_step()
    want = case.want_metrics
    assert float(metrics["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                        rel=1e-5)
    if arch == "olmoe-1b-7b":
        assert float(metrics["moe_aux_loss"]) == pytest.approx(
            want["moe_aux_loss"], rel=1e-5)
    assert int(state["opt"]["step"]) == 4
    params = _want_tree(case, case.want["params"])
    for k, p in state["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[k].numpy(),
                                   atol=1e-4, err_msg=k)
    for name in ("m", "v"):
        moments = _want_tree(case, case.want["opt"][name])
        for k, t in state["opt"][name].items():
            np.testing.assert_allclose(t.numpy(), moments[k].numpy(),
                                       atol=1e-4, err_msg=(name, k))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(cases, arch):
    case = _case(cases, arch)
    a, ma = case.port_step(remat=False)
    b, mb = case.port_step(remat=True)
    assert float(ma["loss"]) == float(mb["loss"])
    for (k, p), q in zip(a["params"].named_parameters(),
                         b["params"].parameters()):
        assert torch.equal(p, q), k


def test_accum_steps_matches_full_batch(cases):
    case = _case(cases, "llama3.2-1b")
    one, m1 = case.port_step(accum_steps=1)
    two, m2 = case.port_step(accum_steps=2)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for (k, p), q in zip(one["params"].named_parameters(),
                         two["params"].parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-4, err_msg=k)
    # and the reference's own accumulated step
    want, wm = _reference_step(case.jcfg, case.state, case.batch, accum=2)
    assert float(m2["loss"]) == pytest.approx(wm["loss"], rel=1e-5)
    assert float(m2["accuracy"]) == pytest.approx(wm["accuracy"], rel=1e-5)
    params = _want_tree(case, want["params"])
    for k, p in two["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[k].numpy(),
                                   atol=1e-4, err_msg=k)


def test_unported_modes_raise():
    llama = reduced_config(get_config("llama3.2-1b"))
    with pytest.raises(NotImplementedError, match="item 8"):
        make_train_step(llama, TrainStepConfig(mode="partial_sync"))
    with pytest.raises(NotImplementedError, match="item 8"):
        init_train_state(llama, 0, TrainStepConfig(mode="partial_sync"),
                         device="cpu")
    with pytest.raises(ValueError):
        make_train_step(llama, TrainStepConfig(mode="sync"))
    state = init_train_state(llama, 0, device="cpu")
    assert set(state) == {"params", "opt"}
    assert set(state["opt"]) == {"m", "v", "step"}
    assert int(state["opt"]["step"]) == 0
    assert all(float(t.abs().sum()) == 0 for t in state["opt"]["m"].values())


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


def _port_only_step(cfg, device, remat, seed=0):
    from repro_torch.kernels import ops
    state = init_train_state(cfg, 5, device="cpu")
    state["params"] = state["params"].to(device)
    state["opt"] = {k: ({n: t.to(device) for n, t in v.items()}
                        if isinstance(v, dict) else v.to(device))
                    for k, v in state["opt"].items()}
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in _batch(cfg, seed).items()}
    step = make_train_step(cfg, TrainStepConfig(opt=AdamWConfig(**OPT),
                                                remat=remat))
    before = ops.launch_counts()
    state, metrics = step(state, batch)
    after = ops.launch_counts()
    launches = {k: after[k] - before[k]
                for k in ("flash_attention", "flash_attention_bwd")}
    return state, metrics, launches


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_cuda_train_step_matches_cpu(cuda, remat):
    cfg = reduced_config(get_config("llama3.2-1b"))      # float32
    got, gm, launches = _port_only_step(cfg, cuda, remat)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert launches == {"flash_attention": L * (2 if remat else 1),
                        "flash_attention_bwd": L}
    want, wm, _ = _port_only_step(cfg, torch.device("cpu"), remat)
    assert float(gm["loss"]) == pytest.approx(float(wm["loss"]), rel=1e-5)
    assert float(gm["grad_norm"]) == pytest.approx(float(wm["grad_norm"]),
                                                   rel=1e-4)
    for (k, p), q in zip(got["params"].named_parameters(),
                         want["params"].parameters()):
        np.testing.assert_allclose(p.detach().cpu().numpy(),
                                   q.detach().numpy(), atol=1e-4, err_msg=k)
    again, am, _ = _port_only_step(cfg, cuda, remat)
    assert float(am["loss"]) == float(gm["loss"])
    for p, q in zip(again["params"].parameters(), got["params"].parameters()):
        assert torch.equal(p, q)
