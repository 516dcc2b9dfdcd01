"""The port's training substrate against the reference, on the CPU.

``lm_loss`` (mask, z-loss, accuracy, a perfect prediction) against the
reference's on the same numpy-seeded logits; ``adamw_update`` on a reduced
llama3.2-1b's parameters with ``weight_decay=0.1``, whose per-layer norm
scales are stacked matrices in the reference's tree and vectors in the
port's (decay follows the reference's rank), against the reference's
update within 1e-6; ``lr_schedule`` over warmup and decay; global-norm
clipping; ``SyntheticTokens`` byte-equal to the reference's for 2 seeds ×
3 steps; and the launcher on the CPU: 3 steps, a checkpoint, and a resume
that continues the same numbers as a run without the break. JAX is
imported inside the reference comparisons only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.data import SyntheticTokens
from repro_torch.training import AdamWConfig, adamw_init, adamw_update, lm_loss
from repro_torch.training.optimizer import (global_norm, lr_schedule,
                                            reference_rank)


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_lm_loss_matches_reference(masked, z_loss):
    _, jnp = _jax()
    from repro.training import lm_loss as jloss
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 33)) * 3).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want, wm = jloss(jnp.asarray(logits), jnp.asarray(labels),
                     None if mask is None else jnp.asarray(mask),
                     z_loss=z_loss)
    got, gm = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      None if mask is None else torch.from_numpy(mask),
                      z_loss=z_loss)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for k in ("ce_loss", "accuracy", "tokens"):
        assert float(gm[k]) == pytest.approx(float(wm[k]), rel=1e-6), k


def test_lm_loss_mask_and_perfect_prediction():
    logits = torch.zeros(1, 4, 8)
    labels = torch.zeros(1, 4, dtype=torch.int32)
    full, _ = lm_loss(logits, labels, z_loss=0.0)
    half, m_half = lm_loss(logits, labels,
                           mask=torch.tensor([[1, 1, 0, 0]]), z_loss=0.0)
    assert float(full) == pytest.approx(np.log(8), abs=1e-5)
    assert float(half) == pytest.approx(np.log(8), abs=1e-5)
    assert float(m_half["tokens"]) == 2
    _, m0 = lm_loss(logits, labels, mask=torch.zeros(1, 4), z_loss=0.0)
    assert float(m0["ce_loss"]) == 0.0          # denominator max(0, 1)
    labels = torch.tensor([[3, 5]], dtype=torch.int32)
    logits = torch.nn.functional.one_hot(labels.long(), 16).float() * 100.0
    loss, m = lm_loss(logits, labels, z_loss=0.0)
    assert float(loss) < 1e-3 and float(m["accuracy"]) == 1.0
    bf = lm_loss(logits.to(torch.bfloat16), labels)[0]
    assert bf.dtype == torch.float32


def _llama_state():
    """The reduced llama3.2-1b's reference parameters, a step-3 optimizer
    state with non-zero moments, and random gradients; and the port's
    twins."""
    jax, jnp = _jax()
    from repro.configs.registry import get_config, reduced_config
    from repro.models.transformer import init_params
    jcfg = reduced_config(get_config("llama3.2-1b"))
    params = init_params(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(4)

    def rand(scale, positive=False):
        def f(p):
            x = rng.standard_normal(p.shape).astype(np.float32) * scale
            return jnp.asarray(np.abs(x) if positive else x)
        return f

    opt = {"m": jax.tree.map(rand(1e-2), params),
           "v": jax.tree.map(rand(1e-3, positive=True), params),
           "step": jnp.asarray(3, jnp.int32)}
    grads = jax.tree.map(rand(0.05), params)
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, {"params": params, "opt": opt}), tcfg,
        device="cpu")
    tgrads = {k: p.detach().float() for k, p in convert.model_params_from_numpy(
        jax.tree.map(np.asarray, grads), tcfg,
        device="cpu").named_parameters()}
    return jcfg, tcfg, params, opt, grads, state, tgrads


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_adamw_update_decays_by_reference_rank(clip):
    jax, _ = _jax()
    from repro.training.optimizer import adamw_update as jupdate
    jcfg, tcfg, params, opt, grads, state, tgrads = _llama_state()
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               grad_clip=clip)
    want_p, want_opt, wm = jupdate(grads, opt, params, AdamWConfig(**cfg))
    tparams = state["params"]
    got_p, got_opt, gm = adamw_update(tgrads, state["opt"], tparams,
                                      AdamWConfig(**cfg))
    assert got_p is tparams                      # written in place
    assert int(got_opt["step"]) == 4
    assert float(gm["grad_norm"]) == pytest.approx(float(wm["grad_norm"]),
                                                   rel=1e-6)
    assert float(gm["lr"]) == pytest.approx(float(wm["lr"]), rel=1e-6)
    want = dict(convert.model_params_from_numpy(
        jax.tree.map(np.asarray, want_p), tcfg,
        device="cpu").named_parameters())
    ranks = {}
    for k, p in tparams.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[k].detach().numpy(), atol=1e-6,
                                   err_msg=k)
        ranks[k] = reference_rank(k, p)
    # per-layer norm scales are vectors here and decayed (stacked matrices
    # in the reference); the final norm is not
    assert ranks["blocks.0.ln1.scale"] == 2 and \
        tparams.blocks[0].ln1.scale.dim() == 1
    assert ranks["final_norm.scale"] == 1
    for name in ("m", "v"):
        moments = dict(convert.model_params_from_numpy(
            jax.tree.map(np.asarray, want_opt[name]), tcfg,
            device="cpu").named_parameters())
        for k, t in got_opt[name].items():
            np.testing.assert_allclose(t.numpy(), moments[k].detach().numpy(),
                                       rtol=1e-5, atol=1e-9, err_msg=k)


def test_decay_follows_reference_rank_not_port_rank():
    """Under weight decay and a zero gradient, a per-layer norm scale moves
    (decayed as the reference's stacked leaf) and the final norm does
    not."""
    *_, state, tgrads = _llama_state()
    zeros = {k: torch.zeros_like(g) for k, g in tgrads.items()}
    opt = adamw_init(state["params"])
    before = {k: p.detach().clone()
              for k, p in state["params"].named_parameters()}
    adamw_update(zeros, opt, state["params"],
                 AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.1))
    after = dict(state["params"].named_parameters())
    assert not torch.equal(after["blocks.0.ln1.scale"],
                           before["blocks.0.ln1.scale"])
    assert torch.equal(after["final_norm.scale"], before["final_norm.scale"])


@pytest.mark.parametrize("step", [0, 5, 99, 100, 101, 5_000, 10_000, 20_000])
def test_lr_schedule_matches_reference(step):
    _, jnp = _jax()
    from repro.training.optimizer import lr_schedule as jsched
    cfg = AdamWConfig(lr=1e-3, warmup_steps=100, total_steps=10_000,
                      min_lr_ratio=0.1)
    got = float(lr_schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    want = float(jsched(cfg, jnp.asarray(step, jnp.int32)))
    assert got == pytest.approx(want, rel=1e-6)
    assert 0.0 < got <= cfg.lr * 1.0001


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    grads = {"w": torch.full((4,), 1e6)}
    cfg = AdamWConfig(lr=1.0, warmup_steps=1, total_steps=2, grad_clip=1.0,
                      weight_decay=0.0)
    _, _, metrics = adamw_update(grads, adamw_init(params), params, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6)   # pre-clip
    assert float(global_norm(grads)) == pytest.approx(2e6)
    # Adam normalises: each coordinate moves by lr, whatever the clip
    assert torch.allclose(params["w"], torch.full((4,), -1.0), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_tokens_byte_equal(seed):
    from repro.data import SyntheticTokens as JTokens
    for step in range(3):
        want = JTokens(vocab_size=512, seq_len=37, global_batch=3,
                       seed=seed).batch(step)
        got = SyntheticTokens(vocab_size=512, seq_len=37, global_batch=3,
                              seed=seed).batch(step, device="cpu")
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (
                seed, step, k)


def test_launcher_checkpoint_and_resume(tmp_path, capsys):
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train
    base = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    straight = train.main(base + ["--steps", "3",
                                  "--ckpt-dir", str(tmp_path / "a")])
    assert len(straight) == 3
    assert all(np.isfinite(m["loss"]) for m in straight)
    assert latest_step(str(tmp_path / "a")) == 2
    # a run cut after its step-2 checkpoint, then relaunched to 3 steps
    train.main(base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    resumed = train.main(base + ["--steps", "3",
                                 "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out and "[train] done" in out
    assert len(resumed) == 1
    assert resumed[0] == straight[2]
    with pytest.raises(NotImplementedError, match="item 8"):
        train.main(base + ["--steps", "1", "--partial-sync", "0.5"])
