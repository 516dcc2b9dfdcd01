"""The port's LM serving against the reference, on the CPU: sampling
(greedy, and temperature with top-k on the same threefry key), prefill,
``serve_step`` and ``BatchScheduler`` token for token, with the
reference's parameters carried across; and the serving launcher, run
in-process on the CPU, whose default device is the card. Marker
``cuda``: the scheduler's tokens on the card against the CPU's. JAX is
imported inside the reference comparisons only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, prng
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_params
from repro_torch.serving import (BatchScheduler, Request, prefill,
                                 sample_token, serve_step)


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _pair(arch="h2o-danube-3-4b"):
    """The reduced config (danube's is untied: its greedy tokens are not
    the prompt's echo) in both packages, with one set of weights."""
    jax, _ = _jax()
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import reduced_config as jreduced
    from repro.models.transformer import init_params as jinit
    jcfg = jreduced(jget(arch))
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    return jcfg, jp, tcfg, convert.model_params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _logits(B=3, V=500, seed=0):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 3


def test_sample_token_greedy_matches_reference():
    jax, jnp = _jax()
    from repro.serving.decode import sample_token as jsample
    lg = _logits()
    lg[1, 7] = lg[1, 9] = lg[1].max() + 1          # a tie: the first wins
    want = jsample(jnp.asarray(lg), jax.random.PRNGKey(0))
    got = sample_token(torch.from_numpy(lg), prng.PRNGKey(0, "cpu"))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()
    assert got[1] == 7


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 5),
                                               (1.3, 1), (2.0, 50)])
def test_sample_token_temperature_matches_reference(temperature, top_k):
    jax, jnp = _jax()
    from repro.serving.decode import sample_token as jsample
    for seed in range(6):
        lg = _logits(B=4, seed=seed)
        key = jax.random.fold_in(jax.random.PRNGKey(3), seed)
        want = jsample(jnp.asarray(lg), key, temperature=temperature,
                       top_k=top_k)
        got = sample_token(torch.from_numpy(lg),
                           convert.key_from_jax(jax.random.key_data(key),
                                                device="cpu"),
                           temperature=temperature, top_k=top_k)
        assert got.tolist() == np.asarray(want).tolist(), seed
        if top_k:
            kth = np.sort(lg, axis=-1)[:, -top_k]
            assert (lg[np.arange(4), got.numpy()] >= kth).all()


def test_prefill_and_serve_step_match_reference(pair):
    jax, jnp = _jax()
    from repro.serving import prefill as jprefill
    from repro.serving import serve_step as jserve
    jcfg, jp, tcfg, tp = pair
    toks = np.random.default_rng(4).integers(2, jcfg.vocab_size,
                                             (3, 5)).astype(np.int32)
    want, jst = jprefill(jp, jcfg, jnp.asarray(toks), 16)
    got, tst = prefill(tp, tcfg, torch.from_numpy(toks), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert tst.pos == int(jst.pos) == 5
    for tl, jl in zip(tst.layers, jst.layers):
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       atol=1e-5)
    cur_j = jnp.argmax(want, -1).astype(jnp.int32)
    cur_t = torch.argmax(got, -1).to(torch.int32)
    for step, (temperature, top_k) in enumerate([(0.0, 0), (0.0, 0),
                                                 (0.9, 20), (1.5, 0)]):
        key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        cur_j, jst = jserve(jp, jst, cur_j, jcfg, key=key,
                            temperature=temperature, top_k=top_k)
        cur_t, tst = serve_step(tp, tst, cur_t, tcfg,
                                key=prng.fold_in(prng.PRNGKey(0, "cpu"),
                                                 step),
                                temperature=temperature, top_k=top_k)
        assert cur_t.tolist() == np.asarray(cur_j).tolist(), step
    # the default key is PRNGKey(0)
    a, _ = jserve(jp, jst, cur_j, jcfg, temperature=1.0)
    b, _ = serve_step(tp, tst, cur_t, tcfg, temperature=1.0)
    assert b.tolist() == np.asarray(a).tolist()


def _requests(V, n=6, max_new=8):
    rng = np.random.default_rng(0)
    return [(r, [int(x) for x in rng.integers(2, V, 3 + r % 5)], max_new)
            for r in range(n)]


def test_batch_scheduler_matches_reference(pair):
    """Six requests in two waves (left-padded prompts of 3-7 tokens),
    ``eos_id`` 77 ending some early: the reference's tokens."""
    from repro.serving import BatchScheduler as JScheduler
    from repro.serving import Request as JRequest
    jcfg, jp, tcfg, tp = pair
    outs = []
    for sched, req in ((JScheduler(jp, jcfg, max_batch=4, max_len=32,
                                   eos_id=77), JRequest),
                       (BatchScheduler(tp, tcfg, max_batch=4, max_len=32,
                                       eos_id=77), Request)):
        for rid, prompt, max_new in _requests(jcfg.vocab_size):
            sched.submit(req(rid=rid, prompt=prompt, max_new_tokens=max_new))
        done = sched.run()
        assert all(r.done for r in done) and not sched.queue
        outs.append([(r.rid, r.output) for r in done])
    assert outs[1] == outs[0]
    lens = [len(o) for _, o in outs[1]]
    assert min(lens) < 8 and max(lens) == 8, lens       # eos ended some
    assert all(o[-1] == 77 for _, o in outs[1] if len(o) < 8)


def test_launcher_runs_in_process_on_the_cpu(capsys):
    jax, _ = _jax()
    done = launch_serve.main(["--arch", "llama3.2-1b", "--smoke",
                              "--device", "cpu", "--requests", "6",
                              "--max-new", "3"])
    out = capsys.readouterr().out
    assert "6 requests, 18 tokens" in out and "on cpu" in out
    assert [r.rid for r in done] == list(range(6))
    assert all(r.done and len(r.output) == 3 for r in done)
    # the prompts are the reference launcher's draws
    cfg = reduced_config(get_config("llama3.2-1b"))
    rng = jax.random.PRNGKey(1)
    for r in launch_serve.make_requests(cfg, 6, 0, 3):
        want = jax.random.randint(jax.random.fold_in(rng, r.rid),
                                  (3 + r.rid % 5,), 2, cfg.vocab_size)
        assert r.prompt == [int(t) for t in want]


def test_launcher_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "llama3.2-1b", "--smoke"])
    cfg = reduced_config(get_config("llama3.2-1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "h2o-danube-3-4b",
                                  "gemma3-4b"])
def test_cuda_scheduler_matches_cpu(cuda, arch):
    cfg = reduced_config(get_config(arch))
    cpu = init_params(cfg, 0, device="cpu")
    outs = []
    for params in (cpu, init_params(cfg, device="meta")):
        if params is not cpu:
            params.load_state_dict({k: v.to(cuda) for k, v in
                                    cpu.state_dict().items()}, assign=True)
        sched = BatchScheduler(params, cfg, max_batch=4, max_len=64)
        for rid, prompt, max_new in _requests(cfg.vocab_size, max_new=12):
            sched.submit(Request(rid=rid, prompt=prompt,
                                 max_new_tokens=max_new))
        outs.append([r.output for r in sched.run()])
    assert outs[0] == outs[1]
