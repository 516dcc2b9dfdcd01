"""One training step of the recurrent families against the reference's,
on the CPU.

The reduced rwkv6-3b (``"ssm"``) and zamba2-1.2b (``"hybrid"``, its
shared attention block after every second Mamba-2 layer) start from the
reference's train state carried across with
``convert.train_state_from_numpy`` (step 3, non-zero moments), take one
step on the same numpy-seeded batch with ``weight_decay=0.1``
(``test_torch_train_step.py``'s ``Case``), and give the reference's loss
within 1e-5 relative and its updated parameters and moments within 1e-4:
the gradients run through the plain scans under ``chunked_scan`` on the
port's side and through XLA's ``lax.scan`` on the reference's.
``remat=True`` gives the bytes of ``remat=False``, and ``init_train_state``
takes both families. The launcher trains ``--arch rwkv6-3b --smoke`` and
``zamba2-1.2b`` on the CPU.

On the card (marker ``cuda``, skipped elsewhere inside a fixture): each
reduced model's float32 step through the scan kernels and their backward
kernels (zamba2's attention through ``flash_attention`` and its backward)
against the CPU's plain step, with ``remat`` on and off, the launches
counted, and a repeat of it giving the same bytes. JAX is imported inside
the reference comparisons only.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.training import (AdamWConfig, TrainStepConfig,
                                  make_train_step)
from repro_torch.training.train_step import init_train_state
from test_torch_train_step import OPT, Case, _batch, _want_tree

ARCHS = ["rwkv6-3b", "zamba2-1.2b"]


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain scans' loops run many small torch ops: on one thread they
    do not wait on a thread pool that XLA's workers also hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, arch) -> Case:
    if arch not in cases:
        cases[arch] = Case(arch)
    return cases[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(cases, arch):
    case = _case(cases, arch)
    state, metrics = case.port_step()
    want = case.want_metrics
    assert float(metrics["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                        rel=1e-5)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_families_train(arch):
    cfg = reduced_config(get_config(arch))
    tc = TrainStepConfig(opt=AdamWConfig(**OPT))
    state = init_train_state(cfg, 0, tc, device="cpu")
    step = make_train_step(cfg, tc)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    for _ in range(2):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"]))
        assert float(metrics["grad_norm"]) > 0
    assert int(state["opt"]["step"]) == 2


def test_launcher_trains_recurrent(capsys):
    from repro_torch.launch import train
    for arch in ARCHS:
        history = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--batch", "2", "--seq", "16", "--steps", "2"])
        assert len(history) == 2
        assert all(np.isfinite(m["loss"]) for m in history)
    assert capsys.readouterr().out.count("[train] done") == len(ARCHS)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


COUNTED = ("wkv6_scan", "wkv6_scan_bwd", "ssd_scan", "ssd_scan_bwd",
           "flash_attention", "flash_attention_bwd")


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
    return state, metrics, {k: after[k] - before[k] for k in COUNTED}


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_train_step_matches_cpu(cuda, arch, remat):
    cfg = reduced_config(get_config(arch))      # float32
    got, gm, launches = _port_only_step(cfg, cuda, remat)
    torch.cuda.synchronize()
    L, fwd = cfg.num_layers, 2 if remat else 1
    if arch == "rwkv6-3b":
        want_launches = dict.fromkeys(COUNTED, 0) | {
            "wkv6_scan": L * fwd, "wkv6_scan_bwd": L}
    else:
        sites = L // cfg.shared_attn_every
        want_launches = dict.fromkeys(COUNTED, 0) | {
            "ssd_scan": L * fwd, "ssd_scan_bwd": L,
            "flash_attention": sites * fwd, "flash_attention_bwd": sites}
    assert launches == want_launches
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
