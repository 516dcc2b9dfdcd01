"""The port's distributed engine and GraphLab-PR baseline against the
reference's, on the CPU.

The twin of ``tests/test_multidevice.py``'s engine tests (``:9-51``,
``:240-259``) on ``chung_lu_powerlaw(n=2048, avg_out_deg=10, seed=1)`` at
S = 8. The reference runs once for the module, in a subprocess on 8 forced
host devices: its engine at p_s = 1 with the ``"xla"`` and ``"pallas"``
steps (the Pallas step in interpret mode, as its own tests run it), at
p_s = 0.4 with the rejection and cumsum draws, and with the streamed step
over ``vertex_block=64`` slabs; ``distributed_power_iteration`` (60
iterations); ``_pack_by_shard`` on inputs that overflow; the
``DistributedGraph`` arrays. The port's ``EngineResult.counts`` and its
four per-step statistics must equal the reference's byte for byte on one
``ShardMesh(8, "cpu")`` (across 2 gloo ranks of 4 shards each in
``tests/test_torch_engine_gloo.py``). Then the reference's own claims
hold on the port: conservation, no overflow, μ_20 above 0.95 and 0.80, a
sync ratio in (0.25, 0.55), the walker and the engine within 0.08 in total
variation. Marker ``cuda``: the engine on the card against the CPU, a
one-rank NCCL group against no group, and a gloo group refusing CUDA
tensors.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC
from repro_torch import FrogWildService, RuntimeConfig, ShardConfig, prng
from repro_torch.service import batch_pagerank
from repro_torch.config import EngineConfig, KernelConfig
from repro_torch.core import normalized_mass_captured, power_iteration
from repro_torch.core.frogwild import frogwild
from repro_torch.distributed.runtime import ShardMesh, ShardRuntime
from repro_torch.engine import (build_distributed_graph, distributed_frogwild,
                                distributed_power_iteration,
                                frogwild_bytes_measured)
from repro_torch.engine.baseline import build_pull_graph
from repro_torch.engine.gas import (_blocking_draw, _distributed_frogwild,
                                    _pack_by_shard, channel_capacity)
from repro_torch.graph import chung_lu_powerlaw

S = 8
N, T = 100_000, 8
ITERS = 60
VB = 64
# name → (reference EngineConfig kwargs, the port's step_impl, p_s, draw,
#         graph with slabs)
CONFIGS = {
    "p1_xla": (dict(p_s=1.0), "torch", 1.0, "auto", False),
    "p1_pallas": (dict(p_s=1.0, step_impl="pallas"), "auto", 1.0, "auto",
                  False),
    "p04_rejection": (dict(p_s=0.4, draw="rejection"), "auto", 0.4,
                      "rejection", False),
    "p04_cumsum": (dict(p_s=0.4, draw="cumsum"), "auto", 0.4, "cumsum",
                   False),
    "p1_stream": (dict(p_s=1.0, step_impl="stream"), "stream", 1.0, "auto",
                  True),
}
STATS = ("sent_per_step", "open_channels_per_step", "sync_msgs_per_step")
# _pack_by_shard cases (B, S, shard_size, cap): each overflows
PACK = ((64, 4, 16, 8), (200, 8, 32, 8), (37, 3, 5, 8))
DG_FIELDS = ("row_ptr", "col_idx", "deg", "edge_src", "edge_dst_shard",
             "chan_cnt", "col_sorted")
BLK_FIELDS = ("blk_row_off", "blk_deg", "blk_col")


def _graph():
    return chung_lu_powerlaw(n=2048, avg_out_deg=10, seed=1)


def _pack_input(B, S_, sz, seed):
    """Destinations in ``[0, S_·sz)`` skewed to shard 0, a quarter -1."""
    rng = np.random.default_rng(seed)
    dest = np.where(rng.random(B) < 0.5, rng.integers(0, sz, B),
                    rng.integers(0, S_ * sz, B))
    return np.where(rng.random(B) < 0.25, -1, dest).astype(np.int32)


REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from repro.graph import chung_lu_powerlaw
from repro.engine import EngineConfig, build_distributed_graph
from repro.engine.gas import _distributed_frogwild, _pack_by_shard
from repro.engine.baseline import build_pull_graph, distributed_power_iteration
mesh = jax.make_mesh(({S},), ("vertex",),
                     axis_types=(jax.sharding.AxisType.Auto,))
g = chung_lu_powerlaw(n=2048, avg_out_deg=10, seed=1)
dg = build_distributed_graph(g, {S})
dgb = build_distributed_graph(g, {S}, vertex_block={VB})
out = {{}}
for name, kw in {configs!r}.items():
    d = dgb if kw.get("step_impl") == "stream" else dg
    r = _distributed_frogwild(d, EngineConfig(num_frogs={N}, num_steps={T},
                                              **kw), mesh, seed=0)
    out[name + ".counts"] = np.asarray(r.counts)
    out[name + ".pi_hat"] = np.asarray(r.pi_hat)
    for f in {STATS!r}:
        out[name + "." + f] = getattr(r, f)
    out[name + ".overflow"] = np.asarray(r.overflow)
out["pi"] = np.asarray(distributed_power_iteration(
    build_pull_graph(g, {S}), mesh, num_iters={ITERS}))
for i, (B, S_, sz, cap) in enumerate({PACK!r}):
    rng = np.random.default_rng(i)
    dest = np.where(rng.random(B) < 0.5, rng.integers(0, sz, B),
                    rng.integers(0, S_ * sz, B))
    dest = np.where(rng.random(B) < 0.25, -1, dest).astype(np.int32)
    buf, sent, ovf = _pack_by_shard(jnp.asarray(dest), S_, sz, cap)
    out[f"pack{{i}}.buf"] = np.asarray(buf)
    out[f"pack{{i}}.sent"] = np.asarray(sent)
    out[f"pack{{i}}.ovf"] = np.asarray(ovf)
for f in {DG_FIELDS!r}:
    out["dg." + f] = np.asarray(getattr(dg, f))
for f in {BLK_FIELDS!r}:
    out["dgb." + f] = np.asarray(getattr(dgb, f))
out["dg.nnz_max"] = np.asarray(dg.nnz_max)
out["dgb.nnz_blk_max"] = np.asarray(dgb.nnz_blk_max)
np.savez({path!r}, **out)
print("REF-OK")
"""


def engine_config(name):
    _, impl, p_s, draw, _ = CONFIGS[name]
    return EngineConfig(num_frogs=N, num_steps=T, p_s=p_s, draw=draw,
                        step_impl=impl)


def run_configs(g, mesh, dg=None, dgb=None):
    """name → the port's EngineResult on ``mesh``."""
    dg = dg if dg is not None else build_distributed_graph(g, S)
    dgb = dgb if dgb is not None else build_distributed_graph(g, S,
                                                              vertex_block=VB)
    return {name: _distributed_frogwild(dgb if CONFIGS[name][4] else dg,
                                        engine_config(name), mesh, seed=0)
            for name in CONFIGS}


def flat_results(results, pi):
    """The results as numpy arrays under the reference's names."""
    out = {"pi": pi.numpy()}
    for name, r in results.items():
        out[name + ".counts"] = r.counts.numpy()
        out[name + ".pi_hat"] = r.pi_hat.numpy()
        for f in STATS:
            out[name + "." + f] = getattr(r, f)
        out[name + ".overflow"] = np.asarray(r.overflow)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch ops on one thread: their tensors are large enough
    for torch to split each op over threads, whose barriers stall without
    end when the test workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def start_reference(path):
    """Starts the reference on 8 forced host devices (``conftest.
    run_with_devices``'s environment) writing its outputs to ``path``, so
    the port's runs overlap it; :func:`reference_outputs` waits."""
    configs = {k: v[0] for k, v in CONFIGS.items()}
    script = REFERENCE.format(S=S, VB=VB, N=N, T=T, ITERS=ITERS,
                              configs=configs, STATS=STATS, PACK=PACK,
                              DG_FIELDS=DG_FIELDS, BLK_FIELDS=BLK_FIELDS,
                              path=str(path))
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={S}")
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), path


def reference_outputs(started):
    """The reference's outputs by name, once its run has ended."""
    proc, path = started
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REF-OK" in out, \
        f"STDOUT:\n{out}\nSTDERR:\n{err}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    started = start_reference(tmp_path_factory.mktemp("engine") / "ref.npz")
    yield started
    if started[0].poll() is None:
        started[0].kill()
        started[0].communicate()


@pytest.fixture(scope="module")
def reference(reference_run, one_process):
    """The reference's outputs, read once the port's configurations ran
    beside it."""
    return reference_outputs(reference_run)


@pytest.fixture(scope="module")
def graph():
    return _graph()


@pytest.fixture(scope="module")
def graphs(graph):
    return (build_distributed_graph(graph, S),
            build_distributed_graph(graph, S, vertex_block=VB))


@pytest.fixture(scope="module")
def one_process(reference_run, graph, graphs):
    mesh = ShardMesh(S, "cpu")
    return flat_results(run_configs(graph, mesh, *graphs),
                 distributed_power_iteration(build_pull_graph(graph, S),
                                             mesh, num_iters=ITERS))


def assert_equal_results(got, want, names=CONFIGS):
    for name in names:
        for f in ("counts", "pi_hat", "overflow") + STATS:
            key = f"{name}.{f}"
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_distributed_graph_equals_the_reference(reference, graphs):
    dg, dgb = graphs
    assert dg.nnz_max == int(reference["dg.nnz_max"])
    assert dgb.nnz_blk_max == int(reference["dgb.nnz_blk_max"])
    for f in DG_FIELDS:
        np.testing.assert_array_equal(getattr(dg, f).numpy(),
                                      reference["dg." + f], err_msg=f)
    for f in BLK_FIELDS:
        np.testing.assert_array_equal(getattr(dgb, f).numpy(),
                                      reference["dgb." + f], err_msg=f)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_equals_the_reference_in_one_process(reference, one_process,
                                                    name):
    assert_equal_results(one_process, reference, [name])


def test_power_iteration_equals_the_reference(reference, one_process, graph):
    got = one_process["pi"]
    assert got.shape == (graph.n,)
    assert (np.abs(got - reference["pi"]) / reference["pi"]).max() <= 1e-5
    pi = power_iteration(graph.to("cpu"), num_iters=ITERS).numpy()
    assert (np.abs(got - pi) / pi).max() <= 1e-5


@pytest.mark.parametrize("case", range(len(PACK)))
def test_pack_by_shard_equals_the_reference_when_it_overflows(reference,
                                                              case):
    B, S_, sz, cap = PACK[case]
    dest = torch.from_numpy(_pack_input(B, S_, sz, case))
    buf, sent, ovf = _pack_by_shard(dest, S_, sz, cap)
    assert int(reference[f"pack{case}.ovf"]) > 0
    np.testing.assert_array_equal(buf.numpy(), reference[f"pack{case}.buf"])
    assert int(sent) == int(reference[f"pack{case}.sent"])
    assert int(ovf) == int(reference[f"pack{case}.ovf"])
    # batched rows pack as each row alone
    rows = torch.stack([dest, dest.flip(0)])
    bb, bs, bo = _pack_by_shard(rows, S_, sz, cap)
    assert torch.equal(bb[0], buf) and int(bs[0]) == int(sent)
    assert torch.equal(bb[1], _pack_by_shard(dest.flip(0), S_, sz, cap)[0])


# --- the reference's claims, on the port ------------------------------------


def test_conservation_accuracy_and_sync_scaling(one_process, graph):
    pi = power_iteration(graph.to("cpu"), num_iters=ITERS)
    for name, floor in (("p1_xla", 0.95), ("p04_rejection", 0.80),
                        ("p04_cumsum", 0.80), ("p1_stream", 0.95)):
        assert int(one_process[name + ".counts"].sum()) == N
        assert int(one_process[name + ".overflow"]) == 0
        m = float(normalized_mass_captured(
            torch.from_numpy(one_process[name + ".pi_hat"]), pi, 20))
        assert m > floor, (name, m)
    ratio = (one_process["p04_rejection.sync_msgs_per_step"].sum()
             / one_process["p1_xla.sync_msgs_per_step"].sum())
    assert 0.25 < ratio < 0.55, ratio


def test_oracle_and_engine_agree_in_distribution():
    g = chung_lu_powerlaw(n=2048, avg_out_deg=10, seed=3)
    Nt, t = 150_000, 8
    oracle = frogwild(g, RuntimeConfig(num_frogs=Nt, num_steps=t).frogwild(),
                      seed=0, device="cpu")
    eng = _distributed_frogwild(build_distributed_graph(g, S),
                                EngineConfig(num_frogs=Nt, num_steps=t),
                                ShardMesh(S, "cpu"), seed=1)
    tv = 0.5 * float((oracle.pi_hat - eng.pi_hat).abs().sum())
    assert tv < 0.08, tv


# --- entry points -----------------------------------------------------------


def test_service_with_a_mesh_runs_the_engine(graph, graphs):
    """``FrogWildService.open(mesh=).pagerank``, ``batch_pagerank`` and the
    deprecated ``distributed_frogwild`` are the engine's run, byte for
    byte (4,000 frogs, 4 supersteps)."""
    small = dict(num_frogs=4_000, num_steps=4)
    rc = RuntimeConfig(**small,
                       runtime=ShardConfig(num_shards=S, vertex_block=VB),
                       kernel=KernelConfig(step_impl="stream"))
    mesh = ShardMesh(S, "cpu")
    svc = FrogWildService.open(graph, rc, mesh=mesh)
    assert svc.device == torch.device("cpu")
    res = svc.pagerank(seed=3)
    want = _distributed_frogwild(graphs[1], rc.engine(), mesh, seed=3)
    assert torch.equal(res.counts, want.counts)
    assert torch.equal(res.pi_hat, want.pi_hat)
    assert svc._dgraph(rc) is svc._dgraph(rc)
    # p_s = 0.4 through the same service (and its cached graph)
    rc4 = RuntimeConfig(**small, p_s=0.4,
                        runtime=ShardConfig(vertex_block=VB),
                        kernel=KernelConfig(draw="cumsum"))
    r4 = svc.pagerank(seed=3, config=rc4)
    assert torch.equal(r4.counts, _distributed_frogwild(
        graphs[1], rc4.engine(), mesh, seed=3).counts)
    assert torch.equal(batch_pagerank(graph, rc4, mesh=mesh, seed=3).counts,
                       r4.counts)
    # the deprecated entry point delegates through batch_pagerank
    cfg = EngineConfig(**small, step_impl="torch")
    with pytest.warns(DeprecationWarning):
        old = distributed_frogwild(graphs[0], cfg, mesh, seed=3)
    assert torch.equal(old.counts, _distributed_frogwild(
        graphs[0], cfg, mesh, seed=3).counts)
    bytes_ = frogwild_bytes_measured(res.sent_per_step,
                                     res.sync_msgs_per_step)
    assert bytes_.total > 0 and len(bytes_.per_step) == 4
    # a service without a mesh keeps the walker estimator
    plain = FrogWildService.open(graph, rc, device="cpu").pagerank(seed=3)
    assert plain.num_frogs == 4_000


def test_engine_refuses_what_the_reference_refuses(graph, graphs):
    dg, _ = graphs
    mesh = ShardMesh(S, "cpu")
    with pytest.raises(ValueError, match="fuses the plain"):
        _distributed_frogwild(dg, EngineConfig(p_s=0.4, step_impl="stream"),
                              mesh)
    with pytest.raises(ValueError, match="fuses the plain"):
        _distributed_frogwild(dg, EngineConfig(p_s=0.4, step_impl="cuda"),
                              mesh)
    with pytest.raises(ValueError, match="blocked slab"):
        _distributed_frogwild(dg, EngineConfig(step_impl="stream"), mesh)
    with pytest.raises(ValueError, match="mesh has 4 shards"):
        _distributed_frogwild(dg, EngineConfig(), ShardMesh(4, "cpu"))
    with pytest.raises(ValueError, match="needs CUDA"):
        _distributed_frogwild(dg, EngineConfig(num_frogs=1000, num_steps=1,
                                               step_impl="cuda"), mesh)
    with pytest.raises(ValueError, match="buffer too small"):
        _distributed_frogwild(dg, EngineConfig(num_frogs=10**6,
                                               capacity_factor=0.01), mesh)
    with pytest.raises(ValueError, match="d_out"):
        from repro_torch.graph.csr import _from_arrays
        build_distributed_graph(_from_arrays(3, np.array([0, 1, 1, 2]),
                                             np.array([1, 0])), 2)
    with pytest.raises(TypeError, match="ShardMesh"):
        FrogWildService.open(graph, RuntimeConfig(), mesh="vertex")
    assert channel_capacity(EngineConfig(num_frogs=N), S) == 6256
    assert not ShardRuntime.acquire(S).is_mesh
    assert ShardRuntime.for_mesh(mesh).is_mesh


def test_blocking_draw_paths_agree_on_their_support(graphs):
    """The rejection and cumsum draws pick kept edges only: every frog's
    destination lies on a channel its coin grid opened (or its forced
    edge when none is)."""
    dg, _ = graphs
    sz = dg.shard_size
    key = prng.PRNGKey(5, "cpu")
    pos = prng.randint(key, (4096,), 0, sz)
    coins = torch.rand(sz, S, generator=torch.Generator().manual_seed(0)) \
        < 0.4
    chan_off = torch.cumsum(dg.chan_cnt[0], -1, dtype=torch.int32) \
        - dg.chan_cnt[0]
    for draw in ("rejection", "cumsum"):
        dest = _blocking_draw(pos, dg.row_ptr[0], dg.col_idx[0], dg.deg[0],
                              dg.edge_src[0], dg.edge_dst_shard[0],
                              dg.chan_cnt[0], chan_off, dg.col_sorted[0],
                              coins, 0.4, key, draw=draw)
        open_any = (coins[pos.long()] & (dg.chan_cnt[0][pos.long()] > 0)
                    ).any(1)
        d_shard = dest.long() // sz
        ok = coins[pos.long(), d_shard] | ~open_any
        assert bool(ok.all()), draw


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p1_pallas", "p1_stream", "p04_rejection",
                                  "p04_cumsum"])
def test_cuda_engine_equals_the_cpu(cuda, graph, graphs, one_process, name):
    from repro_torch.kernels import ops
    dg, dgb = graphs
    ops.reset_launch_counts()
    r = _distributed_frogwild(dgb if CONFIGS[name][4] else dg,
                              engine_config(name), ShardMesh(S, cuda),
                              seed=0)
    got = ops.launch_counts()
    assert_equal_results(flat_results({name: _cpu(r)}, torch.zeros(1)),
                          one_process, [name])
    if name == "p1_pallas":
        assert got["frog_step"] == S * T, got
    if name == "p1_stream":
        assert got["frog_step_stream_sorted"] == S * T, got


def _cpu(r):
    r.counts, r.pi_hat = r.counts.cpu(), r.pi_hat.cpu()
    return r


@pytest.mark.cuda
def test_cuda_one_rank_nccl_group_equals_no_group(cuda, graph, graphs,
                                                  tmp_path):
    import torch.distributed as dist
    dg, _ = graphs
    cfg = engine_config("p1_pallas")
    want = _distributed_frogwild(dg, cfg, ShardMesh(S, cuda), seed=0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rv'}",
                            rank=0, world_size=1)
    try:
        got = _distributed_frogwild(
            dg, cfg, ShardMesh(S, cuda, group=dist.group.WORLD), seed=0)
        assert torch.equal(got.counts, want.counts)
        for f in STATS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        pi = distributed_power_iteration(build_pull_graph(graph, S),
                                         ShardMesh(S, cuda,
                                                   group=dist.group.WORLD),
                                         num_iters=ITERS)
        assert pi.shape == (graph.n,) and bool(torch.isfinite(pi).all())
        gloo = dist.new_group(ranks=[0], backend="gloo")
        with pytest.raises(ValueError, match="gloo process group"):
            ShardMesh(S, cuda, group=gloo)
    finally:
        dist.destroy_process_group()
