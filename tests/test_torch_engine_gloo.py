"""The port's distributed engine over 2 gloo ranks of 4 shards each,
against the reference's, on the CPU.

One ``torch.multiprocessing`` spawn for the module (its rendezvous a file
under the test's temporary directory, so no port is opened) runs the
engine's five configurations of ``tests/test_torch_engine.py`` and the
GraphLab-PR baseline on a ``ShardMesh(8, "cpu", group=...)``: each rank's
counts and per-step statistics byte-equal to the reference's on 8 forced
host devices, the baseline within 1e-5. The collectives (``all_to_all``,
``all_gather``, ``psum``) and the partial sync (a channel mask,
``partial_psum``) on each rank's 4 shards equal one process's on all 8,
and a group of one rank (every shard on it, the exchange through gloo)
equals no group.
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import partial_channel_mask, partial_psum
from repro_torch.distributed.runtime import ShardMesh
from repro_torch.engine import (build_distributed_graph,
                                distributed_power_iteration)
from repro_torch.engine.baseline import build_pull_graph
from repro_torch.engine.gas import _distributed_frogwild
from test_torch_engine import (ITERS, S, _graph, assert_equal_results,
                               engine_config, flat_results, reference_outputs,
                               run_configs, start_reference)

WORLD = 2
COLLECTIVES = ("a2a", "gather", "psum", "mask", "ppsum")


def _gloo_worker(rank, world, init_file, out_path):
    """One of the gloo ranks, ``S / world`` of the shards each."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = ShardMesh(S, "cpu", group=dist.group.WORLD)
        Sl = S // world
        assert (mesh.shards_per_rank, mesh.first_shard) == (Sl, Sl * rank)
        with pytest.raises(ValueError, match="do not split"):
            ShardMesh(3, "cpu", group=dist.group.WORLD)
        g = _graph()
        out = flat_results(run_configs(g, mesh), distributed_power_iteration(
            build_pull_graph(g, S), mesh, num_iters=ITERS))
        # the collectives on this rank's rows of an [S, ...] stack
        one = ShardMesh(S, "cpu")
        mine = slice(Sl * rank, Sl * (rank + 1))
        x = torch.arange(S * S * 3, dtype=torch.float32).view(S, S, 3)
        key = prng.PRNGKey(7, "cpu")
        for name, fn in (("a2a", lambda m, a: m.all_to_all(a)),
                         ("gather", lambda m, a: m.all_gather(a)),
                         ("psum", lambda m, a: m.psum(a)),
                         ("mask", lambda m, a: partial_channel_mask(
                             key, 0.3, m, S)),
                         ("ppsum", lambda m, a: partial_psum(a, m, 0.5,
                                                             key))):
            out[name] = fn(mesh, x[mine].contiguous()).numpy()
            out[name + "_one"] = fn(one, x)[mine].numpy()
        # a group of one rank runs the exchange through gloo, all S
        # shards on this rank: the same as no group
        solo = ShardMesh(S, "cpu", group=[dist.new_group(ranks=[r])
                                          for r in range(world)][rank])
        r1 = _distributed_frogwild(build_distributed_graph(g, S),
                                   engine_config("p1_xla"), solo, seed=0)
        out["solo.counts"] = r1.counts.numpy()
        out["solo.sync"] = r1.sync_msgs_per_step
        out["solo.a2a"] = solo.all_to_all(x).numpy()
        out["solo.a2a_one"] = one.all_to_all(x).numpy()
        np.savez(f"{out_path}.{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, each rank's outputs from ``WORLD``
    spawned gloo processes), the two run side by side."""
    d = tmp_path_factory.mktemp("gloo")
    started = start_reference(d / "ref.npz")
    try:
        torch.multiprocessing.spawn(
            _gloo_worker, args=(WORLD, str(d / "rendezvous"),
                                str(d / "out")),
            nprocs=WORLD, join=True)
        ref = reference_outputs(started)
    finally:
        if started[0].poll() is None:
            started[0].kill()
            started[0].communicate()
    outs = []
    for r in range(WORLD):
        with np.load(d / f"out.{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return ref, outs


@pytest.fixture(scope="module")
def reference(runs):
    return runs[0]


@pytest.fixture(scope="module")
def gloo(runs):
    return runs[1]


@pytest.mark.parametrize("rank", range(WORLD))
def test_engine_equals_the_reference_over_two_gloo_ranks(reference, gloo,
                                                         rank):
    assert_equal_results(gloo[rank], reference)
    rel = np.abs(gloo[rank]["pi"] - reference["pi"]) / reference["pi"]
    assert rel.max() <= 1e-5


@pytest.mark.parametrize("what", COLLECTIVES)
def test_collectives_over_gloo_equal_one_process(gloo, what):
    for out in gloo:
        np.testing.assert_array_equal(out[what], out[what + "_one"])


def test_one_rank_gloo_group_equals_no_group(reference, gloo):
    for out in gloo:
        np.testing.assert_array_equal(out["solo.counts"],
                                      reference["p1_xla.counts"])
        np.testing.assert_array_equal(out["solo.sync"],
                                      reference["p1_xla.sync_msgs_per_step"])
        np.testing.assert_array_equal(out["solo.a2a"], out["solo.a2a_one"])
