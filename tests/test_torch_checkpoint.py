"""The port's checkpoints against the reference's.

The protocol (``repro_torch.checkpoint``): the same ``tree.json`` and the
same ``arrays.npz`` bytes as the reference for the same tree (leaves in
JAX's flatten order, raw bytes, bfloat16 and scalar leaves included), a
``.tmp`` never visible, a step replaced atomically, the background writer
keeping its newest steps. The walk index across packages, dense and per
shard: an index the reference wrote loads into the port (its
``visited_blocks`` masks carried through) and the port's service serves
the reference's answers byte for byte from it; an index the port wrote
loads into the reference with equal leaves, its masks included. A repair
of a checkpoint that has masks serves the reference's masks, the
repaired shard's from its re-walk.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.config import RuntimeConfig as JRuntimeConfig
from repro.config import ServingConfig as JServingConfig
from repro.config import ShardConfig as JShardConfig
from repro.config import WalkIndexConfig as JWalkIndexConfig
from repro.distributed import runtime as jruntime
from repro.graph import generators as jgen
from repro.query import index as jindex
from repro.service import FrogWildService as JService
from repro_torch import FrogWildService, RuntimeConfig, ServingConfig
from repro_torch import ShardConfig
from repro_torch.checkpoint import (CheckpointCorruptError, Checkpointer,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.config import WalkIndexConfig
from repro_torch.distributed import runtime as truntime
from repro_torch.graph import generators as tgen
from repro_torch.query import index as tindex

N, R, L, S = 200, 4, 2, 4


def _tree(bf16):
    """A nested tree whose sorted flatten order differs from its insertion
    order, with scalar, uint32, bfloat16, tuple and ``None`` nodes."""
    return {"z": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"y": np.float32(2.5), "x": [np.arange(3, dtype=np.uint32),
                                              None, (np.int32(7),)]},
            "b/": bf16}


def _files(step_dir):
    with open(os.path.join(step_dir, "tree.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(step_dir, "arrays.npz")) as z:
        return meta, {k: (z[k].shape, z[k].tobytes()) for k in z.files}


def test_checkpoint_files_equal_the_reference(tmp_path):
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3,
                          _tree(jnp.ones((2, 2), jnp.bfloat16) * 1.5))
    save_checkpoint(str(tmp_path / "port"), 3,
                    _tree(torch.ones(2, 2, dtype=torch.bfloat16) * 1.5))
    want = _files(str(tmp_path / "ref" / "step_00000003"))
    got = _files(str(tmp_path / "port" / "step_00000003"))
    assert got == want
    assert got[0]["paths"] == ["b/x/0", "b/x/2/0", "b/y", "b/", "z"]
    assert got[0]["dtypes"][3] == "bfloat16" and got[0]["shapes"][2] == []


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_leaves_restore_across_packages(tmp_path, writer):
    d = str(tmp_path / "ckpt")
    if writer == "ref":
        jckpt.save_checkpoint(d, 0, _tree(jnp.full((2, 2), -3.25,
                                                   jnp.bfloat16)))
    else:
        save_checkpoint(d, 0, _tree(torch.full((2, 2), -3.25,
                                               dtype=torch.bfloat16)))
    got = restore_checkpoint(d, 0, _tree(0), device="cpu")
    want = jckpt.restore_checkpoint(d, 0, _tree(0))
    assert got["b"]["x"][1] is None and isinstance(got["b"]["x"][2], tuple)
    pairs = [(got["z"], want["z"]), (got["b"]["y"], want["b"]["y"]),
             (got["b"]["x"][0], want["b"]["x"][0]),
             (got["b"]["x"][2][0], want["b"]["x"][2][0])]
    for g, w in pairs:
        w = np.asarray(w)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert tuple(g.shape) == w.shape
        assert g.numpy().tobytes() == w.tobytes()
    assert got["b/"].dtype == torch.bfloat16
    assert got["b/"].float().tolist() == [[-3.25, -3.25], [-3.25, -3.25]]


def test_steps_replace_atomically_and_refuse_what_is_broken(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"a": torch.arange(4)})
    save_checkpoint(d, 1, {"a": torch.arange(4) * 2})      # replaces step 1
    os.makedirs(os.path.join(d, "step_00000009.old"))
    os.makedirs(os.path.join(d, "step_00000008.tmp"))
    assert latest_step(d) == 1
    assert sorted(os.listdir(d))[0] == "step_00000001"
    out = restore_checkpoint(d, 1, {"a": 0}, device="cpu")
    assert out["a"].tolist() == [0, 2, 4, 6]
    with pytest.raises(ValueError, match="tree structure mismatch"):
        restore_checkpoint(d, 1, {"a": 0, "b": 0}, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, 2, {"a": 0}, device="cpu")
    os.remove(os.path.join(d, "step_00000001", "tree.json"))
    with pytest.raises(CheckpointCorruptError, match="no tree.json"):
        restore_checkpoint(d, 1, {"a": 0}, device="cpu")
    assert latest_step(str(tmp_path / "none")) is None


def test_async_checkpointer_keeps_newest_steps(tmp_path):
    d = str(tmp_path / "ckpt")
    ck = Checkpointer(d, keep=2)
    x = torch.zeros(3)
    for step in range(4):
        x += 1
        ck.save_async(step, {"x": x})      # snapshot now, write later
    ck.wait()
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    for step in (2, 3):
        out = restore_checkpoint(d, step, {"x": 0}, device="cpu")
        assert out["x"].tolist() == [step + 1.0] * 3


# --- the walk index across packages ------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    return (jgen.chung_lu_powerlaw(N, 6.0, seed=4),
            tgen.chung_lu_powerlaw(N, 6.0, seed=4))


def _configs(d, num_shards):
    serving = dict(segments_per_vertex=R, segment_len=L, build_shards=S,
                   max_walks=256, max_queries=4, max_steps=10,
                   checkpoint_dir=d)
    return (JRuntimeConfig(runtime=JShardConfig(num_shards=num_shards,
                                                seed=5),
                           serving=JServingConfig(**serving)),
            RuntimeConfig(runtime=ShardConfig(num_shards=num_shards, seed=5),
                          serving=ServingConfig(**serving)))


def _answers(svc):
    hs = [svc.topk(k=6, num_walks=600), svc.ppr(3, k=4, num_walks=400)]
    return [(h.result().vertices.tobytes(), h.result().scores.tobytes(),
             h.result().num_walks) for h in hs]


def _reference_shards(graphs, d):
    """The reference's build, its masks, written one dir a shard."""
    gj = graphs[0]
    idx = jindex._build_walk_index(gj, JWalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=S, seed=5))
    sh = jindex.shard_walk_index(idx, S)
    for s in range(S):
        jindex.save_walk_index_shard(
            d, s, S, gj.n, sh.blocks[s], L, 5,
            visited_blocks=sh.visited_blocks[s])
    return sh


@pytest.mark.parametrize("num_shards", [1, S])
def test_dense_index_the_reference_wrote_serves_its_answers(
        graphs, tmp_path, num_shards):
    d = str(tmp_path / "index")
    jrc, trc = _configs(d, num_shards)
    ref = JService.open(graphs[0], jrc)
    want_index = ref.ensure_index()                 # built and persisted
    want = _answers(ref)
    port = FrogWildService.open(graphs[1], trc, device="cpu")
    got_index = port.ensure_index()                 # loaded
    if num_shards == 1:
        assert got_index.endpoints.numpy().tobytes() == np.asarray(
            want_index.endpoints).tobytes()
        assert got_index.visited_blocks.dtype == torch.uint32
        assert got_index.visited_blocks.numpy().tobytes() == \
            want_index.visited_blocks.tobytes()
    else:
        assert got_index.blocks.numpy().tobytes() == np.asarray(
            want_index.blocks).tobytes()
        assert got_index.visited_blocks.numpy().tobytes() == np.asarray(
            want_index.visited_blocks).tobytes()
    assert _answers(port) == want


def test_shard_index_the_reference_wrote_serves_its_answers(graphs,
                                                            tmp_path):
    d = str(tmp_path / "index")
    sh = _reference_shards(graphs, d)
    jrc, trc = _configs(d, S)
    want = _answers(JService.open(graphs[0], jrc))
    port = FrogWildService.open(graphs[1], trc, device="cpu")
    idx = port.ensure_index()
    assert isinstance(idx, tindex.ShardedWalkIndex)
    assert idx.blocks.numpy().tobytes() == np.asarray(sh.blocks).tobytes()
    assert idx.visited_blocks.numpy().tobytes() == \
        sh.visited_blocks.tobytes()
    assert _answers(port) == want


def _same_trees(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), b[k].numpy()
        assert (x.dtype, x.shape, x.tobytes()) == (y.dtype, y.shape,
                                                   y.tobytes()), k


def test_index_the_port_wrote_loads_into_the_reference(graphs, tmp_path):
    # dense: the port's service builds and persists
    d = str(tmp_path / "dense")
    port = FrogWildService.open(graphs[1], _configs(d, 1)[1], device="cpu")
    built = port.ensure_index()
    _same_trees(jruntime.load_checkpoint_tree(d),
                truntime.load_checkpoint_tree(d, device="cpu"))
    back = jindex.load_walk_index(d)
    assert np.asarray(back.endpoints).tobytes() == \
        built.endpoints.numpy().tobytes()
    assert back.visited_blocks.tobytes() == \
        built.visited_blocks.numpy().tobytes() and back.seed == 5
    # per shard: the reference's blocks and masks, loaded and written
    # again by the port
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    _reference_shards(graphs, src)
    sh = tindex.load_walk_index(src, reassemble=False, device="cpu")
    for s in range(S):
        tindex.save_walk_index_shard(dst, s, S, sh.n, sh.blocks[s], L,
                                     sh.seed,
                                     visited_blocks=sh.visited_blocks[s])
    for s in range(S):
        _same_trees(jruntime.load_checkpoint_tree(
            truntime.shard_dir(src, s)), truntime.load_checkpoint_tree(
            truntime.shard_dir(dst, s), device="cpu"))


def test_repair_of_a_masked_index_serves_no_masks(graphs, tmp_path):
    d = str(tmp_path / "index")
    sh = _reference_shards(graphs, d)
    payload = os.path.join(truntime.shard_dir(d, 1), "step_00000000",
                           "arrays.npz")
    with open(payload, "r+b") as f:
        f.truncate(os.path.getsize(payload) // 2)
    cfg = WalkIndexConfig(segments_per_vertex=R, segment_len=L,
                          num_shards=S, seed=5)
    fixed = tindex.load_or_repair_walk_index(d, graphs[1], cfg,
                                             reassemble=False)
    want = sh.visited_blocks.tobytes()
    assert fixed.visited_blocks.numpy().tobytes() == want
    assert fixed.blocks.numpy().tobytes() == np.asarray(sh.blocks).tobytes()
    # the repaired shard's masks are on disk beside the healthy shards';
    # every reader of the repaired layout serves them all
    for s in (0, 1):
        assert "visited_blocks" in truntime.load_checkpoint_tree(
            truntime.shard_dir(d, s), device="cpu")
    assert tindex.load_walk_index(
        d, reassemble=False, device="cpu").visited_blocks.numpy().tobytes() \
        == want
    assert np.asarray(jindex.load_walk_index(
        d, reassemble=False).visited_blocks).tobytes() == want


def test_service_checks_what_it_loads(graphs, tmp_path):
    d = str(tmp_path / "index")
    gt = graphs[1]
    FrogWildService.open(gt, _configs(d, 1)[1], device="cpu").ensure_index()
    # another (R, L) under the same directory
    other = dataclasses.replace(_configs(d, 1)[1], serving=ServingConfig(
        segments_per_vertex=R + 1, segment_len=L, checkpoint_dir=d))
    with pytest.raises(ValueError, match=r"\(R, L\)"):
        FrogWildService.open(gt, other, device="cpu").ensure_index()
    # a graph at another epoch
    later = dataclasses.replace(gt, epoch=1)
    with pytest.raises(ValueError, match="epoch"):
        FrogWildService.open(later, _configs(d, 1)[1],
                             device="cpu").ensure_index()
    # a corrupt dense checkpoint is rebuilt and replaced
    payload = os.path.join(d, "step_00000000", "arrays.npz")
    want = open(payload, "rb").read()
    with open(payload, "r+b") as f:
        f.truncate(len(want) // 2)
    with pytest.raises(CheckpointCorruptError):
        tindex.load_walk_index(d, device="cpu")
    FrogWildService.open(gt, _configs(d, 1)[1], device="cpu").ensure_index()
    assert open(payload, "rb").read() == want
