"""Dynamic graphs at the port's service, against the reference: epoch
provenance of graphs and checkpoints, and two-epoch serving.

Twins of ``tests/test_dynamic.py``'s checkpoint and service tests, on the
CPU: graph files and epoch'd walk-index checkpoints written by either
package load into the other, byte for byte (endpoints, masks, epoch,
offset); loaders and commits refuse mismatched epochs; a query in flight
across ``apply_mutations`` gives the bytes of a never-mutated run (the
port's and the reference's), and a query admitted after it the
reference's answer at the new epoch. Sizes are tiny (n ≤ 128, R ≤ 6,
L = 3).
"""
import os

import numpy as np
import pytest
import torch

from repro.config import RuntimeConfig as JRuntimeConfig
from repro.config import ServingConfig as JServingConfig
from repro.config import ShardConfig as JShardConfig
from repro.config import WalkIndexConfig as JWalkIndexConfig
from repro.dynamic import MutationBatch as JMutationBatch
from repro.dynamic import apply_mutations as japply
from repro.dynamic import load_epoch_index as jload_epoch
from repro.dynamic import refresh_walk_index as jrefresh
from repro.dynamic import save_epoch_index as jsave_epoch
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.query import index as jindex
from repro.service import FrogWildService as JService
from repro_torch import (FrogWildService, RuntimeConfig, ServingConfig,
                         ShardConfig)
from repro_torch.config import WalkIndexConfig
from repro_torch.dynamic import (MutationBatch, apply_mutations, epoch_dir,
                                 list_epochs, load_epoch_index,
                                 refresh_walk_index, save_epoch_index)
from repro_torch.graph import load_graph, save_graph
from repro_torch.graph import generators as tgen
from repro_torch.query import index as tindex


def _cfg(R=4, L=3, S=2):
    return WalkIndexConfig(segments_per_vertex=R, segment_len=L,
                           num_shards=S)


def _bytes(x):
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.dtype, x.shape, x.tobytes()


# --- epoch provenance: graph files and walk-index checkpoints ----------------


def test_graph_npz_epoch_roundtrip(tmp_path):
    g = tgen.uniform_random(32, 3.0, seed=7)
    g2, _ = apply_mutations(g, MutationBatch.edges(insert=[(0, 5)]))
    p = save_graph(str(tmp_path / "g.npz"), g2)
    for loaded in (load_graph(p), jcsr.load_graph(p)):
        assert loaded.epoch == 1 and loaded.mutation_offset == 1
        assert _bytes(loaded.col_idx) == _bytes(g2.col_idx)
    # a file without epochs loads at the never-mutated provenance
    np.savez_compressed(str(tmp_path / "legacy.npz"), n=np.int64(g.n),
                        row_ptr=g.row_ptr.numpy(), col_idx=g.col_idx.numpy())
    legacy = load_graph(str(tmp_path / "legacy.npz"))
    assert legacy.epoch == 0 and legacy.mutation_offset == 0


def _epoch_pair():
    """Epochs 0 and 1 of one index in each package."""
    gj = jgen.uniform_random(64, 4.0, seed=8)
    gt = tgen.uniform_random(64, 4.0, seed=8)
    ij = jindex._build_walk_index(gj, JWalkIndexConfig(
        segments_per_vertex=4, segment_len=3, num_shards=2))
    it = tindex._build_walk_index(gt, _cfg())
    gj2, cj = japply(gj, JMutationBatch.edges(insert=[(3, 4)]))
    gt2, ct = apply_mutations(gt, MutationBatch.edges(insert=[(3, 4)]))
    return {"ref": (ij, jrefresh(ij, gj2, cj)[0]),
            "port": (it, refresh_walk_index(it, gt2, ct)[0])}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_epoch_checkpoint_roundtrip_and_loud_mismatch(tmp_path, writer):
    """Epoch'd checkpoints, dense and sharded, written by either package
    load into both, equal to what was saved; a directory whose manifest
    claims another epoch is refused."""
    idx = _epoch_pair()
    save, shard = ((jsave_epoch, jindex.shard_walk_index) if writer == "ref"
                   else (save_epoch_index, tindex.shard_walk_index))
    d = str(tmp_path / "ckpt")
    for index in idx[writer]:
        save(d, index)
    assert list_epochs(d) == [0, 1]
    for epoch in (0, 1):
        want = idx["ref"][epoch]
        for got in (load_epoch_index(d, epoch, device="cpu"),
                    jload_epoch(d, epoch)):
            assert got.graph_epoch == epoch
            assert _bytes(got.endpoints) == _bytes(want.endpoints)
            assert _bytes(got.visited_blocks) == _bytes(want.visited_blocks)
            assert got.mutation_offset == want.mutation_offset
    # the sharded layout round-trips too
    d2 = str(tmp_path / "ckpt_sharded")
    sh = shard(idx[writer][1], 2)
    save(d2, sh)
    for got in (load_epoch_index(d2, 1, reassemble=False, device="cpu"),
                jload_epoch(d2, 1, reassemble=False)):
        assert got.num_shards == 2 and got.graph_epoch == 1
        assert _bytes(got.blocks) == _bytes(sh.blocks)
        assert _bytes(got.visited_blocks) == _bytes(sh.visited_blocks)
    with pytest.raises(FileNotFoundError):
        load_epoch_index(d, 5, device="cpu")
    os.rename(epoch_dir(d, 1), epoch_dir(d, 3))
    with pytest.raises(ValueError, match="claims graph_epoch"):
        load_epoch_index(d, 3, device="cpu")


def test_load_or_repair_refuses_stale_epoch(tmp_path):
    g = tgen.uniform_random(64, 4.0, seed=9)
    cfg = _cfg(S=2)
    d = str(tmp_path / "shards")
    save_epoch_index(d, tindex.shard_walk_index(
        tindex._build_walk_index(g, cfg), 2))
    g2, _ = apply_mutations(g, MutationBatch.edges(insert=[(0, 1)]))
    with pytest.raises(ValueError, match="graph epoch"):
        tindex.load_or_repair_walk_index(epoch_dir(d, 0), g2, cfg)


def test_service_refuses_stale_checkpoint(tmp_path):
    g = tgen.uniform_random(64, 4.0, seed=10)
    d = str(tmp_path / "ckpt")
    tindex.save_walk_index(d, tindex._build_walk_index(g, _cfg(S=1)))
    g2, _ = apply_mutations(g, MutationBatch.edges(insert=[(0, 1)]))
    rc = RuntimeConfig(
        runtime=ShardConfig(num_shards=1),
        serving=ServingConfig(segments_per_vertex=4, segment_len=3,
                              build_shards=1, checkpoint_dir=d))
    svc = FrogWildService.open(g2, rc, device="cpu")
    with pytest.raises(ValueError, match="stale slab|graph epoch"):
        svc.ensure_index()


# --- two-epoch serving -------------------------------------------------------


def _serving(S, **serving_kw):
    kw = dict(segments_per_vertex=6, segment_len=3, build_shards=S,
              max_walks=256, max_queries=2, max_steps=32, **serving_kw)
    return (JRuntimeConfig(runtime=JShardConfig(num_shards=S),
                           serving=JServingConfig(**kw)),
            RuntimeConfig(runtime=ShardConfig(num_shards=S),
                          serving=ServingConfig(**kw)))


def _service(g, S=2, **serving_kw):
    return FrogWildService.open(g, _serving(S, **serving_kw)[1],
                                device="cpu")


def _answer(r):
    return (r.vertices.tobytes(), r.scores.tobytes(), r.num_walks,
            r.epoch)


def _pinned_run(svc, batch):
    """One query in flight across ``apply_mutations``, one after it."""
    h1 = svc.topk(k=8, epsilon=0.5, delta=0.2, num_walks=4 * 256,
                  early_stop=False)
    h1.poll()                         # in flight (spans several waves)
    assert h1.status() in ("active", "queued")
    report = svc.apply_mutations(batch)
    h2 = svc.topk(k=8, epsilon=0.5, delta=0.2)
    return h1, h2, report


def test_epoch_pinning_under_concurrency():
    """A query in flight across an epoch commit finishes byte-identically
    to a run in which no mutation happened, while new admissions land on
    the new epoch; both equal the reference's answers."""
    g = tgen.uniform_random(128, 4.0, seed=11)
    gj = jgen.uniform_random(128, 4.0, seed=11)
    edges = [(2, 100), (70, 3)]

    ctrl = _service(g)                # never mutated
    rc_ = ctrl.topk(k=8, epsilon=0.5, delta=0.2, num_walks=4 * 256,
                    early_stop=False).result()

    svc = _service(g)
    h1, h2, report = _pinned_run(svc, MutationBatch.edges(insert=edges))
    assert report.epoch == 1
    assert svc.graph_epoch == 1
    assert svc.retiring_epochs == [0]
    r1, r2 = h1.result(), h2.result()
    assert r1.epoch == 0 and r2.epoch == 1
    assert _answer(r1) == _answer(rc_)
    # the retired epoch is released once its last pinned query settled
    svc.step()
    assert svc.retiring_epochs == []
    assert svc.serving_stats().epoch == 1

    ref = JService.open(gj, _serving(2)[0])
    j1, j2, jreport = _pinned_run(ref, JMutationBatch.edges(insert=edges))
    assert _answer(j1.result()) == _answer(r1)
    assert _answer(j2.result()) == _answer(r2)
    assert jreport.segments_rebuilt == report.segments_rebuilt
    svc.close()
    ctrl.close()


def test_drain_settles_the_retiring_epochs():
    g = tgen.uniform_random(96, 4.0, seed=14)
    svc = _service(g, S=1)
    h1, h2, _ = _pinned_run(svc, MutationBatch.edges(insert=[(5, 6)]))
    done = svc.drain()
    assert h1.done() and h2.done() and svc.retiring_epochs == []
    assert [r.rid for r in done] == [h2.rid]       # the current epoch's
    assert h1.result().epoch == 0
    svc.close()
    assert h1.status() == "cancelled"


def test_service_apply_mutations_persists_epoch(tmp_path):
    g = tgen.uniform_random(96, 4.0, seed=12)
    d = str(tmp_path / "ckpt")
    svc = _service(g, checkpoint_dir=d)
    svc.ensure_index()
    report = svc.apply_mutations(MutationBatch.edges(insert=[(1, 2)]))
    assert report.epoch == 1
    assert list_epochs(d) == [1]
    got = load_epoch_index(d, 1, reassemble=False, device="cpu")
    idx = svc.ensure_index()
    assert torch.equal(got.blocks, idx.blocks)
    assert torch.equal(got.visited_blocks.view(torch.int32),
                       idx.visited_blocks.view(torch.int32))
    svc.close()


def test_commit_epoch_refuses_mismatches():
    g = tgen.uniform_random(64, 4.0, seed=13)
    svc = _service(g)
    idx = svc.ensure_index()
    g2, _ = apply_mutations(g, MutationBatch.edges(insert=[(0, 1)]))
    with pytest.raises(ValueError, match="does not match graph epoch"):
        svc.commit_epoch(g2, idx)     # a stale slab at epoch 0
    small = tgen.uniform_random(32, 3.0, seed=13)
    with pytest.raises(ValueError, match="vertex count"):
        svc.commit_epoch(small, idx)
    other = tindex._build_walk_index(g2, _cfg(R=3))
    with pytest.raises(ValueError, match="geometry"):
        svc.commit_epoch(g2, other)
    svc.close()
