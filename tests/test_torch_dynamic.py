"""Dynamic graphs in the port against the reference: mutations, the
build's visited-block masks, invalidation and incremental refresh.

Twins of ``tests/test_dynamic.py``'s mutation, invalidation and refresh
tests. The same graph (each package's generator, same seed) and the same
numpy-drawn mutation batch go through ``repro.dynamic`` and
``repro_torch.dynamic`` on the CPU, and every output is byte-equal: the
mutated CSR (``row_ptr``, ``col_idx``, ``out_deg``, ``epoch``,
``mutation_offset``) and ``changed``; the build's masks, dense and
sharded, and a repaired shard's (padded rows included); the stale set;
the refreshed slab, its masks and its ``RefreshReport``, which also equal
the port's own full rebuild, under the port's ``step_impl="torch"`` and
``"stream"`` against the reference's default ``"xla"``. Sizes are tiny
(n ≤ 1001, R ≤ 5, L ≤ 3).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.config import WalkIndexConfig as JWalkIndexConfig
from repro.dynamic import MutationBatch as JMutationBatch
from repro.dynamic import MutationLog as JMutationLog
from repro.dynamic import apply_mutations as japply
from repro.dynamic import invalidate_segments as jinvalidate
from repro.dynamic import refresh_walk_index as jrefresh
from repro.graph import generators as jgen
from repro.query import index as jindex
from repro_torch.config import WalkIndexConfig
from repro_torch.dynamic import (MutationBatch, MutationLog, RefreshReport,
                                 apply_mutations, dirty_block_mask,
                                 invalidate_segments, refresh_walk_index)
from repro_torch.graph import CSRGraph
from repro_torch.graph import generators as tgen
from repro_torch.query import index as tindex


def _cfgs(R=4, L=3, S=2, seed=0, step_impl="torch"):
    kw = dict(segments_per_vertex=R, segment_len=L, num_shards=S, seed=seed)
    return JWalkIndexConfig(**kw), WalkIndexConfig(step_impl=step_impl, **kw)


def _graphs(gen, n, deg, seed):
    return (getattr(jgen, gen)(n, deg, seed=seed),
            getattr(tgen, gen)(n, deg, seed=seed))


def _eq(want, got):
    """Byte equality of a reference array and a port tensor or array."""
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


def _same_graph(gj, gt):
    _eq(gj.row_ptr, gt.row_ptr)
    _eq(gj.col_idx, gt.col_idx)
    _eq(gj.out_deg, gt.out_deg)
    assert (gj.n, gj.epoch, gj.mutation_offset) == (gt.n, gt.epoch,
                                                    gt.mutation_offset)


def _batches(insert=(), delete=()):
    return (JMutationBatch.edges(insert=insert, delete=delete),
            MutationBatch.edges(insert=insert, delete=delete))


# --- mutation application ----------------------------------------------------


def test_apply_mutations_semantics():
    gj, gt = _graphs("uniform_random", 64, 4.0, 1)
    v = 5
    succ = list(gt.successors(v))
    assert succ == list(gj.successors(v))
    assert gt.edge_range(v) == gj.edge_range(v)
    bj, bt = _batches(insert=[(7, 30), (v, 11)], delete=[(v, succ[0])])
    gj2, cj = japply(gj, bj)
    gt2, ct = apply_mutations(gt, bt)
    _same_graph(gj2, gt2)
    _eq(cj, ct)
    assert gt2.epoch == gt.epoch + 1 and gt2.device == gt.device
    assert gt2.mutation_offset == gt.mutation_offset + 3
    assert set(ct) == {5, 7}
    # a delete removes the FIRST occurrence; an insert appends at the end
    assert list(gt2.successors(v)) == succ[1:] + [11]
    assert list(gt2.successors(7)) == list(gt.successors(7)) + [30]
    for u in range(gt.n):
        if u not in (5, 7):
            assert np.array_equal(gt.successors(u), gt2.successors(u))
    # the original graph is untouched (epochs are immutable)
    assert list(gt.successors(v)) == succ and gt.epoch == 0


def test_apply_mutations_loud_errors_and_dangling():
    gj, gt = _graphs("uniform_random", 32, 3.0, 2)
    absent = next(d for d in range(gt.n)
                  if d not in set(int(x) for x in gt.successors(0)))
    for apply, batch in ((japply, JMutationBatch), (apply_mutations,
                                                    MutationBatch)):
        g = gj if apply is japply else gt
        with pytest.raises(ValueError, match="absent edge"):
            apply(g, batch.edges(delete=[(0, absent)]))
        with pytest.raises(ValueError, match="outside"):
            apply(g, batch.edges(insert=[(0, g.n)]))
    # deleting every out-edge triggers the build_csr dangling repair
    v = 3
    bj, bt = _batches(delete=[(v, int(d)) for d in gt.successors(v)])
    gj2, cj = japply(gj, bj)
    gt2, ct = apply_mutations(gt, bt)
    _same_graph(gj2, gt2)
    _eq(cj, ct)
    assert v in ct
    t = (v * 2654435761 + 12345) % gt.n
    if t == v:
        t = (t + 1) % gt.n
    assert list(gt2.successors(v)) == [t]
    assert int(gt2.out_deg.min()) > 0
    with pytest.raises(ValueError, match="dangling policy"):
        apply_mutations(gt, bt, dangling="drop")


def test_mutation_log_replay():
    gj, gt = _graphs("uniform_random", 48, 4.0, 3)
    logs = []
    for log_cls, batch in ((JMutationLog, JMutationBatch),
                           (MutationLog, MutationBatch)):
        log = log_cls()
        assert log.append(batch.edges(insert=[(1, 2)])) == 1
        assert log.append(batch.edges(insert=[(9, 9)],
                                      delete=[(1, 2)])) == 2
        assert log.offset == 3
        logs.append(log)
    gj2, cj = logs[0].replay(gj)
    gt2, ct = logs[1].replay(gt)
    _same_graph(gj2, gt2)
    _eq(cj, ct)
    assert gt2.epoch == 2 and gt2.mutation_offset == 3
    assert {1, 9} <= set(ct)
    # resume mid-log: a graph already at epoch 1 replays only batch 2
    gt1, _ = apply_mutations(gt, logs[1].batches[0])
    gt2b, _ = logs[1].replay(gt1)
    assert torch.equal(gt2b.col_idx, gt2.col_idx)
    with pytest.raises(ValueError, match="outside log range"):
        logs[1].replay(CSRGraph(n=gt.n, row_ptr=gt.row_ptr,
                                col_idx=gt.col_idx, out_deg=gt.out_deg,
                                epoch=7))


# --- the build's masks -------------------------------------------------------


@pytest.mark.parametrize("n,R,L,S,seed,step_impl", [
    (500, 5, 3, 4, 0, "torch"), (300, 4, 1, 3, 1, "torch"),
    (333, 4, 2, 3, 7, "stream")])
def test_build_masks_equal_reference(n, R, L, S, seed, step_impl):
    """Every build records the reference's ``visited_blocks``: dense,
    and range-partitioned into serving blocks (rows past ``n`` zero)."""
    gj, gt = _graphs("chung_lu_powerlaw", n, 6.0, seed)
    cj, ct = _cfgs(R, L, S, seed, step_impl)
    ij, it = jindex._build_walk_index(gj, cj), tindex._build_walk_index(gt,
                                                                       ct)
    _eq(ij.endpoints, it.endpoints)
    assert it.visited_blocks.dtype == torch.uint32
    _eq(ij.visited_blocks, it.visited_blocks)
    assert tindex._MASK_WORDS == jindex._MASK_WORDS
    assert tindex.segment_mask_block_size(n) == \
        jindex.segment_mask_block_size(n)
    if L == 1:                    # a one-hop segment has no intermediate
        assert not bool(it.visited_blocks.view(torch.int32).any())
    sj, st = jindex.shard_walk_index(ij, S), tindex.shard_walk_index(it, S)
    _eq(sj.visited_blocks, st.visited_blocks)
    _eq(sj.reassemble().visited_blocks, st.reassemble().visited_blocks)


def test_rebuilt_shards_carry_the_reference_masks_and_padded_rows():
    """``rebuild_shard_blocks`` returns the reference's ``(endpoints,
    visited)`` pairs, its padded rows included. Those rows (ids ≥ n)
    differ from the zero rows of ``shard_walk_index`` in both packages
    (ROADMAP.md Queue 3 item 6): the rebuild walks the padded graph, whose
    padding vertices stay put and set their block's bit; no walk reads
    them."""
    n, S = 1001, 4
    gj, gt = _graphs("chung_lu_powerlaw", n, 6.0, 0)
    cj, ct = _cfgs(R=4, L=3, S=S)
    rj = jindex.rebuild_shard_blocks(gj, cj, list(range(S)))
    rt = tindex.rebuild_shard_blocks(gt, ct, list(range(S)))
    for s in range(S):
        _eq(rj[s][0], rt[s][0])
        _eq(rj[s][1], rt[s][1])
    sz = -(-n // S)
    pad = slice(n - (S - 1) * sz, sz)              # shard 3's rows ≥ n
    assert rt[3][0][pad].tolist() == [[v] * 4 for v in range(n, S * sz)]
    assert (rt[3][1][pad].view(torch.int32) != 0).sum(-1).tolist() == \
        [[1] * 4] * 3
    for shard in (jindex.shard_walk_index(jindex._build_walk_index(gj, cj),
                                          S),
                  tindex.shard_walk_index(tindex._build_walk_index(gt, ct),
                                          S)):
        blocks, vb = np.asarray(shard.blocks), np.asarray(
            shard.visited_blocks)
        assert not blocks[3][pad].any() and not vb[3][pad].any()
        # the real rows agree
        _eq(blocks[3][:pad.start], rt[3][0][:pad.start])
        _eq(vb[3][:pad.start], rt[3][1][:pad.start])


# --- invalidation and refresh ------------------------------------------------


def _random_batch(g, rng):
    """A few numpy-drawn inserts and deletes of existing edges."""
    k = int(rng.integers(1, 4))
    ins = [(int(rng.integers(g.n)), int(rng.integers(g.n)))
           for _ in range(k)]
    dels = []
    for _ in range(k):
        v = int(rng.integers(g.n))
        succ = g.successors(v)
        dels.append((v, int(succ[rng.integers(len(succ))])))
    # a delete can name an edge twice; keep the batch consistent
    return _batches(insert=ins, delete=list(dict.fromkeys(dels)))


@pytest.mark.parametrize("seed,step_impl", [
    (0, "torch"), (1, "stream"), (2, "torch"), (3, "stream")])
def test_invalidation_sound_and_refresh_equals_rebuild(seed, step_impl):
    """Segments not marked stale are byte-identical under the new graph,
    and the refreshed slab equals a from-scratch build at the new epoch,
    endpoints and masks: the port's and the reference's alike."""
    rng = np.random.default_rng(seed)
    gj, gt = _graphs("uniform_random", 96, 4.0, seed)
    cj, ct = _cfgs(step_impl=step_impl)
    ij, it = jindex._build_walk_index(gj, cj), tindex._build_walk_index(gt,
                                                                       ct)
    bj, bt = _random_batch(gt, rng)
    gj2, cgj = japply(gj, bj)
    gt2, cgt = apply_mutations(gt, bt)
    stale = invalidate_segments(it, cgt)
    assert stale.dtype == torch.bool
    _eq(jinvalidate(ij, cgj), stale)
    full = tindex._build_walk_index(gt2, ct)
    assert torch.equal(it.endpoints[~stale], full.endpoints[~stale]), (
        "unsound invalidation: a non-stale segment changed")
    new, report = refresh_walk_index(it, gt2, cgt, step_impl=step_impl,
                                     chunk=17)
    want, want_report = jrefresh(ij, gj2, cgj, chunk=17)
    assert torch.equal(new.endpoints, full.endpoints)
    assert torch.equal(new.visited_blocks.view(torch.int32),
                       full.visited_blocks.view(torch.int32))
    _eq(want.endpoints, new.endpoints)
    _eq(want.visited_blocks, new.visited_blocks)
    assert isinstance(report, RefreshReport)
    assert dataclasses.asdict(report) == dataclasses.asdict(want_report)
    assert (new.graph_epoch, new.mutation_offset) == (1, bt.size)
    assert report.segments_rebuilt == int(stale.sum())
    assert report.stale_rows == int(stale.any(1).sum())


def test_refresh_sharded_roundtrip_and_sparsity():
    """A sharded slab refreshes to the same shard count, equal to the
    reference's and to a sharded rebuild; a localized mutation invalidates
    far fewer segments than the slab holds. ``step_impl`` defaults to the
    port's ``"auto"``."""
    gj, gt = _graphs("uniform_random", 256, 4.0, 5)
    cj, ct = _cfgs(R=4, L=2, S=4, step_impl="auto")
    sj = jindex.shard_walk_index(jindex._build_walk_index(gj, cj), 4)
    st = tindex.shard_walk_index(tindex._build_walk_index(gt, ct), 4)
    assert tindex.segment_mask_block_size(gt.n) == 1   # exact invalidation
    bj, bt = _batches(insert=[(17, 200)])
    gj2, cgj = japply(gj, bj)
    gt2, cgt = apply_mutations(gt, bt)
    _eq(jinvalidate(sj, cgj), invalidate_segments(st, cgt))
    new, report = refresh_walk_index(st, gt2, cgt)
    want, want_report = jrefresh(sj, gj2, cgj)
    assert isinstance(new, tindex.ShardedWalkIndex) and new.num_shards == 4
    full = tindex.shard_walk_index(tindex._build_walk_index(gt2, ct), 4)
    assert torch.equal(new.blocks, full.blocks)
    assert torch.equal(new.visited_blocks.view(torch.int32),
                       full.visited_blocks.view(torch.int32))
    _eq(want.blocks, new.blocks)
    _eq(want.visited_blocks, new.visited_blocks)
    assert dataclasses.asdict(report) == dataclasses.asdict(want_report)
    assert report.segments_rebuilt < report.total_segments // 4


def test_refresh_refuses_mismatched_pairs():
    gt = tgen.uniform_random(64, 4.0, seed=6)
    _, ct = _cfgs()
    idx = tindex._build_walk_index(gt, ct)
    with pytest.raises(ValueError, match="not ahead"):
        refresh_walk_index(idx, gt, np.array([1]))
    legacy = tindex.WalkIndex(endpoints=idx.endpoints,
                              segment_len=idx.segment_len, seed=idx.seed)
    g2, changed = apply_mutations(gt, MutationBatch.edges(insert=[(0, 1)]))
    with pytest.raises(ValueError, match="visited_blocks"):
        refresh_walk_index(legacy, g2, changed)
    with pytest.raises(ValueError, match="vertex count"):
        refresh_walk_index(idx, tgen.uniform_random(32, 4.0, seed=6),
                           changed)
    with pytest.raises(ValueError, match="outside"):
        invalidate_segments(idx, np.array([64]))


def test_dirty_block_mask_equal_reference():
    from repro.dynamic import dirty_block_mask as jdirty
    rng = np.random.default_rng(4)
    for n in (5, 256, 1001, 4_847_571):
        changed = np.unique(rng.integers(0, n, size=7))
        _eq(jdirty(changed, n), dirty_block_mask(changed, n))
    _eq(jdirty(np.zeros(0, np.int64), 9),
        dirty_block_mask(np.zeros(0, np.int64), 9))
