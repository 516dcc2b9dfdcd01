"""Plain PyTorch versions of the port's kernels (port of the matching
oracles in ``repro/kernels/ref.py``).

Each computes exactly what its CUDA kernel computes, on any device; the
wrappers in ``ops.py`` take them for CPU tensors, the tests hold them
against the reference's Pallas kernels, and ``chip_smoke.py`` holds the
kernels against them on the card. Every comparison is byte-equal: the
outputs are integers, except ``spmv_ref``'s float32, which sums in the
kernel's own order with separately rounded products and sums.
"""
from __future__ import annotations

import torch

from repro_torch.graph.csr import uniform_successor


def frog_count_ref(dest: torch.Tensor, n: int) -> torch.Tensor:
    """``counts[v] = #{f : dest[f] == v}`` (int32[n]); entries outside
    ``[0, n)``, such as the padding sentinel -1, are ignored."""
    valid = (dest >= 0) & (dest < n)
    idx = torch.where(valid, dest.long(), n)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=dest.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts[:n]


def frog_step_ref(pos, die, bits, row_ptr, col_idx, deg, n: int):
    """The fused walker step: ``(next int32[N], death_counts int32[n])``.

    ``next = col_idx[row_ptr[pos] + bits % deg[pos]]`` (stay put when
    ``d_out = 0``); the counts tally ``die`` at each frog's current vertex.
    """
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    counts.index_add_(0, pos.long(), die.to(torch.int32))
    return uniform_successor(row_ptr, col_idx, deg, pos, bits), counts


def stitch_gather_ref(pos, bits, endpoints):
    """The gather-only stitch round: ``next = endpoints[pos, bits % R]``."""
    R = endpoints.shape[1]
    idx = pos.long() * R + torch.remainder(bits, R).long()
    return endpoints.reshape(-1)[idx].to(torch.int32)


def stitch_step_ref(pos, stop, bits, endpoints, n: int):
    """The fused stitch round: ``(next int32[W], stop_counts int32[n])``;
    the counts tally ``stop`` at each walk's current vertex."""
    nxt = stitch_gather_ref(pos, bits, endpoints)
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    counts.index_add_(0, pos.long(), stop.to(torch.int32))
    return nxt, counts


def _local(pos, base: int, sz: int):
    """``(owned bool[W], clamped local row int64[W])`` of walks against the
    shard that owns rows ``[base, base + sz)``."""
    local = pos.long() - int(base)
    owned = (local >= 0) & (local < sz)
    return owned, torch.clamp(local, 0, sz - 1)


def stitch_gather_local_ref(pos, bits, block, base: int):
    """The per-shard gather: owned walks (``0 ≤ pos − base < sz``) get
    ``block[pos − base, bits % R]``, every other walk 0."""
    sz, R = block.shape
    owned, li = _local(pos, base, sz)
    nxt = block.reshape(-1)[li * R + torch.remainder(bits, R).long()]
    return torch.where(owned, nxt, 0).to(torch.int32)


def stitch_step_local_ref(pos, stop, bits, block, base: int):
    """The per-shard stitch round: ``(next int32[W], stop_counts
    int32[sz])``; owned stopped walks are tallied into the shard's local
    bins. Summed over the shards, both equal :func:`stitch_step_ref`."""
    sz = block.shape[0]
    owned, li = _local(pos, base, sz)
    counts = torch.zeros(sz + 1, dtype=torch.int32, device=pos.device)
    counts.index_add_(0, torch.where(owned, li, sz), stop.to(torch.int32))
    return stitch_gather_local_ref(pos, bits, block, base), counts[:sz]


def frog_step_stream_sorted_ref(pos, die, bits, seg_off, row_off, deg, col):
    """The streamed superstep on frogs sorted by vertex: ``(next int32[N],
    death_counts int32[n_pad])`` in the sorted order.

    Frog ``f`` of block ``v``'s run ``seg_off[v] ≤ f < seg_off[v + 1]``
    moves to ``col[v, row_off[v, local] + bits % d]`` with ``local = pos −
    v·BV`` and ``d = deg[v, local]`` (stays put when ``d = 0``); deaths are
    tallied at the frog's vertex.
    """
    num_vb, bv = deg.shape
    N = pos.shape[0]
    runs = (seg_off[1:] - seg_off[:-1]).long()
    v = torch.repeat_interleave(torch.arange(num_vb, device=pos.device),
                                runs, output_size=N)
    local = pos.long() - v * bv
    d = deg[v, local]
    slot = torch.remainder(bits, torch.clamp_min(d, 1)).long()
    edge = torch.where(d > 0, row_off[v, local].long() + slot, 0)
    nxt = torch.where(d > 0, col[v, edge], pos).to(torch.int32)
    counts = torch.zeros(num_vb * bv, dtype=torch.int32, device=pos.device)
    counts.index_add_(0, pos.long(), die.to(torch.int32))
    return nxt, counts


def spmv_ref(idx, weight, x):
    """The ELL slab product ``y[r] = Σ_k weight[r, k] · x[idx[r, k]]``
    (float32[rows]) in the kernel's order: ``k = 0 … K − 1``, each product
    rounded, then added. Padded lanes (``weight = 0``, ``idx`` in range)
    add ``0 · x[idx]``."""
    y = torch.zeros(idx.shape[0], dtype=x.dtype, device=x.device)
    for k in range(idx.shape[1]):
        y = y + weight[:, k] * x[idx[:, k].long()]
    return y


def spill_ref(spill_src, spill_dst, spill_w, x, n: int):
    """The COO tail of the hybrid SpMV: ``y[dst] += w · x[src]``
    (float32[n]; ``index_add_``, float atomics on the card)."""
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    return y.index_add_(0, spill_dst.long(), x[spill_src.long()] * spill_w)
