"""Plain PyTorch versions of the port's kernels (port of the matching
oracles in ``repro/kernels/ref.py``).

Each computes exactly what its CUDA kernel computes, on any device, its
draws through ``prng``'s plain torch version; the wrappers in ``ops.py``
take them for CPU tensors, the tests hold them against the reference's
Pallas kernels, and ``chip_smoke.py`` holds the kernels against them on
the card. Every walker comparison is byte-equal:
the outputs are integers, except ``spmv_ref``'s float32, which sums in the
kernel's own order with separately rounded products and sums. The
attention versions (``attention_ref``, ``attention_chunked``,
``decode_attention_ref``) compute in float32 and are held to the
reference and to the ``flash_attention`` kernel within stated tolerances,
as are the two time recurrences (``wkv6_scan_ref``, ``ssd_scan_ref``):
the reference's ``lax.scan`` step functions looped over time.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch import prng
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


def stitch_gather_rounds_ref(pos, q, s0, slab, q_max: int, lost=None,
                             S: int = 1, sz: int = 0):
    """A wave's ``q_max`` stitch rounds: ``(pos int32[W], alive bool[W] or
    None)``. Round ``j`` gathers with bits ``abs(s0 + j)`` (an int32 add,
    wrapping) and moves the walks with ``j < q``; with ``lost`` a walk in a
    lost shard's rows (``lost[clip(pos // sz, 0, S − 1)]``) dies before a
    gather it still needs, or after its last, and keeps its position."""
    def in_lost(p):
        shard = torch.clamp(torch.div(p, sz, rounding_mode="floor"), 0,
                            S - 1)
        return lost[shard.long()]

    alive = None if lost is None else torch.ones_like(pos, dtype=torch.bool)
    for j in range(q_max):
        move = j < q
        if alive is not None:
            alive &= ~(in_lost(pos) & move)
            move = move & alive
        pos = torch.where(move, stitch_gather_ref(pos, torch.abs(s0 + j),
                                                  slab), pos)
    if alive is not None:
        alive &= ~in_lost(pos)
    return pos, alive


def stitch_step_ref(pos, stop, bits, endpoints, n: int):
    """The fused stitch round: ``(next int32[W], stop_counts int32[n])``;
    the counts tally ``stop`` at each walk's current vertex."""
    nxt = stitch_gather_ref(pos, bits, endpoints)
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    counts.index_add_(0, pos.long(), stop.to(torch.int32))
    return nxt, counts


def stitch_step_rounds_ref(pos, q, s0, endpoints, n: int, num_rounds: int):
    """``walk_wave``'s ``num_rounds + 1`` stitch rounds: ``(pos int32[W],
    stop_counts int32[n])``. Round ``j`` tallies the walks with ``q == j``
    at their current vertex and moves the walks with ``j < q`` to
    ``endpoints[pos, abs(s0 + j) % R]`` (``s0 + j`` wrapping as an int32
    add does)."""
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    for j in range(num_rounds + 1):
        nxt, c = stitch_step_ref(pos, q == j, torch.abs(s0 + j), endpoints,
                                 n)
        counts += c
        pos = torch.where(j < q, nxt, pos)
    return pos, counts


def lost_of(lost, pos, S: int, sz: int):
    """``lost[clip(pos // sz, 0, S − 1)]``: bool[W], True for walks sitting
    in an evicted shard's rows."""
    shard = torch.clamp(torch.div(pos, sz, rounding_mode="floor"), 0, S - 1)
    return lost[shard.long()]


def stitch_rounds(pos, q, q_max: int, round_fn, lost_fn=None):
    """``q_max`` stitch rounds: ``round_fn(pos, j)`` is round ``j``'s next
    position for every walk, taken by the walks with ``j < q``. With
    ``lost_fn(pos)`` marking walks in an evicted shard's rows, a walk that
    still needs a gather there, or whose final vertex lies there, dies and
    keeps its position. Returns ``(pos, alive)``, ``alive`` bool[W] or
    ``None`` when no ``lost_fn`` is given (every walk lives)."""
    if lost_fn is None:
        for j in range(q_max):
            pos = torch.where(j < q, round_fn(pos, j), pos)
        return pos, None
    alive = torch.ones_like(pos, dtype=torch.bool)
    for j in range(q_max):
        alive &= ~(lost_fn(pos) & (j < q))
        pos = torch.where((j < q) & alive, round_fn(pos, j), pos)
    alive &= ~lost_fn(pos)
    return pos, alive


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


def stitch_gather_local_rounds_ref(pos, q, s0, blocks, q_max: int,
                                   lost=None):
    """The loop wave's ``q_max`` stitch rounds over ``S`` shard blocks
    (``blocks[s]`` int32[sz, R], rows ``[s·sz, (s+1)·sz)``; ``None`` for a
    lost shard's): ``(pos int32[W], alive bool[W] or None)``. Each round
    sums :func:`stitch_gather_local_ref` over the shards that are not lost
    (bits ``abs(s0 + j)``), under :func:`stitch_rounds`' lost-shard rule;
    the same bytes as :func:`stitch_gather_rounds_ref` over the blocks
    stacked."""
    S = len(blocks)
    sz = next(b for b in blocks if b is not None).shape[0]
    lost_host = [False] * S if lost is None else lost.tolist()
    live = [s for s in range(S) if not lost_host[s]]

    def round_fn(pos, j):
        bits = torch.abs(s0 + j)
        return sum((stitch_gather_local_ref(pos, bits, blocks[s], s * sz)
                    for s in live), torch.zeros_like(pos))

    return stitch_rounds(pos, q, q_max, round_fn,
                         None if lost is None
                         else lambda p: lost_of(lost, p, S, sz))


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


# ---------------------------------------------------------------------------
# the kernels with their own draws (rng="device"): the reference's threefry
# streams drawn through ``prng``'s plain version, then the caller-bits
# oracles above
# ---------------------------------------------------------------------------

def slot_bits(key, W: int):
    """A stitch kernel's slot bits under ``rng="device"`` (int32[W]): walk
    ``w`` draws ``randint(key, (W,), 0, 2**30)[w]``, as the waves draw
    their slot offsets ``s0``."""
    return prng.randint(key, (W,), 0, 1 << 30, impl="torch")


def superstep_draws(step_key, p_T: float, N: int):
    """One superstep of the batch walk's draws, as ``core/frogwild.py``
    takes them: ``(k_die, k_move) = split(step_key)``, the death coins
    ``bernoulli(k_die, p_T, (N,))`` and the slot bits ``randint(k_move,
    (N,), 0, 2**30)``; frog ``f`` draws at counter ``f``."""
    k_die, k_move = prng.split(step_key, impl="torch")
    return (prng.bernoulli(k_die, p_T, (N,), impl="torch"),
            prng.randint(k_move, (N,), 0, 1 << 30, impl="torch"))


def hop_bits(row_keys, step: int, R: int):
    """One hop of the index build's slot bits (int32[C · R]): row ``c``'s
    ``R`` walks draw ``randint(fold_in(row_keys[c], step), (R,), 0,
    2**30)``, walk ``c · R + r`` at counter ``r``."""
    return prng.randint(prng.fold_in(row_keys, step, impl="torch"), (R,), 0,
                        1 << 30, impl="torch").reshape(-1)


def hop_keys(row_keys, step, impl: Optional[str] = "torch"):
    """The keys the rows' walks draw a hop's bits from (int64[C, 2], or
    int64[L, C, 2] for ``step`` a tensor of shape ``[L, 1]``): randint's
    low stream of ``fold_in(row_keys[c], step)``, which is ``split(k)[1]
    = fold_in(k, 1)``. ``impl`` as for a ``prng`` draw (``None``: the
    draw kernels on a CUDA key)."""
    return prng.fold_in(prng.fold_in(row_keys, step, impl=impl), 1,
                        impl=impl)


def hop_key_bits(keys, R: int):
    """:func:`hop_bits` from the rows' :func:`hop_keys`: walk ``c · R + r``
    draws one block, the low 30 bits of ``bits(keys[c], r)``."""
    return (prng.random_bits(keys, (R,), impl="torch")
            & ((1 << 30) - 1)).to(torch.int32).reshape(-1)


# Per-segment visited-block masks of the walk index (the reference's
# ``_MASK_WORDS`` and ``segment_mask_block_size``, query/index.py): ``32 ·
# MASK_WORDS`` blocks of ``segment_mask_block_size(n)`` consecutive vertex
# ids, one bit each, a segment's words uint32.
MASK_WORDS = 8


def segment_mask_block_size(n: int) -> int:
    """Vertex ids per visited-block bit for an n-vertex graph: every id
    of the graph falls in one of the mask's 256 blocks."""
    return max(1, -(-n // (32 * MASK_WORDS)))


def block_one_hot(pos, block_size: int):
    """int32[N, MASK_WORDS], the uint32 words' bits: the visited-block bit
    of each vertex in ``pos``; a vertex whose block is past the mask's 256
    sets none (the reference's ``_block_one_hot``)."""
    blk = pos.long() // block_size
    words = torch.arange(MASK_WORDS, device=pos.device)
    bit = torch.bitwise_left_shift(torch.ones_like(blk), blk & 31)
    oh = torch.where(words[None, :] == (blk >> 5)[:, None], bit[:, None], 0)
    return (oh - ((oh >> 31) << 32)).to(torch.int32)   # bit 31 wraps


def hop_visits(visited, nxt, step: int, record: bool, block_size: int):
    """The mask rows (int32[N, MASK_WORDS]) after a hop of the index build
    reached ``nxt``: hop 0 starts them, at ``nxt``'s bit when ``record``
    is set and empty otherwise; a later hop ORs the bit in when it
    records. ``visited`` holds the rows before the hop (read after hop 0
    only)."""
    oh = (block_one_hot(nxt, block_size) if record
          else torch.zeros(nxt.shape[0], MASK_WORDS, dtype=torch.int32,
                           device=nxt.device))
    return oh if step == 0 else visited | oh


def frog_segment_masks_ref(trail, block_size: int, visited=None):
    """The mask rows (int32[N, MASK_WORDS]) of walks that stood on
    ``trail[0 … T − 1]`` (int32[T, N]): the OR of their block bits, and of
    ``visited``'s old words when given."""
    out = (torch.zeros(trail.shape[1], MASK_WORDS, dtype=torch.int32,
                       device=trail.device) if visited is None
           else visited.clone())
    for t in range(trail.shape[0]):
        out |= block_one_hot(trail[t], block_size)
    return out


def frog_segment_walk_ref(vertices, row_keys, R: int, L: int, row_ptr,
                          col_idx, deg, n: int):
    """A walk-index segment walk (the reference's ``_segment_walk_rows``):
    the ``R`` walks of each row ``c`` start at ``vertices[c]`` and take
    ``L`` hops of :func:`frog_hop_ref`, hops ``0 … L − 2`` recorded in
    their masks (:func:`hop_visits`) → ``(endpoints int32[C, R], visited
    int32[C, R, MASK_WORDS])``."""
    C = vertices.shape[0]
    pos = torch.repeat_interleave(vertices.to(torch.int32), R,
                                  output_size=C * R)
    bs = segment_mask_block_size(n)
    vis = None
    for step in range(L):
        pos = frog_hop_ref(pos, row_keys, step, R, row_ptr, col_idx, deg)
        vis = hop_visits(vis, pos, step, step < L - 1, bs)
    return pos.view(C, R), vis.view(C, R, MASK_WORDS)


def frog_superstep_ref(pos, alive, counts, step_key, p_T: float, row_ptr,
                       col_idx, deg, n: int):
    """A whole superstep of the batch walk → new ``(pos int32[N], alive
    bool[N], counts int32[n])``: a live frog that draws death is tallied
    at its vertex and dies; every other live frog moves; dead frogs stay.
    """
    die, bits = superstep_draws(step_key, p_T, pos.shape[0])
    die &= alive
    nxt, dead = frog_step_ref(pos, die, bits, row_ptr, col_idx, deg, n)
    alive = alive & ~die
    return torch.where(alive, nxt, pos), alive, counts + dead


def frog_hop_ref(pos, row_keys, step: int, R: int, row_ptr, col_idx, deg):
    """One hop of the index build's walks (int32[C · R], row-major: walk
    ``c · R + r`` is slot ``r`` of row ``c``) → the new positions."""
    return uniform_successor(row_ptr, col_idx, deg, pos,
                             hop_bits(row_keys, step, R))


def _unsort(order, values_s):
    out = torch.empty_like(values_s)
    out[order] = values_s
    return out


def frog_superstep_stream_sorted_ref(pos_s, order, alive, counts, step_key,
                                     p_T: float, seg_off, row_off, deg, col):
    """:func:`frog_superstep_ref` through the streamed superstep: frogs
    sorted by vertex (``pos_s``), ``order[f]`` the original index of sorted
    frog ``f``, whose draws are at counter ``order[f]``. Returns new
    ``(pos, alive, counts)`` in the original order."""
    die, bits = superstep_draws(step_key, p_T, pos_s.shape[0])
    o = order.long()
    die_s = (die & alive)[o]
    nxt_s, dead = frog_step_stream_sorted_ref(pos_s, die_s, bits[o], seg_off,
                                              row_off, deg, col)
    live_s = alive[o] & ~die_s
    return (_unsort(o, torch.where(live_s, nxt_s, pos_s)), _unsort(o, live_s),
            counts + dead[: counts.shape[0]])


def frog_hop_stream_sorted_ref(pos_s, order, keys, R: int, seg_off, row_off,
                               deg, col):
    """:func:`frog_hop_ref` through the streamed superstep, on walks sorted
    by vertex, the rows' bits from their :func:`hop_keys`: the new
    positions in the original order."""
    o = order.long()
    bits = hop_key_bits(keys, R)[o]
    nxt_s, _ = frog_step_stream_sorted_ref(pos_s, torch.zeros_like(pos_s),
                                           bits, seg_off, row_off, deg, col)
    return _unsort(o, nxt_s)


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


# ---------------------------------------------------------------------------
# attention (port of repro/kernels/ref.py:attention_ref, attention_chunked,
# decode_attention_ref)
# ---------------------------------------------------------------------------

def attention_scale(D: int) -> float:
    """``1 / sqrt(D)`` rounded as the reference computes it in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(D)))


def _attend(q, k, v, mask, logit_soft_cap):
    """Softmax attention of ``q [B, Hq, Sq, D]`` over ``k``/``v [B, Hkv,
    Skv, D]`` in float32 under a ``[Sq, Skv]`` boolean mask; query head h
    reads KV head ``h // (Hq / Hkv)`` through a reshape (K and V are never
    repeated); fully-masked rows give 0. Returns float32 ``[B, Hq, Sq, D]``.
    """
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    g = Hq // Hkv
    qf = q.float().reshape(B, Hkv, g * Sq, D)
    logits = torch.matmul(qf, k.float().transpose(-1, -2))
    logits = logits.view(B, Hq, Sq, -1).mul_(attention_scale(D))
    if logit_soft_cap is not None:
        logits = torch.tanh(logits / logit_soft_cap).mul_(logit_soft_cap)
    logits.masked_fill_(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    del logits
    probs = torch.nan_to_num_(probs, nan=0.0)
    out = torch.matmul(probs.view(B, Hkv, g * Sq, -1), v.float())
    return out.view(B, Hq, Sq, D)


def _mask(qpos, kpos, causal: bool, window: Optional[int]):
    mask = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0,
                  logit_soft_cap: Optional[float] = None) -> torch.Tensor:
    """GQA scaled-dot-product attention oracle (float32 math, output in
    ``q``'s dtype): ``q [B, Hq, Sq, D]``, ``k``/``v [B, Hkv, Skv, D]``;
    query ``i`` sits at ``q_offset + i``; keys ``j ≤`` it under ``causal``
    and ``j > q_pos − window`` under a window."""
    dev = q.device
    qpos = q_offset + torch.arange(q.shape[2], device=dev)
    kpos = torch.arange(k.shape[2], device=dev)
    out = _attend(q, k, v, _mask(qpos, kpos, causal, window),
                  logit_soft_cap)
    return out.to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0,
                      logit_soft_cap: Optional[float] = None,
                      chunk: int = 512) -> torch.Tensor:
    """Memory-bounded attention: a loop over query chunks, float32 math.

    Peak live logits are ``[B, Hq, chunk, Skv]``. With a causal sliding
    ``window`` each chunk slices only the K/V band it can see (its width
    ``⌈(window + chunk) / chunk⌉ · chunk``, at most ``Skv``), so windowed
    work is O(S·window), as in the reference. A ragged last chunk is run
    short, where the reference pads it and strips the padding: the rows
    kept are the same.
    """
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    dev = q.device
    banded = window is not None and causal
    if banded:
        band = min(-(-(window + chunk) // chunk) * chunk, Skv)
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    for c0 in range(0, Sq, chunk):
        c1 = min(c0 + chunk, Sq)
        q0 = c0 + q_offset                       # absolute q start
        if banded:
            start = min(max(q0 - window + 1, 0), Skv - band)
            kc, vc = k[:, :, start:start + band], v[:, :, start:start + band]
            kpos = start + torch.arange(band, device=dev)
        else:
            kc, vc = k, v
            kpos = torch.arange(Skv, device=dev)
        qpos = q0 + torch.arange(c1 - c0, device=dev)
        out[:, :, c0:c1] = _attend(q[:, :, c0:c1], kc, vc,
                                   _mask(qpos, kpos, causal, window),
                                   logit_soft_cap)
    return out


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         length: Union[int, torch.Tensor],
                         window: Optional[int] = None,
                         logit_soft_cap: Optional[float] = None
                         ) -> torch.Tensor:
    """Single-token decode attention oracle: ``q [B, Hq, 1, D]`` over the
    first ``length`` cache slots (the last ``window`` of them under a
    window)."""
    kpos = torch.arange(k_cache.shape[2], device=q.device)
    mask = kpos < length
    if window is not None:
        mask &= kpos >= length - window
    out = _attend(q, k_cache, v_cache, mask[None, :], logit_soft_cap)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# the recurrent families' time recurrences (no Pallas kernel in the
# reference: its lax.scan step functions, looped over time)
# ---------------------------------------------------------------------------

def wkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  S0: Optional[torch.Tensor] = None):
    """RWKV-6's recurrence, ``repro/models/rwkv6.py``'s step per time step
    in float32: per (batch, head), ``o_t = r_tᵀ(S_{t−1} + diag(u)·k_t
    v_tᵀ)`` and ``S_t = diag(w_t)·S_{t−1} + k_t v_tᵀ``. ``r``, ``k``,
    ``v``, ``w`` ``[B, S, H, D]``, ``u [H, D]``, ``S0 [B, H, D, D]`` (key
    row, value column; zeros when None) → (``o [B, S, H, D]`` in ``r``'s
    dtype, ``S_last`` float32)."""
    B, S, H, D = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uh = u.float().reshape(H, D)[None, :, :, None]
    st = (torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device)
          if S0 is None else S0.float())
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, t], st + uh * kv))
        st = wf[:, t, :, :, None] * st + kv
    o = torch.stack(outs, 1) if outs else rf.new_zeros(B, 0, H, D)
    return o.to(r.dtype), st


def ssd_scan_ref(x: torch.Tensor, Bv: torch.Tensor, Cv: torch.Tensor,
                 dt: torch.Tensor, a: torch.Tensor,
                 h0: Optional[torch.Tensor] = None):
    """Mamba-2's selective scan, ``repro/models/mamba2.py``'s step per
    time step in float32: per (batch, head), ``h_t = exp(Δ_t·a)·h_{t−1}
    + Δ_t·(x_t ⊗ B_t)`` and ``y_t = h_t·C_t``. ``x [B, S, H, D]``, ``Bv``,
    ``Cv [B, S, n]``, ``dt [B, S, H]``, ``a [H]``, ``h0 [B, H, D, n]``
    (zeros when None) → (``y [B, S, H, D]`` float32, ``h_last``
    float32). The ``D`` skip, the gate and the norm are the caller's."""
    B, S, H, D = x.shape
    n = Bv.shape[-1]
    xf, Bf, Cf, df = x.float(), Bv.float(), Cv.float(), dt.float()
    af = a.float()
    h = (torch.zeros(B, H, D, n, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dlt = df[:, t]
        decay = torch.exp(dlt * af[None, :])
        dBx = torch.einsum("bhd,bn,bh->bhdn", xf[:, t], Bf[:, t], dlt)
        h = decay[..., None, None] * h + dBx
        ys.append(torch.einsum("bhdn,bn->bhd", h, Cf[:, t]))
    y = torch.stack(ys, 1) if ys else xf.new_zeros(B, 0, H, D)
    return y, h
