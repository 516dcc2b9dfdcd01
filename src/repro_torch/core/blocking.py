"""Per-frog blocking-walk draws for the erasure models (port of
``repro/core/blocking.py``).

The blocking walk (paper Definition 8 / Process 19) moves each frog
uniformly among the out-edges of its vertex that survived this superstep's
erasure. Two draws avoid the O(nnz) per-edge pass:

* :func:`rejection_blocking_draw` — the independent model (one coin per
  edge): probe uniform out-edge slots, accept the first open one, fall back
  to the Example-10 forced edge when every round rejected;
* :func:`channel_enum_draw` — the channel model (one coin per (vertex,
  destination shard)): pick an open channel with probability ∝ its edge
  count, then a uniform edge within it; exact for any skew.

A coin is a pure function of ``(channel id, key)``: :func:`hash_bits`, two
chained splitmix32 rounds, or one threefry ``fold_in`` per element. Every
value is the reference's, byte for byte: the uint32 arithmetic is done in
int64 masked to 32 bits (products split in 16-bit halves so no int64
product overflows), and the coin ``(bits >> 8)·2⁻²⁴`` is exact in float32.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import math

import torch

from repro_torch import prng

ROUNDS_PER_CHUNK = 32      # probe rounds per chunk in the chunked regime
UNROLL_PROBES = 1 << 21    # ≤ this many probes ⇒ one shot of all rounds

_M32 = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9


def num_rounds_for(p_s: float, eps: float = 1e-4) -> int:
    """Retry budget so the non-accept residual (1 − p_s)^K is below
    ``eps``: ``clip(ceil(ln(1/eps) / max(p_s, 1e-3)), 8, 256)``."""
    r = math.ceil(math.log(1.0 / eps) / max(p_s, 1e-3))
    return int(min(max(r, 8), 256))


def rejection_is_profitable(B: int, nnz: int, p_s: float,
                            num_channels: Optional[int] = None) -> bool:
    """``draw="auto"``: the probe draw when its probe budget (``B·S``
    for the channel enumeration, ``B·num_rounds`` for edge rejection) is at
    most a third of the per-edge pass."""
    probes = B * (num_channels if num_channels else num_rounds_for(p_s))
    return probes * 3 <= nnz


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x · m mod 2³²`` for int64 ``x`` in ``[0, 2³²)``: the high half's
    product is reduced before the shift, so every product stays < 2⁴⁸."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _M32


def _splitmix(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def hash_bits(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """uint32 hash per (key, idx) as int64: ``idx·GOLDEN + k0``, splitmix,
    ``^ k1``, splitmix (``idx`` taken mod 2³², as ``astype(uint32)``)."""
    k0, k1 = prng.key_data(key).unbind(-1)
    x = (_mul32(idx.long() & _M32, _GOLDEN) + k0) & _M32
    return _splitmix(_splitmix(x) ^ k1)


def coin_uniform(key: torch.Tensor, idx: torch.Tensor,
                 impl: str = "hash") -> torch.Tensor:
    """Deterministic uniform [0, 1) per (key, idx), float32: the erasure
    coin. ``impl="fold_in"`` takes the second word of ``fold_in(key,
    idx)`` per element instead of :func:`hash_bits`."""
    if impl == "hash":
        bits = hash_bits(key, idx)
    elif impl == "fold_in":
        bits = prng.fold_in(key, idx)[..., 1]
    else:
        raise ValueError(f"unknown coin impl {impl!r}")
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def forced_edge_for(key: torch.Tensor, pos: torch.Tensor,
                    row_ptr_at: torch.Tensor, deg_at: torch.Tensor
                    ) -> torch.Tensor:
    """Example-10 repair edge, keyed per vertex: every frog on the same
    vertex is forced onto the same uniformly chosen edge
    ``row_ptr[v] + min(int(u·deg), deg − 1)`` (int64)."""
    degs = torch.clamp_min(deg_at, 1)
    u = coin_uniform(key, pos)
    slot = torch.minimum((u * degs.to(torch.float32)).to(torch.int32),
                         degs - 1)
    return row_ptr_at.long() + slot.long()


def channel_enum_draw(key: torch.Tensor, pos: torch.Tensor,
                      row_ptr_at: torch.Tensor, deg_at: torch.Tensor,
                      chan_cnt_at: torch.Tensor, chan_off_at: torch.Tensor,
                      coins_open: torch.Tensor,
                      skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact blocking draw for the channel model, O(B·S), loop-free: a
    channel with probability ∝ its edges on open channels (``[B, S]``
    operands), then a uniform edge within it; no open edge (or deg 0, or
    ``skip``) takes the forced edge. Returns an int64 index into the
    channel-sorted edge array (``CSRGraph.channel_layout``'s
    ``col_sorted``)."""
    B = pos.shape[0]
    k_draw, k_force = prng.split(key)
    w = torch.where(coins_open, chan_cnt_at, 0).long()          # [B, S]
    csum = torch.cumsum(w, 1)
    kv = csum[:, -1]
    r = (hash_bits(k_draw, torch.arange(B, device=pos.device)) >> 1) \
        % torch.clamp_min(kv, 1)
    # the first channel whose running count passes r (argmax's first max)
    chan = (csum > r[:, None]).to(torch.int8).argmax(1, keepdim=True)
    before = torch.gather(csum - w, 1, chan)[:, 0]
    edge = (row_ptr_at.long() + torch.gather(chan_off_at, 1, chan)[:, 0]
            + (r - before))
    forced = forced_edge_for(k_force, pos, row_ptr_at, deg_at)
    ok = (kv > 0) & (deg_at > 0)
    if skip is not None:
        ok = ok & ~skip
    return torch.where(ok, edge, forced)


def rejection_blocking_draw(
        key: torch.Tensor, pos: torch.Tensor, row_ptr: torch.Tensor,
        deg: torch.Tensor, p_s: float,
        chan_of: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        num_rounds: Optional[int] = None,
        skip: Optional[torch.Tensor] = None,
        coin_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One surviving out-edge index per frog (int64; the caller gathers
    ``col_idx``) by rejection: round ``i`` probes slot ``hash % deg`` and
    accepts when the coin of ``chan_of(v, e)`` is below ``p_s``; the first
    accepted round wins, and a frog that never accepts (or sits on a
    vertex of degree 0, or is ``skip``ped) takes its forced edge.

    The reference's two regimes give the probes their ids: with
    ``num_rounds·B ≤ UNROLL_PROBES`` one shot of ``num_rounds`` rounds,
    else chunks of ``ROUNDS_PER_CHUNK`` rounds, chunk ``c`` numbering its
    probes from ``c·32·B`` (a chunk of 32 even when fewer rounds remain).
    The reference's loop stops once every frog accepted; here every chunk
    runs, which changes no byte — a chunk leaves done frogs as they are —
    and needs no host read-back between chunks.
    """
    B = pos.shape[0]
    if num_rounds is None:
        num_rounds = num_rounds_for(p_s)
    k_slot, k_coin, k_force = prng.split(key, 3)
    if coin_key is not None:
        k_coin = coin_key
    p = torch.tensor(p_s, dtype=torch.float32, device=pos.device)

    pos_l = pos.long()
    deg_at = deg[pos_l]
    degs = torch.clamp_min(deg_at, 1).long()
    base = row_ptr[pos_l].long()
    edge = forced_edge_for(k_force, pos, base, deg_at)
    done = deg_at <= 0
    if skip is not None:
        done = done | skip

    def probes(c: int, R: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """[R, B] candidate edges and their acceptance, chunk ``c``."""
        probe_id = (torch.arange(R * B, device=pos.device).view(R, B)
                    + c * (R * B))
        slot = (hash_bits(k_slot, probe_id) >> 1) % degs
        e = base + slot
        u = coin_uniform(k_coin, chan_of(pos_l.expand(R, B), e))
        return e, u < p

    def first_hit(e, acc, edge, done):
        hit = acc.any(0)
        first = acc.to(torch.int8).argmax(0, keepdim=True)
        cand = torch.gather(e, 0, first)[0]
        return torch.where(~done & hit, cand, edge), done | hit

    if num_rounds * B <= UNROLL_PROBES:
        return first_hit(*probes(0, num_rounds), edge, done)[0]
    R = ROUNDS_PER_CHUNK
    for c in range(-(-num_rounds // R)):
        edge, done = first_hit(*probes(c, R), edge, done)
    return edge
