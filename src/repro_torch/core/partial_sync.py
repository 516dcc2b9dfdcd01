"""Partial synchronization as a mesh-generic primitive (port of
``repro/core/partial_sync.py``).

The paper's ``p_s`` knob (randomized mirror synchronization in PowerGraph)
lifted to the collectives of a :class:`~repro_torch.distributed.runtime.
ShardMesh`. Each function takes the mesh and this rank's shards stacked on
axis 0 (``[S_local, ...]``), where the reference runs once a shard inside
``shard_map``. The coins are the reference's threefry draws from
``fold_in(key, shard id)``, so the masks equal its masks byte for byte.

Modes of :func:`partial_psum`:

* ``unbiased``       — each shard's contribution enters the sum with
  probability p_s, scaled by 1/p_s: E[partial_psum(x)] = psum(x), the
  analogue of the paper's Binomial(K, 1/(d·p_s)) scatter marginal.
* ``error_feedback`` — contributions are masked without rescaling and the
  unsent part accumulates in a local residual added next round: biased a
  step, but after T rounds the synced mass is the produced mass less one
  residual.

Dropping a shard's contribution for a round is the same as not waiting for
that shard as a straggler; Theorem 1 prices it in.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch import prng
from repro_torch.distributed.runtime import ShardMesh


def _tree_map(fn: Callable, x: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of a tensor, dict, list or tuple tree (the
    reference's pytrees)."""
    if isinstance(x, dict):
        return {k: _tree_map(fn, x[k], *(r[k] for r in rest)) for k in x}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, *leaves) for leaves in zip(x, *rest))
    return fn(x, *rest)


def _per_shard(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``v`` (one value a local shard) shaped to broadcast over ``a``."""
    return v.to(a.dtype).reshape((-1,) + (1,) * (a.dim() - 1))


def _shard_coin(key: torch.Tensor, p_s: float, mesh: ShardMesh
                ) -> torch.Tensor:
    """bool[S_local]: one Bernoulli(p_s) coin a shard, independent across
    shards (the key folded with the shard id) and across keys."""
    return prng.bernoulli(mesh.shard_key(key), p_s, ())


def partial_psum(x, mesh: ShardMesh, p_s: float, key: torch.Tensor,
                 mode: str = "unbiased", residual=None):
    """Randomly synchronized all-reduce over the mesh's shards.

    Args:
      x: a tensor tree of ``[S_local, ...]`` contributions, a shard a row.
      p_s: synchronization probability; 1.0 is the plain ``psum``.
      key: one key for every shard (folded with the shard id here).
      mode: ``"unbiased"`` | ``"error_feedback"``.
      residual: a tree like ``x``, the carried residual (error feedback).

    Returns:
      unbiased: the sum of the masked and rescaled contributions.
      error_feedback: ``(sum of the masked contributions, new residual)``.
    """
    if p_s >= 1.0:
        out = _tree_map(mesh.psum, x)
        return out if mode == "unbiased" else (out, residual)
    coin = _shard_coin(key, p_s, mesh)
    if mode == "unbiased":
        scale = coin.to(torch.float32) / torch.tensor(
            p_s, dtype=torch.float32, device=coin.device)
        return _tree_map(lambda a: mesh.psum(a * _per_shard(scale, a)), x)
    if mode == "error_feedback":
        if residual is None:
            residual = _tree_map(torch.zeros_like, x)
        msg = _tree_map(torch.add, x, residual)
        sent = _tree_map(lambda m: m * _per_shard(coin, m), msg)
        new_residual = _tree_map(torch.sub, msg, sent)
        # no rescaling: the residual already conserves mass over rounds
        return _tree_map(mesh.psum, sent), new_residual
    raise ValueError(f"unknown mode {mode!r}")


def partial_channel_mask(key: torch.Tensor, p_s: float, mesh: ShardMesh,
                         num_shards: int, force_one: bool = True
                         ) -> torch.Tensor:
    """bool[S_local, num_shards]: each local shard's per-destination
    channel coins, the engine's mirror-sync granularity. With
    ``force_one`` (Example 10) a shard whose coins all came up tails opens
    one uniformly drawn channel, so none is ever cut off."""
    ks = prng.split(mesh.shard_key(key))
    k_coin, k_force = ks[:, 0], ks[:, 1]
    coins = prng.bernoulli(k_coin, p_s, (num_shards,))
    if p_s >= 1.0:
        return torch.ones_like(coins)
    if force_one:
        forced = prng.randint(k_force, (), 0, num_shards)
        all_closed = ~coins.any(-1)
        chan = torch.arange(num_shards, device=coins.device)
        coins = coins | (all_closed[:, None] & (chan == forced[:, None]))
    return coins


def partial_all_to_all(x: torch.Tensor, mesh: ShardMesh, p_s: float,
                       key: torch.Tensor, num_shards: int,
                       compensate: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-masked all-to-all: ``x[s, d]`` (``[S_local, num_shards,
    ...]``) goes from shard ``s`` to shard ``d`` when that channel opened
    (probability p_s), scaled by 1/p_s under ``compensate``; a closed
    channel moves zeros. Returns (the received blocks, the mask used)."""
    coins = partial_channel_mask(key, p_s, mesh, num_shards)
    scale = coins.to(x.dtype)
    if p_s < 1.0 and compensate:
        scale = scale / torch.tensor(p_s, dtype=x.dtype, device=x.device)
    shaped = scale.reshape(coins.shape + (1,) * (x.dim() - 2))
    return mesh.all_to_all(x * shaped), coins
