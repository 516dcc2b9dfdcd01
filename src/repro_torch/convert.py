"""Carries the reference package's state across through numpy.

The reference (``repro``) hands out graphs, walk-index slabs and PRNG keys
as JAX arrays; ``np.asarray`` of them gives plain arrays, and these helpers
turn those into the port's objects, so both packages compute on the same
graph, slab and key.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.csr import CSRGraph, _from_arrays
from repro_torch.query.index import WalkIndex


def graph_from_numpy(n: int, row_ptr, col_idx, epoch: int = 0,
                     mutation_offset: int = 0,
                     device: DeviceLike = "cpu") -> CSRGraph:
    """A CSRGraph from ``row_ptr`` / ``col_idx`` arrays (degrees
    re-derived), on ``device``."""
    row_ptr = np.asarray(row_ptr)
    if row_ptr.shape != (int(n) + 1,):
        raise ValueError(f"row_ptr has shape {row_ptr.shape}, wanted "
                         f"({int(n) + 1},)")
    return _from_arrays(n, row_ptr, np.asarray(col_idx), epoch,
                        mutation_offset).to(device)


def walk_index_from_numpy(endpoints, segment_len: int, seed: int,
                          graph_epoch: int = 0, mutation_offset: int = 0,
                          device: DeviceLike = "cpu") -> WalkIndex:
    """A WalkIndex from an ``int[n, R]`` endpoint slab, on ``device``."""
    ep = np.asarray(endpoints)
    if ep.ndim != 2:
        raise ValueError(f"endpoints must be [n, R], got shape {ep.shape}")
    return WalkIndex(
        endpoints=torch.from_numpy(ep.astype(np.int32)).to(
            resolve_device(device)),
        segment_len=int(segment_len), seed=int(seed),
        graph_epoch=int(graph_epoch), mutation_offset=int(mutation_offset))


def key_from_jax(key_data, device: DeviceLike = "cpu") -> torch.Tensor:
    """The port's key for the reference key whose ``jax.random.key_data``
    (``uint32[..., 2]``) is given."""
    return prng.wrap_key_data(np.asarray(key_data).astype(np.int64), device)
