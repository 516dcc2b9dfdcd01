"""Wrappers over the threefry draw kernels (``csrc/threefry_draw.cu``).

``repro_torch.prng`` calls these for a CUDA key (``impl="auto"`` or
``"cuda"``): each draw is one launch, counted in ``ops.LAUNCHES`` under
``threefry_bits``, ``threefry_randint``, ``threefry_uniform``,
``threefry_bernoulli``, ``threefry_split`` or ``threefry_fold_in``, and
gives the same tensor as ``prng``'s plain version (the same dtype, shape
and bytes). ``prng`` routes only CUDA keys here; a launch raises where the
kernel library cannot be built or the card refuses it. The key is read by
the kernel from device memory, so a draw never reads anything back to the
host. An empty draw launches nothing.

No TPU kernel is replaced: the reference draws with ``jax.random``, which
XLA fuses into one pass a draw.
"""
from __future__ import annotations

import math
import struct
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops

_M32 = 0xFFFFFFFF
FOLD_IN_DTYPES = (torch.int32, torch.int64)


def _keys(key: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...], int]:
    """``(contiguous key words, batch shape, number of keys)``."""
    batch = tuple(key.shape[:-1])
    return key.contiguous(), batch, math.prod(batch)


def _draw(name: str, key: torch.Tensor, shape: Tuple[int, ...],
          dtype: torch.dtype, *args) -> torch.Tensor:
    k, batch, nkeys = _keys(key)
    out = torch.empty(batch + shape, dtype=dtype, device=key.device)
    if out.numel():
        ops._launch(name, key.device, k.data_ptr(), out.data_ptr(), nkeys,
                    math.prod(shape), *args)
    return out


def bits(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``prng.random_bits``: int64[*batch, *shape] of uint32 values."""
    return _draw("threefry_bits", key, shape, torch.int64)


def randint(key: torch.Tensor, shape: Tuple[int, ...], lo: int, span: int,
            mult: int) -> torch.Tensor:
    """``prng.randint`` with ``(lo, span, mult)`` from
    ``prng.randint_span``: int32[*batch, *shape]."""
    return _draw("threefry_randint", key, shape, torch.int32, lo, span,
                 mult)


def uniform(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``prng.uniform``: float32[*batch, *shape] on [0, 1)."""
    return _draw("threefry_uniform", key, shape, torch.float32)


def bernoulli(key: torch.Tensor, p: float, shape: Tuple[int, ...]
              ) -> torch.Tensor:
    """``prng.bernoulli``: bool[*batch, *shape], ``uniform < p`` with ``p``
    rounded to float32 here, on the host."""
    p32 = struct.unpack("f", struct.pack("f", float(p)))[0]
    return _draw("threefry_bernoulli", key, shape, torch.bool, p32)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``prng.split``: int64[*batch, num, 2] keys."""
    if not 0 <= num <= _M32:
        raise ValueError(f"split: num must be in [0, 2**32), got {num}")
    k, batch, nkeys = _keys(key)
    out = torch.empty(batch + (num, 2), dtype=torch.int64, device=key.device)
    if out.numel():
        ops._launch("threefry_split", key.device, k.data_ptr(),
                    out.data_ptr(), nkeys, num)
    return out


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """``prng.fold_in``: int64[*broadcast, 2] keys, ``data`` a Python int
    or an integer tensor on the key's device, broadcast against the key's
    batch shape. A key and data each of one value or of the broadcast
    shape are read as they lie (int32 or int64 data); other shapes are
    expanded, and other integer types widened, before the launch."""
    k, batch, nkeys = _keys(key)
    if not isinstance(data, torch.Tensor):
        out = torch.empty(batch + (2,), dtype=torch.int64, device=key.device)
        if nkeys:
            ops._launch("threefry_fold_in", key.device, k.data_ptr(), 1,
                        None, 0, 8, int(data) & _M32, out.data_ptr(), nkeys)
        return out
    # numpy's, not torch.broadcast_shapes, whose first call imports
    # torch's reference ops (seconds on the card's host)
    shape = tuple(np.broadcast_shapes(batch, tuple(data.shape)))
    if nkeys != 1 and batch != shape:
        k = k.expand(shape + (2,)).contiguous()
    d = data if data.dtype in FOLD_IN_DTYPES else data.to(torch.int64)
    if d.numel() != 1 and tuple(d.shape) != shape:
        d = d.expand(shape)
    d = d.contiguous()
    out = torch.empty(shape + (2,), dtype=torch.int64, device=key.device)
    if out.numel():
        ops._launch("threefry_fold_in", key.device, k.data_ptr(),
                    int(k.numel() != 2), d.data_ptr(), int(d.numel() != 1),
                    d.element_size(), 0, out.data_ptr(), out.numel() // 2)
    return out
