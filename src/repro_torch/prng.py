"""Threefry-2x32 keys and draws, bit for bit as ``jax.random`` computes them.

The reference draws every random number with ``jax.random`` under
``jax_threefry_partitionable=True`` (jax 0.9.0). Whole answers of the port
match the reference byte for byte only if these streams do, so this module
reimplements the pieces the reference uses:

* ``PRNGKey(seed)``         — ``[0, seed mod 2**32]``;
* ``split(key, num)``       — ``threefry(key, (0, i))`` for ``i < num``;
* ``fold_in(key, data)``    — ``threefry(key, (0, data))``, scalar or one
  key per element of a data tensor (the reference's ``vmap``);
* ``random_bits(key, shape)`` — ``y1 ^ y2`` of ``threefry(key, (i >> 32,
  i & M))`` over the flat index ``i``;
* ``randint`` (two bit streams from ``split(key)``, combined modulo the
  span), ``uniform`` (the mantissa trick) and ``bernoulli``;
* ``gumbel`` (the default ``"low"`` mode: ``-log(-log(u))`` of a uniform
  on ``[tiny, 1)``) and ``categorical`` (the Gumbel-max trick), which the
  LM stack's sampling draws.

A key is a ``uint32[..., 2]`` value held as an int64 tensor on the key's
device; leading dimensions batch independent keys, and every draw then
gains those dimensions in front.

Each draw takes ``impl``, as the kernel wrappers do: ``"auto"`` launches
the draw's kernel (``kernels/csrc/threefry_draw.cu``, one launch a draw,
the key read on the card) for a CUDA key and runs the plain torch version
for a CPU key; ``"cuda"`` launches the kernel and raises for a CPU key;
``"torch"`` runs the plain version on any device. ``impl=None`` takes the
block's default (:func:`draw_impl`, ``"auto"`` outside one). A failed
build or launch raises; nothing falls back. The plain version does its
uint32 arithmetic in int64 and masks it back to 32 bits, some hundred
elementwise launches a draw on the card.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch

from repro_torch.config import KERNEL_IMPLS as IMPLS
from repro_torch.device import DeviceLike, resolve_device

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
Shape = Union[int, Sequence[int]]
_DRAW_IMPL = contextvars.ContextVar("repro_torch_draw_impl", default="auto")


def _check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


@contextlib.contextmanager
def draw_impl(impl: str) -> Iterator[None]:
    """Within the block (and its thread or task), draws called with
    ``impl=None`` take ``impl``; ``draw_impl("torch")`` runs a whole path's
    draws through the plain version, as a plain run of a service does."""
    token = _DRAW_IMPL.set(_check_impl(impl))
    try:
        yield
    finally:
        _DRAW_IMPL.reset(token)


def _on_card(name: str, key: torch.Tensor, impl: Optional[str]) -> bool:
    """Whether ``name`` launches its kernel for ``key`` under ``impl``."""
    impl = _check_impl(_DRAW_IMPL.get() if impl is None else impl)
    _halves(key)
    if impl == "torch":
        return False
    if key.device.type == "cuda":
        return True
    if impl == "cuda":
        raise ValueError(f"{name}: impl='cuda' needs a CUDA key, got "
                         f"{key.device}")
    return False


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s)
                                                             for s in shape)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcast int64 operands holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def _halves(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise TypeError(
            f"a key is an int64[..., 2] tensor of uint32 values, got "
            f"{key.dtype}{list(key.shape)}")
    return key[..., 0], key[..., 1]


def PRNGKey(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (the reference's
    mode): the seed wraps to 32 bits, so the key is ``[0, seed mod 2**32]``.
    """
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def wrap_key_data(data, device: DeviceLike = None) -> torch.Tensor:
    """A key from raw ``uint32[..., 2]`` data (a numpy array, a list or a
    tensor); values outside ``[0, 2**32)`` raise."""
    if isinstance(data, torch.Tensor):
        t = data.to(torch.int64)
        if device is not None:
            t = t.to(resolve_device(device))
    else:
        t = torch.as_tensor(data, dtype=torch.int64,
                            device=resolve_device(device))
    if t.shape[-1:] != (2,):
        raise ValueError(f"key data must end in a dimension of 2, got "
                         f"{list(t.shape)}")
    if t.numel() and (int(t.min()) < 0 or int(t.max()) > _M32):
        raise ValueError("key data must be uint32 values")
    return t


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The raw ``uint32[..., 2]`` words of ``key`` (as int64)."""
    _halves(key)
    return key


def split(key: torch.Tensor, num: int = 2, impl: Optional[str] = None
          ) -> torch.Tensor:
    """``jax.random.split``: ``[..., num, 2]`` new keys."""
    if _on_card("split", key, impl):
        from repro_torch.kernels import draw
        return draw.split(key, num)
    return _split(key, num)


def _split(key: torch.Tensor, num: int) -> torch.Tensor:
    k1, k2 = _halves(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(i),
                          i)
    return torch.stack([y1, y2], dim=-1)


def fold_in(key: torch.Tensor, data, impl: Optional[str] = None
            ) -> torch.Tensor:
    """``jax.random.fold_in``. ``data`` is a Python int (one new key per
    key) or an integer tensor broadcast against the key's batch shape
    (the reference's ``vmap`` of a scalar fold over vertices or keys)."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=key.device)
    else:
        data = int(data)
    if _on_card("fold_in", key, impl):
        from repro_torch.kernels import draw
        return draw.fold_in(key, data)
    k1, k2 = _halves(key)
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & _M32
    else:
        d = torch.tensor(data & _M32, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape: Shape, impl: Optional[str] = None
                ) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: ``int64[*batch, *shape]`` of uint32
    values, one counter per flat output index."""
    shape = _shape(shape)
    if _on_card("random_bits", key, impl):
        from repro_torch.kernels import draw
        return draw.bits(key, shape)
    return _bits(key, shape)


def _bits(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    k1, k2 = _halves(key)
    size = math.prod(shape)
    i = torch.arange(size, dtype=torch.int64, device=key.device)
    batch = k1.dim()
    k1 = k1.reshape(k1.shape + (1,))
    k2 = k2.reshape(k2.shape + (1,))
    y1, y2 = threefry2x32(k1, k2, i >> 32, i & _M32)
    out = y1 ^ y2
    return out.reshape(key.shape[:batch] + shape)


def randint_span(minval: int, maxval: int) -> Tuple[int, int, int]:
    """``(lo, span, mult)`` of ``randint(., minval, maxval)``: the span
    ``maxval − minval`` taken in uint32 (1 when ``maxval ≤ minval``) and
    ``2**32 mod span`` as the reference computes it in uint32: the square
    wraps to 0 once span exceeds 2**16, and then only the low stream
    counts."""
    lo, hi = int(minval), int(maxval)
    if not (-(1 << 31) <= lo and hi <= (1 << 31) - 1):
        raise ValueError(f"randint bounds [{lo}, {hi}) exceed int32")
    span = 1 if hi <= lo else (hi - lo) & _M32
    mult = (1 << 16) % span
    return lo, span, ((mult * mult) & _M32) % span


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            impl: Optional[str] = None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: a high and
    a low 32-bit stream from ``split(key)`` reduced modulo the span with
    uint32 wraparound, exactly as ``jax._src.random._randint`` does."""
    shape = _shape(shape)
    lo, span, mult = randint_span(minval, maxval)
    if _on_card("randint", key, impl):
        from repro_torch.kernels import draw
        return draw.randint(key, shape, lo, span, mult)
    keys = _split(key, 2)
    higher = _bits(keys[..., 0, :], shape)
    lower = _bits(keys[..., 1, :], shape)
    off = (((higher % span) * mult) & _M32) + (lower % span)
    off = (off & _M32) % span
    return (lo + off).to(torch.int32)


def _uniform(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    bits = _bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape: Shape, impl: Optional[str] = None
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on ``[0, 1)``: the top
    23 bits as the mantissa of a float in ``[1, 2)``, minus 1."""
    shape = _shape(shape)
    if _on_card("uniform", key, impl):
        from repro_torch.kernels import draw
        return draw.uniform(key, shape)
    return _uniform(key, shape)


def bernoulli(key: torch.Tensor, p: float, shape: Shape,
              impl: Optional[str] = None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < float32(p)``."""
    shape = _shape(shape)
    if _on_card("bernoulli", key, impl):
        from repro_torch.kernels import draw
        return draw.bernoulli(key, p, shape)
    u = _uniform(key, shape)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


_F32_TINY = float(torch.finfo(torch.float32).tiny)


def gumbel(key: torch.Tensor, shape: Shape, impl: Optional[str] = None
           ) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32, the default ``"low"``
    mode: ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)`` computed as
    the reference does (``max(tiny, f · (1 − tiny) + tiny)``, where ``f``
    is the mantissa draw on ``[0, 1)``; ``1 − tiny`` is 1 in float32).
    torch's ``log`` and XLA's may differ in the last bit."""
    u = torch.clamp_min(uniform(key, shape, impl) + _F32_TINY, _F32_TINY)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis:
    ``argmax(logits + gumbel(key, logits.shape))`` (int64)."""
    g = gumbel(key, tuple(logits.shape), impl)
    return torch.argmax(g + logits, dim=-1)
