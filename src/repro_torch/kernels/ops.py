"""Wrappers over the port's four CUDA kernels (port of the matching
wrappers in ``repro/kernels/ops.py``).

Same signatures and semantics as the reference: natural shapes, int32 slot
bits taken as ``abs(bits)`` (inside the kernel, so no extra pass),
``die`` / ``stop`` cast to int32, and ``frog_count`` ignoring bins outside
``[0, n)``. ``impl`` picks the backend:

* ``"auto"``  — the CUDA kernel for CUDA tensors, the plain version
  (``ref.py``) for CPU tensors;
* ``"cuda"``  — the CUDA kernel; CPU tensors raise;
* ``"torch"`` — the plain version on any device.

A CUDA tensor never falls back to the plain version: the kernel launches
or the wrapper raises. Each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else, so a run can show which kernels its
path went through (:func:`reset_launch_counts`, :func:`launch_counts`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import KERNEL_IMPLS as IMPLS
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

LAUNCHES: Dict[str, int] = {"frog_step": 0, "frog_count": 0,
                            "stitch_gather": 0, "stitch_step": 0}


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _use_kernel(name: str, impl: str, *tensors: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"{name}: impl must be one of {IMPLS}, got {impl!r}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(
                f"{name}: operands on {t.device} and {dev}; move them to one "
                f"device")
    if impl == "torch":
        return False
    if dev.type == "cuda":
        return True
    if impl == "cuda":
        raise ValueError(f"{name}: impl='cuda' needs CUDA tensors, got "
                         f"{dev}")
    return False


def _check_i32(name: str, arg: str, t: torch.Tensor, ndim: int = 1,
               numel: Optional[int] = None) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {arg} must be {ndim}-D, got shape "
                         f"{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: {arg} has {t.numel()} elements, wanted "
                         f"{numel}")


def _launch(name: str, device: torch.device, *args) -> None:
    lib = build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, "fw_" + name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1


def frog_step(pos: torch.Tensor, die: torch.Tensor, bits: torch.Tensor,
              row_ptr: torch.Tensor, col_idx: torch.Tensor,
              deg: torch.Tensor, n: int, impl: str = "auto"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused plain walker superstep → ``(next_pos int32[N], death_counts
    int32[n])``."""
    name = "frog_step"
    use = _use_kernel(name, impl, pos, die, bits, row_ptr, col_idx, deg)
    die = die.to(torch.int32).contiguous()
    N = pos.shape[0]
    _check_i32(name, "pos", pos)
    _check_i32(name, "die", die, numel=N)
    _check_i32(name, "bits", bits, numel=N)
    _check_i32(name, "row_ptr", row_ptr, numel=n + 1)
    _check_i32(name, "deg", deg, numel=n)
    _check_i32(name, "col_idx", col_idx)
    if not use:
        return kref.frog_step_ref(pos, die, torch.abs(bits), row_ptr,
                                  col_idx, deg, n)
    nxt = torch.empty_like(pos)
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    if N:
        _launch(name, pos.device, pos.data_ptr(), die.data_ptr(),
                bits.data_ptr(), row_ptr.data_ptr(), col_idx.data_ptr(),
                deg.data_ptr(), nxt.data_ptr(), counts.data_ptr(), N)
    return nxt, counts


def frog_count(dest: torch.Tensor, n: int, impl: str = "auto"
               ) -> torch.Tensor:
    """Histogram of frog destinations into ``n`` int32 bins; entries
    outside ``[0, n)`` never count."""
    name = "frog_count"
    use = _use_kernel(name, impl, dest)
    _check_i32(name, "dest", dest)
    if not use:
        return kref.frog_count_ref(dest, n)
    counts = torch.zeros(n, dtype=torch.int32, device=dest.device)
    if dest.numel():
        _launch(name, dest.device, dest.data_ptr(), counts.data_ptr(),
                dest.numel(), n)
    return counts


def stitch_gather(pos: torch.Tensor, bits: torch.Tensor,
                  endpoints: torch.Tensor, impl: str = "auto"
                  ) -> torch.Tensor:
    """Gather-only stitch round: ``next = endpoints[pos, abs(bits) % R]``
    (int32[W]) against the ``int32[n, R]`` slab."""
    name = "stitch_gather"
    use = _use_kernel(name, impl, pos, bits, endpoints)
    _check_i32(name, "pos", pos)
    _check_i32(name, "bits", bits, numel=pos.shape[0])
    _check_i32(name, "endpoints", endpoints, ndim=2)
    if not use:
        return kref.stitch_gather_ref(pos, torch.abs(bits), endpoints)
    nxt = torch.empty_like(pos)
    if pos.numel():
        _launch(name, pos.device, pos.data_ptr(), bits.data_ptr(),
                endpoints.data_ptr(), nxt.data_ptr(), pos.numel(),
                endpoints.shape[1])
    return nxt


def stitch_step(pos: torch.Tensor, stop: torch.Tensor, bits: torch.Tensor,
                endpoints: torch.Tensor, n: int, impl: str = "auto",
                tally: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused stitch round → ``(next_pos int32[W], stop_counts int32[n])``.

    ``tally=False`` runs the gather-only kernel and returns
    ``(next_pos, None)``, byte-identical positions, as the reference does.
    """
    if not tally:
        return stitch_gather(pos, bits, endpoints, impl=impl), None
    name = "stitch_step"
    use = _use_kernel(name, impl, pos, stop, bits, endpoints)
    stop = stop.to(torch.int32).contiguous()
    W = pos.shape[0]
    _check_i32(name, "pos", pos)
    _check_i32(name, "stop", stop, numel=W)
    _check_i32(name, "bits", bits, numel=W)
    _check_i32(name, "endpoints", endpoints, ndim=2)
    if not use:
        return kref.stitch_step_ref(pos, stop, torch.abs(bits), endpoints, n)
    nxt = torch.empty_like(pos)
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    if W:
        _launch(name, pos.device, pos.data_ptr(), stop.data_ptr(),
                bits.data_ptr(), endpoints.data_ptr(), nxt.data_ptr(),
                counts.data_ptr(), W, endpoints.shape[1])
    return nxt, counts
