"""Wrappers over the port's CUDA kernels (port of the matching wrappers in
``repro/kernels/ops.py``).

Same signatures and semantics as the reference: natural shapes, int32 slot
bits taken as ``abs(bits)`` (inside the kernel, so no extra pass),
``die`` / ``stop`` cast to int32, and ``frog_count`` ignoring bins outside
``[0, n)``; ``spmv`` is the hybrid ELL product, the slab through its
kernel and the COO spill tail added with ``index_add_``.
``stitch_gather_rounds`` is ``stitch_gather``'s kernel redesigned for a
whole wave: every stitch round of the wave in one launch;
``stitch_gather_local_rounds`` is ``stitch_gather_local``'s, the loop
wave's rounds over every shard's block (read through a
:class:`BlockTable`), and ``stitch_step_rounds`` is ``stitch_step``'s,
``walk_wave``'s rounds and their stop tally. ``impl`` picks the backend:

* ``"auto"``  — the CUDA kernel for CUDA tensors, the plain version
  (``ref.py``) for CPU tensors;
* ``"cuda"``  — the CUDA kernel; CPU tensors raise;
* ``"torch"`` — the plain version on any device.

``frog_step`` also takes ``"stream"``: the streamed superstep (sort by
vertex, ``frog_step_stream_sorted`` over the :class:`BlockedCSR` slabs,
unsort), whose kernel runs for CUDA tensors and whose plain version runs
for CPU tensors. The reference switches to it when the graph outgrows the
TPU core's VMEM; the card has no such budget, so ``"auto"`` stays on the
resident kernel and ``"stream"`` is asked for by name.

``frog_superstep`` and ``frog_hop`` are the walker step with its draws:
a whole superstep of the batch walk and a hop of the index build, in
place. They are the reference's ``frog_step`` under ``rng="device"``,
drawing the reference's own threefry streams inside the kernel (one
launch a superstep or hop, and the sort before it under ``"stream"``);
``frog_step`` stays its ``rng="caller"`` contract, bits from the caller.
A hop also writes the segments' visited-block masks when given a
``visited`` operand (the reference builds them in XLA around its step).
``frog_segment_walk`` is ``frog_hop``'s kernel redesigned for a whole
segment walk: all L hops and their masks in one launch, as the index
build, repair and refresh run it; under ``"stream"`` its L sorted hops
store their positions into a trail and ``frog_segment_masks`` writes the
masks from it in one pass.

The stitch wrappers take ``rng``, the reference's mode: ``"caller"``
(default) passes the slot bits (``bits`` / ``s0``, int32[W]);
``"device"`` passes the wave's key (an int64[2] key on the walks' device)
in their place, and walk ``w``'s bits are ``randint(key, (W,), 0,
2**30)[w]``, drawn in the kernel from the reference's own threefry
stream, so the two modes give the same bytes. Their plain versions draw
the bits through ``ref.slot_bits`` and run the caller-mode oracle.

``attention`` also takes ``"ref"`` (the O(S²)-memory oracle); its
``"torch"`` is the plain chunked version. Under autograd it runs an
autograd Function whose forward also writes the rows' log-sum-exp and
whose backward is :func:`attention_bwd` (the ``flash_attention_bwd``
kernel on CUDA tensors), so no kernel output on the card lacks autograd
history. The scans do the same: under autograd their forwards also
write the state before every 32-step chunk, and their backwards are
:func:`wkv6_scan_bwd` and :func:`ssd_scan_bwd` (the ``wkv6_scan_bwd`` and
``ssd_scan_bwd`` kernels on CUDA tensors). The ELL slab product has no
backward (nor has the reference's kernel): on CUDA tensors it raises
under autograd.

``wkv6_scan`` and ``ssd_scan`` are the port's own kernels for the RWKV-6
and Mamba-2 time recurrences, which the reference runs as ``lax.scan``
(no Pallas kernel): the whole sequence, prefill or one decode step, in
one launch; their plain versions are the reference's step functions
looped over time.

A CUDA tensor never falls back to the plain version: the kernel launches
or the wrapper raises. Each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else, so a run can show which kernels its
path went through (:func:`reset_launch_counts`, :func:`launch_counts`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.config import KERNEL_IMPLS as IMPLS
from repro_torch.graph.partition import EllGraph
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.frog_step_stream import BlockedCSR, block_csr

LAUNCHES: Dict[str, int] = {"frog_step": 0, "frog_count": 0,
                            "stitch_gather": 0, "stitch_step": 0,
                            "stitch_gather_rounds": 0,
                            "stitch_step_rounds": 0,
                            "stitch_gather_local": 0, "stitch_step_local": 0,
                            "stitch_gather_local_rounds": 0,
                            "frog_step_stream_sorted": 0,
                            "frog_superstep": 0, "frog_hop": 0,
                            "frog_segment_walk": 0, "frog_segment_masks": 0,
                            "frog_superstep_stream_sorted": 0,
                            "frog_hop_stream_sorted": 0,
                            "spmv_ell_slab": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0,
                            "wkv6_scan": 0, "ssd_scan": 0,
                            "wkv6_scan_bwd": 0, "ssd_scan_bwd": 0,
                            "threefry_bits": 0, "threefry_randint": 0,
                            "threefry_uniform": 0, "threefry_bernoulli": 0,
                            "threefry_split": 0, "threefry_fold_in": 0}
# the draw kernels (``kernels/draw.py``, called by ``prng``)
DRAW_KERNELS = tuple(k for k in LAUNCHES if k.startswith("threefry_"))
RNG_MODES = ("caller", "device")

# Frogs per CTA work item of the streamed superstep.
STREAM_FROG_BLOCK = 1024
# Largest col slab a streamed launch stages in shared memory; a graph
# whose E_blk·4 exceeds it (a hub block) reads col from device memory, as
# does a launch whose frogs average fewer than E_blk / 8 per vertex block
# (csrc/frog_step_stream.cu says why).
STREAM_SMEM_COL_BYTES = 96 * 1024


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, BWD_ROUTES):
        for k in counts:
            counts[k] = 0


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


def _grad_wanted(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records a call on these inputs (grad mode on and
    one of them requiring grad)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _refuse_autograd(name: str, why: str,
                     *tensors: Optional[torch.Tensor]) -> None:
    """A kernel without a backward, called under grad mode with an input
    that requires grad, raises (``why`` says what is missing) rather than
    return an output without autograd history."""
    if _grad_wanted(*tensors):
        raise NotImplementedError(
            f"{name}: the kernel has no backward{why}. Run under "
            f"torch.no_grad() or with impl='torch'")


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


def _slot_operand(name: str, arg: str, t: torch.Tensor, W: int,
                  rng: str) -> None:
    """Checks a stitch wrapper's bits operand: int32[W] bits under
    ``rng="caller"``, an int64[2] key under ``"device"``."""
    if rng not in RNG_MODES:
        raise ValueError(f"{name}: rng must be one of {RNG_MODES}, got "
                         f"{rng!r}")
    if rng == "device":
        _check_keys(name, "key", t, (2,))
    else:
        _check_i32(name, arg, t, numel=W)


def _plain_bits(t: torch.Tensor, W: int, rng: str) -> torch.Tensor:
    """The plain version's slot bits: the caller's, or the key's."""
    return kref.slot_bits(t, W) if rng == "device" else t


def _bits_ptrs(t: torch.Tensor, rng: str) -> Tuple[Optional[int],
                                                    Optional[int]]:
    """``(bits pointer, key pointer)`` of a stitch kernel: one is null."""
    return (None, t.data_ptr()) if rng == "device" else (t.data_ptr(), None)


def _launch(name: str, device: torch.device, *args) -> None:
    """Calls ``fw_<name>`` on the device's current stream. The device is
    made current only when it is not already: the runtime launches on the
    current device, and switching it costs more than the launch."""
    fn = getattr(build.library(), "fw_" + name)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1


def frog_step(pos: torch.Tensor, die: torch.Tensor, bits: torch.Tensor,
              row_ptr: torch.Tensor, col_idx: torch.Tensor,
              deg: torch.Tensor, n: int, impl: str = "auto",
              blocked: Optional[BlockedCSR] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused plain walker superstep → ``(next_pos int32[N], death_counts
    int32[n])``. ``impl="stream"`` runs the streamed superstep over
    ``blocked`` (built here from the CSR when not given; callers that step
    many times pass it in)."""
    if impl == "stream":
        return _frog_step_stream(pos, die, bits, row_ptr, col_idx, deg, n,
                                 blocked)
    name = "frog_step"
    use = _use_kernel(name, impl, pos, die, bits, row_ptr, col_idx, deg)
    die = die.to(torch.int32).contiguous()
    N = pos.shape[0]
    _check_i32(name, "pos", pos)
    _check_i32(name, "die", die, numel=N)
    _check_i32(name, "bits", bits, numel=N)
    _check_graph(name, row_ptr, col_idx, deg, n)
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
                  endpoints: torch.Tensor, impl: str = "auto",
                  rng: str = "caller") -> torch.Tensor:
    """Gather-only stitch round: ``next = endpoints[pos, abs(bits) % R]``
    (int32[W]) against the ``int32[n, R]`` slab; ``bits`` is the key under
    ``rng="device"``."""
    name = "stitch_gather"
    use = _use_kernel(name, impl, pos, bits, endpoints)
    W = pos.shape[0]
    _check_i32(name, "pos", pos)
    _slot_operand(name, "bits", bits, W, rng)
    _check_i32(name, "endpoints", endpoints, ndim=2)
    if not use:
        return kref.stitch_gather_ref(
            pos, torch.abs(_plain_bits(bits, W, rng)), endpoints)
    nxt = torch.empty_like(pos)
    if W:
        _launch(name, pos.device, pos.data_ptr(), *_bits_ptrs(bits, rng),
                endpoints.data_ptr(), nxt.data_ptr(), W, endpoints.shape[1])
    return nxt


def stitch_gather_rounds(pos: torch.Tensor, q: torch.Tensor,
                         s0: torch.Tensor, slab: torch.Tensor, q_max: int,
                         lost: Optional[torch.Tensor] = None, S: int = 1,
                         sz: int = 0, impl: str = "auto",
                         rng: str = "caller"
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A wave's ``q_max`` stitch rounds in one launch → ``(pos int32[W],
    alive bool[W] or None)``.

    Round ``j`` moves the walks with ``j < q`` to ``slab[pos, abs(s0 + j)
    % R]`` (``s0 + j`` wrapping as an int32 add does) against the ``int32[
    rows, R]`` slab. With ``lost`` (bool[S]), a walk that still needs a
    gather while sitting in a lost shard's rows (shard ``clip(pos // sz,
    0, S − 1)``), or whose final vertex lies in one, dies and keeps its
    position; ``alive`` marks the others. Without it every walk lives and
    ``alive`` is ``None``. The same bytes as ``q_max`` rounds of
    :func:`stitch_gather` and ``torch.where``. Under ``rng="device"``
    ``s0`` is the wave's key and the kernel draws ``s0 = randint(key,
    (W,), 0, 2**30)`` itself."""
    name = "stitch_gather_rounds"
    masked = lost is not None
    use = _use_kernel(name, impl, pos, q, s0, slab,
                      *((lost,) if masked else ()))
    W = pos.shape[0]
    _check_i32(name, "pos", pos)
    _check_i32(name, "q", q, numel=W)
    _slot_operand(name, "s0", s0, W, rng)
    _check_i32(name, "slab", slab, ndim=2)
    if not 0 <= q_max < 2 ** 31:
        raise ValueError(f"{name}: q_max must be in [0, 2**31), got {q_max}")
    if masked and (lost.dtype != torch.bool or lost.dim() != 1
                   or not lost.is_contiguous() or lost.numel() != S
                   or not 1 <= sz < 2 ** 31):
        raise ValueError(f"{name}: lost must be a contiguous bool[S = {S}] "
                         f"and sz ≥ 1, got {lost.dtype} "
                         f"{list(lost.shape)} and sz = {sz}")
    if not use:
        return kref.stitch_gather_rounds_ref(
            pos, q, _plain_bits(s0, W, rng), slab, q_max, lost, S, sz)
    nxt = torch.empty_like(pos)
    alive = torch.empty(W, dtype=torch.bool, device=pos.device) \
        if masked else None
    if W:
        _launch(name, pos.device, pos.data_ptr(), q.data_ptr(),
                *_bits_ptrs(s0, rng), slab.data_ptr(),
                lost.data_ptr() if masked else None, nxt.data_ptr(),
                alive.data_ptr() if masked else None, W, slab.shape[1],
                int(q_max), int(S), int(sz))
    return nxt, alive


def stitch_step(pos: torch.Tensor, stop: torch.Tensor, bits: torch.Tensor,
                endpoints: torch.Tensor, n: int, impl: str = "auto",
                tally: bool = True, rng: str = "caller"
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused stitch round → ``(next_pos int32[W], stop_counts int32[n])``;
    ``bits`` is the key under ``rng="device"``.

    ``tally=False`` runs the gather-only kernel and returns
    ``(next_pos, None)``, byte-identical positions, as the reference does.
    """
    if not tally:
        return stitch_gather(pos, bits, endpoints, impl=impl, rng=rng), None
    name = "stitch_step"
    use = _use_kernel(name, impl, pos, stop, bits, endpoints)
    stop = stop.to(torch.int32).contiguous()
    W = pos.shape[0]
    _check_i32(name, "pos", pos)
    _check_i32(name, "stop", stop, numel=W)
    _slot_operand(name, "bits", bits, W, rng)
    _check_i32(name, "endpoints", endpoints, ndim=2)
    if not use:
        return kref.stitch_step_ref(
            pos, stop, torch.abs(_plain_bits(bits, W, rng)), endpoints, n)
    nxt = torch.empty_like(pos)
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    if W:
        _launch(name, pos.device, pos.data_ptr(), stop.data_ptr(),
                *_bits_ptrs(bits, rng), endpoints.data_ptr(), nxt.data_ptr(),
                counts.data_ptr(), W, endpoints.shape[1])
    return nxt, counts


def stitch_step_rounds(pos: torch.Tensor, q: torch.Tensor, s0: torch.Tensor,
                       endpoints: torch.Tensor, n: int, num_rounds: int,
                       impl: str = "auto", rng: str = "caller"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``walk_wave``'s ``num_rounds + 1`` stitch rounds and their stop
    tally in one launch → ``(pos int32[W], stop_counts int32[n])``.

    Round ``j`` tallies the walks with ``q == j`` at their current vertex
    and moves the walks with ``j < q`` to ``endpoints[pos, abs(s0 + j) %
    R]`` (``s0 + j`` wrapping as an int32 add does), so a walk is tallied
    once, at its final vertex; one with ``q > num_rounds`` takes
    ``num_rounds + 1`` gathers and is never tallied. The same bytes as
    ``num_rounds + 1`` rounds of :func:`stitch_step` and ``torch.where``.
    Under ``rng="device"`` ``s0`` is the key, as for
    :func:`stitch_gather_rounds`."""
    name = "stitch_step_rounds"
    use = _use_kernel(name, impl, pos, q, s0, endpoints)
    W = pos.shape[0]
    _check_i32(name, "pos", pos)
    _check_i32(name, "q", q, numel=W)
    _slot_operand(name, "s0", s0, W, rng)
    _check_i32(name, "endpoints", endpoints, ndim=2)
    if not (0 <= num_rounds < 2 ** 31 - 1 and 0 <= n < 2 ** 31):
        raise ValueError(f"{name}: num_rounds must be in [0, 2**31 - 1) and "
                         f"n in [0, 2**31), got {num_rounds} and {n}")
    if not use:
        return kref.stitch_step_rounds_ref(
            pos, q, _plain_bits(s0, W, rng), endpoints, n, num_rounds)
    nxt = torch.empty_like(pos)
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    if W:
        _launch(name, pos.device, pos.data_ptr(), q.data_ptr(),
                *_bits_ptrs(s0, rng), endpoints.data_ptr(), nxt.data_ptr(),
                counts.data_ptr(), W, endpoints.shape[1], int(num_rounds),
                int(n))
    return nxt, counts


def _sorted_runs(name: str, pos, row_ptr, col_idx, deg, n: int,
                 blocked: Optional[BlockedCSR]):
    """Stream-path prologue: ``(blocked, pos_s, order, seg_off,
    schedule)``, a stable sort of the frogs by vertex, each vertex block's
    run of sorted frogs (``seg_off``) and the kernel's work items. Runs are
    not padded; blocks no frog visits keep zero counts. ``blocked`` is
    built from the CSR when not given."""
    if blocked is None:
        blocked = block_csr(row_ptr, col_idx, deg, n)
    if blocked.n_pad < n:
        raise ValueError(f"{name}: the BlockedCSR covers {blocked.n_pad} "
                         f"vertices, the graph has {n}")
    _check_i32(name, "pos", pos)
    bv, num_vb = blocked.vertex_block, blocked.num_blocks
    pos_s, order = torch.sort(pos, stable=True)
    edges = torch.arange(num_vb + 1, dtype=torch.int32,
                         device=pos.device) * bv
    seg_off = torch.searchsorted(pos_s, edges, out_int32=True)
    return (blocked, pos_s, order, seg_off,
            stream_schedule(seg_off, pos.shape[0]))


def _frog_step_stream(pos, die, bits, row_ptr, col_idx, deg, n: int,
                      blocked: Optional[BlockedCSR]):
    """The streamed superstep: the sort (:func:`_sorted_runs`), the sorted
    kernel, and the unsort."""
    blocked, pos_s, order, seg_off, sched = _sorted_runs(
        "frog_step", pos, row_ptr, col_idx, deg, n, blocked)
    nxt_s, counts = frog_step_stream_sorted(
        pos_s, die.to(torch.int32)[order], bits[order], seg_off, sched,
        blocked)
    nxt = torch.empty_like(pos)
    nxt[order] = nxt_s
    return nxt, counts[:n]


def _stage_col(blocked: BlockedCSR, N: int) -> int:
    """Whether a streamed launch may stage its col slab in shared memory:
    the slab fits, and the frogs average at least ``E_blk / 8`` a block."""
    e_blk = blocked.e_blk
    return int(4 * e_blk <= STREAM_SMEM_COL_BYTES
               and 8 * N >= e_blk * blocked.num_blocks)


def frog_step_stream_sorted(pos: torch.Tensor, die: torch.Tensor,
                            bits: torch.Tensor, seg_off: torch.Tensor,
                            schedule: Tuple[int, torch.Tensor, torch.Tensor],
                            blocked: BlockedCSR, impl: str = "auto"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streamed superstep on frogs sorted by vertex, block ``v``'s run
    being ``seg_off[v] .. seg_off[v + 1]`` → ``(next int32[N], death_counts
    int32[n_pad])`` in the sorted order. ``schedule`` is
    :func:`stream_schedule` of ``seg_off``: the kernel's work items, which
    the plain version does not need."""
    name = "frog_step_stream_sorted"
    use = _use_kernel(name, impl, pos, die, bits, seg_off, *schedule[1:],
                      blocked.row_off, blocked.deg, blocked.col)
    die = die.to(torch.int32).contiguous()
    N = pos.shape[0]
    bv, num_vb, e_blk = (blocked.vertex_block, blocked.num_blocks,
                         blocked.e_blk)
    _check_i32(name, "pos", pos)
    _check_i32(name, "die", die, numel=N)
    _check_i32(name, "bits", bits, numel=N)
    _check_i32(name, "seg_off", seg_off, numel=num_vb + 1)
    for arg in ("row_off", "deg", "col"):
        _check_i32(name, arg, getattr(blocked, arg), ndim=2)
    if not use:
        return kref.frog_step_stream_sorted_ref(
            pos, die, torch.abs(bits), seg_off, blocked.row_off,
            blocked.deg, blocked.col)
    num_cta, cta_vid, cta_lo = schedule
    _check_i32(name, "cta_vid", cta_vid, numel=num_cta)
    _check_i32(name, "cta_lo", cta_lo, numel=num_cta)
    nxt = torch.empty_like(pos)
    counts = torch.zeros(num_vb * bv, dtype=torch.int32, device=pos.device)
    if N:
        _launch(name, pos.device, pos.data_ptr(), die.data_ptr(),
                bits.data_ptr(), cta_vid.data_ptr(), cta_lo.data_ptr(),
                seg_off.data_ptr(), blocked.row_off.data_ptr(),
                blocked.deg.data_ptr(), blocked.col.data_ptr(),
                nxt.data_ptr(), counts.data_ptr(), num_cta, num_vb, bv,
                e_blk, STREAM_FROG_BLOCK, _stage_col(blocked, N))
    return nxt, counts


def stream_schedule(seg_off: torch.Tensor, N: int,
                    fb: int = STREAM_FROG_BLOCK
                    ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """The streamed kernel's CTA work items: each block's run of sorted
    frogs cut into pieces of at most ``fb`` frogs → ``(num_cta, cta_vid
    int32[num_cta], cta_lo int32[num_cta])``, item ``c`` covering frogs
    ``cta_lo[c] .. min(cta_lo[c] + fb, seg_off[v + 1])`` of block ``v =
    cta_vid[c]``. ``num_cta`` is the bound ``ceil(N / fb) + min(num_vb,
    N)``, so nothing is read back to the host; the spare items carry
    ``cta_vid = num_vb`` and do nothing."""
    num_vb = seg_off.shape[0] - 1
    items = torch.div(seg_off[1:] - seg_off[:-1] + fb - 1, fb,
                      rounding_mode="floor").long()
    ends = torch.cumsum(items, 0)
    num_cta = -(-N // fb) + min(num_vb, N)
    c = torch.arange(num_cta, device=seg_off.device)
    vid = torch.searchsorted(ends, c, right=True)
    v = torch.clamp_max(vid, num_vb - 1)
    lo = seg_off[v].long() + (c - (ends[v] - items[v])) * fb
    return num_cta, vid.to(torch.int32), lo.to(torch.int32)


def _check_keys(name: str, arg: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int64 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be a contiguous "
                         f"int64{list(shape)} of key words, got "
                         f"{t.dtype}{list(t.shape)}")


def _check_walk_state(name: str, pos, alive, counts, step_key, n: int):
    N = pos.shape[0]
    _check_i32(name, "pos", pos)
    if alive.dtype != torch.bool or alive.shape != (N,) \
            or not alive.is_contiguous():
        raise ValueError(f"{name}: alive must be a contiguous bool[{N}], got "
                         f"{alive.dtype}{list(alive.shape)}")
    _check_i32(name, "counts", counts, numel=n)
    _check_keys(name, "step_key", step_key, (2,))


def _check_graph(name: str, row_ptr, col_idx, deg, n: int) -> None:
    _check_i32(name, "row_ptr", row_ptr, numel=n + 1)
    _check_i32(name, "deg", deg, numel=n)
    _check_i32(name, "col_idx", col_idx)


def _check_hop(name: str, pos, row_keys, step: int, R: int) -> None:
    _check_i32(name, "pos", pos)
    N = pos.shape[0]
    if R < 1 or N % R:
        raise ValueError(f"{name}: {N} walks are not whole rows of R = {R}")
    if not 0 <= step < 2 ** 31:
        raise ValueError(f"{name}: step must be in [0, 2**31), got {step}")
    _check_keys(name, "row_keys", row_keys, (N // R, 2))


def frog_superstep(pos: torch.Tensor, alive: torch.Tensor,
                   counts: torch.Tensor, step_key: torch.Tensor, p_T: float,
                   row_ptr: torch.Tensor, col_idx: torch.Tensor,
                   deg: torch.Tensor, n: int, impl: str = "auto",
                   blocked: Optional[BlockedCSR] = None) -> None:
    """One whole superstep of the batch walk, in place on ``pos``
    (int32[N]), ``alive`` (bool[N]) and the run's ``counts`` (int32[n]).

    With ``(k_die, k_move) = split(step_key)`` (an int64[2] key): a live
    frog ``f`` whose coin ``bernoulli(k_die, p_T)`` at counter ``f`` comes
    up dies and is tallied at its vertex; every other live frog moves along
    out-edge ``randint(k_move, 0, 2**30) % d_out`` (counter ``f``); dead
    frogs stay. The kernel draws: one launch (the resident kernel, or
    under ``impl="stream"`` the sort, its runs and the sorted kernel),
    byte-equal to the plain version (``ref.frog_superstep_ref``), which
    CPU tensors and ``impl="torch"`` run."""
    name = "frog_superstep"
    N = pos.shape[0]
    _check_walk_state(name, pos, alive, counts, step_key, n)
    _check_graph(name, row_ptr, col_idx, deg, n)
    if impl == "stream":
        blocked, pos_s, order, seg_off, sched = _sorted_runs(
            name, pos, row_ptr, col_idx, deg, n, blocked)
        frog_superstep_stream_sorted(pos_s, order, pos, alive, counts,
                                     step_key, p_T, seg_off, sched, blocked)
        return
    use = _use_kernel(name, impl, pos, alive, counts, step_key, row_ptr,
                      col_idx, deg)
    if not use:
        for t, new in zip((pos, alive, counts), kref.frog_superstep_ref(
                pos, alive, counts, step_key, p_T, row_ptr, col_idx, deg,
                n)):
            t.copy_(new)
        return
    if N:
        _launch(name, pos.device, pos.data_ptr(), alive.data_ptr(),
                counts.data_ptr(), step_key.data_ptr(), float(p_T),
                row_ptr.data_ptr(), col_idx.data_ptr(), deg.data_ptr(), N)


def _check_visited(name: str, visited: Optional[torch.Tensor], N: int,
                   mask_block: int) -> Tuple[torch.Tensor, ...]:
    """Checks a hop's mask operand (uint32[N, MASK_WORDS] or ``None``) →
    the tensors to check for one device with the others."""
    if visited is None:
        return ()
    shape = (N, kref.MASK_WORDS)
    if visited.dtype != torch.uint32 or tuple(visited.shape) != shape \
            or not visited.is_contiguous():
        raise ValueError(f"{name}: visited must be a contiguous uint32"
                         f"{list(shape)}, got {visited.dtype}"
                         f"{list(visited.shape)}")
    if mask_block < 1:
        raise ValueError(f"{name}: mask_block must be ≥ 1, got "
                         f"{mask_block}")
    return (visited,)


def _plain_visits(visited: Optional[torch.Tensor], nxt: torch.Tensor,
                  step: int, record: bool, mask_block: int) -> None:
    if visited is not None:
        words = visited.view(torch.int32)
        words.copy_(kref.hop_visits(words, nxt, step, record, mask_block))


def frog_hop(pos: torch.Tensor, row_keys: torch.Tensor, step: int, R: int,
             row_ptr: torch.Tensor, col_idx: torch.Tensor, deg: torch.Tensor,
             n: int, impl: str = "auto", blocked: Optional[BlockedCSR] = None,
             visited: Optional[torch.Tensor] = None, record: bool = False
             ) -> None:
    """One hop of the walk-index build, in place on ``pos`` (int32[C ·
    R]): walk ``c · R + r`` (slot ``r`` of row ``c``) moves along out-edge
    ``randint(fold_in(row_keys[c], step), (R,), 0, 2**30)[r] % d_out``;
    ``row_keys`` is the int64[C, 2] table of the rows' keys. ``impl`` as
    for :func:`frog_superstep`; the plain version is
    ``ref.frog_hop_ref``.

    ``visited`` (uint32[C · R, MASK_WORDS]) records the segments'
    visited-block masks in place, over blocks of
    ``ref.segment_mask_block_size(n)`` ids: hop 0 writes each walk's row,
    the bit of the vertex it reached when ``record`` is set, none
    otherwise; a later hop ORs that bit in when ``record`` is set
    (``ref.hop_visits``). The build records hops ``0 … L − 2``, the
    segment's intermediate vertices; it runs them all in one
    :func:`frog_segment_walk`. Under ``"stream"`` the sorted hop leaves
    the masks to :func:`frog_segment_masks`, one more launch."""
    name = "frog_hop"
    _check_hop(name, pos, row_keys, step, R)
    _check_graph(name, row_ptr, col_idx, deg, n)
    N = pos.shape[0]
    mask_block = kref.segment_mask_block_size(n)
    vis = _check_visited(name, visited, N, mask_block)
    if impl == "stream":
        blocked, pos_s, order, seg_off, sched = _sorted_runs(
            name, pos, row_ptr, col_idx, deg, n, blocked)
        frog_hop_stream_sorted(pos_s, order, pos, row_keys, step, R, seg_off,
                               sched, blocked)
        if visited is not None and (record or step == 0):
            trail = pos[None] if record else pos[None][:0]
            frog_segment_masks(trail, visited, mask_block,
                               accumulate=step > 0)
        return
    use = _use_kernel(name, impl, pos, row_keys, row_ptr, col_idx, deg, *vis)
    if not use:
        pos.copy_(kref.frog_hop_ref(pos, row_keys, step, R, row_ptr, col_idx,
                                    deg))
        _plain_visits(visited, pos, step, record, mask_block)
        return
    if N:
        _launch(name, pos.device, pos.data_ptr(), row_keys.data_ptr(),
                int(step), int(R), row_ptr.data_ptr(), col_idx.data_ptr(),
                deg.data_ptr(), visited.data_ptr() if vis else None,
                int(record), mask_block, N)


def _check_sorted(name: str, pos_s, order, pos, seg_off, schedule,
                  blocked: BlockedCSR) -> None:
    N = pos.shape[0]
    _check_i32(name, "pos", pos)
    _check_i32(name, "pos_s", pos_s, numel=N)
    if order.dtype != torch.int64 or order.shape != (N,) \
            or not order.is_contiguous():
        raise ValueError(f"{name}: order must be a contiguous int64[{N}]")
    _check_i32(name, "seg_off", seg_off, numel=blocked.num_blocks + 1)
    for arg in ("row_off", "deg", "col"):
        _check_i32(name, arg, getattr(blocked, arg), ndim=2)
    num_cta, cta_vid, cta_lo = schedule
    _check_i32(name, "cta_vid", cta_vid, numel=num_cta)
    _check_i32(name, "cta_lo", cta_lo, numel=num_cta)


def _sorted_operands(pos_s, order, seg_off, schedule, blocked):
    num_cta, cta_vid, cta_lo = schedule
    return ((pos_s.data_ptr(), order.data_ptr()),
            (cta_vid.data_ptr(), cta_lo.data_ptr(), seg_off.data_ptr(),
             blocked.row_off.data_ptr(), blocked.deg.data_ptr(),
             blocked.col.data_ptr(), num_cta, blocked.num_blocks,
             blocked.vertex_block, blocked.e_blk, STREAM_FROG_BLOCK,
             _stage_col(blocked, pos_s.shape[0])))


def frog_superstep_stream_sorted(pos_s: torch.Tensor, order: torch.Tensor,
                                 pos: torch.Tensor, alive: torch.Tensor,
                                 counts: torch.Tensor,
                                 step_key: torch.Tensor, p_T: float,
                                 seg_off: torch.Tensor,
                                 schedule: Tuple[int, torch.Tensor,
                                                 torch.Tensor],
                                 blocked: BlockedCSR, impl: str = "auto"
                                 ) -> None:
    """:func:`frog_superstep`'s streamed kernel: the frogs sorted by vertex
    (``pos_s``; block ``v``'s run ``seg_off[v] .. seg_off[v + 1]``),
    ``order[f]`` (int64) the original index of sorted frog ``f``. Frog
    ``order[f]`` draws at that counter, and its ``pos``, ``alive`` and the
    ``counts`` are updated in place in the original order. ``schedule`` is
    :func:`stream_schedule` of ``seg_off``."""
    name = "frog_superstep_stream_sorted"
    _check_sorted(name, pos_s, order, pos, seg_off, schedule, blocked)
    _check_walk_state(name, pos, alive, counts, step_key, counts.shape[0])
    use = _use_kernel(name, impl, pos_s, order, pos, alive, counts,
                      step_key, seg_off, *schedule[1:], blocked.row_off,
                      blocked.deg, blocked.col)
    if not use:
        for t, new in zip((pos, alive, counts),
                          kref.frog_superstep_stream_sorted_ref(
                              pos_s, order, alive, counts, step_key, p_T,
                              seg_off, blocked.row_off, blocked.deg,
                              blocked.col)):
            t.copy_(new)
        return
    frogs, work = _sorted_operands(pos_s, order, seg_off, schedule, blocked)
    if pos.shape[0]:
        _launch(name, pos.device, *frogs, pos.data_ptr(), alive.data_ptr(),
                counts.data_ptr(), step_key.data_ptr(), float(p_T), *work)


def frog_hop_stream_sorted(pos_s: torch.Tensor, order: torch.Tensor,
                           pos: torch.Tensor, row_keys: torch.Tensor,
                           step: int, R: int, seg_off: torch.Tensor,
                           schedule: Tuple[int, torch.Tensor, torch.Tensor],
                           blocked: BlockedCSR, impl: str = "auto",
                           hop_keys: Optional[torch.Tensor] = None) -> None:
    """:func:`frog_hop`'s streamed kernel on walks sorted by vertex (as
    :func:`frog_superstep_stream_sorted`): walk ``order[f]`` moves, its
    new vertex written to ``pos`` at ``order[f]`` (every walk of ``pos``
    is written, so ``pos`` may be another buffer than the one sorted).
    The kernel reads the rows' keys of the hop, ``hop_keys`` (int64[C,
    2], ``ref.hop_keys(row_keys, step)``), drawn here when not given: two
    ``threefry_fold_in`` launches."""
    name = "frog_hop_stream_sorted"
    _check_sorted(name, pos_s, order, pos, seg_off, schedule, blocked)
    _check_hop(name, pos, row_keys, step, R)
    use = _use_kernel(name, impl, pos_s, order, pos, row_keys, seg_off,
                      *schedule[1:], blocked.row_off, blocked.deg,
                      blocked.col)
    if hop_keys is None:
        hop_keys = kref.hop_keys(row_keys, step,
                                 impl=None if use else "torch")
    _check_keys(name, "hop_keys", hop_keys, row_keys.shape)
    if not use:
        pos.copy_(kref.frog_hop_stream_sorted_ref(
            pos_s, order, hop_keys, R, seg_off, blocked.row_off, blocked.deg,
            blocked.col))
        return
    frogs, work = _sorted_operands(pos_s, order, seg_off, schedule, blocked)
    if pos.shape[0]:
        _launch(name, pos.device, *frogs, pos.data_ptr(), hop_keys.data_ptr(),
                int(R), *work)


def frog_segment_masks(trail: torch.Tensor, visited: torch.Tensor,
                       mask_block: int, impl: str = "auto",
                       accumulate: bool = False) -> None:
    """The visited-block mask rows of walks that stood on ``trail[0 … T −
    1]`` (int32[T, N], one row a recorded hop), in place in ``visited``
    (uint32[N, MASK_WORDS]): each walk's row the OR of its T block bits
    (blocks of ``mask_block`` ids), ORed into the row's old words under
    ``accumulate``. One launch; the plain version is
    ``ref.frog_segment_masks_ref``."""
    name = "frog_segment_masks"
    _check_i32(name, "trail", trail, ndim=2)
    N = trail.shape[1]
    vis = _check_visited(name, visited, N, mask_block)
    use = _use_kernel(name, impl, trail, *vis)
    words = visited.view(torch.int32)
    if not use:
        words.copy_(kref.frog_segment_masks_ref(
            trail, mask_block, words if accumulate else None))
        return
    if N:
        _launch(name, trail.device, trail.data_ptr(), trail.shape[0],
                visited.data_ptr(), int(mask_block), int(accumulate), N)


def _segment_out(name: str, out, C: int, R: int, device: torch.device):
    """The segment walk's ``(endpoints int32[C, R], visited uint32[C, R,
    MASK_WORDS])``: ``out`` checked, or allocated."""
    shapes = ((C, R), (C, R, kref.MASK_WORDS))
    if out is None:
        return tuple(torch.empty(shape, dtype=dt, device=device)
                     for shape, dt in zip(shapes, (torch.int32,
                                                   torch.uint32)))
    for t, shape, dt in zip(out, shapes, (torch.int32, torch.uint32)):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: out must be contiguous int32{[C, R]} "
                             f"and uint32{list(shapes[1])} tensors, got "
                             f"{t.dtype}{list(t.shape)}")
    return tuple(out)


def frog_segment_walk(vertices: torch.Tensor, row_keys: torch.Tensor, R: int,
                      L: int, row_ptr: torch.Tensor, col_idx: torch.Tensor,
                      deg: torch.Tensor, n: int, impl: str = "auto",
                      out=None, blocked: Optional[BlockedCSR] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A walk-index segment walk, whole: the ``R`` walks of each row ``c``
    start at ``vertices[c]`` (int32[C]) and take ``L ≥ 1`` hops of
    :func:`frog_hop` under ``row_keys[c]`` (int64[C, 2]), hops ``0 … L −
    2`` recorded in their visited-block masks over blocks of
    ``ref.segment_mask_block_size(n)`` ids → ``(endpoints int32[C, R],
    visited uint32[C, R, MASK_WORDS])``, written into ``out`` when given.

    One launch of the kernel (``"auto"`` on CUDA tensors, ``"cuda"``);
    the plain version (``ref.frog_segment_walk_ref``) for CPU tensors and
    ``"torch"``. The kernel reads a vertex's degree as ``row_ptr[v + 1] −
    row_ptr[v]``, not ``deg[v]`` (one gathered sector a hop fewer): the
    two agree for every ``CSRGraph``, whose ``out_deg`` is
    ``diff(row_ptr)``, and ``deg`` must be that.

    ``"stream"`` runs the L hops through the sorted kernel over
    ``blocked`` (built from the CSR when not given), each hop's positions
    into a trail whose rows :func:`frog_segment_masks` then turns into
    the masks: L + 1 launches and two ``threefry_fold_in`` for every
    hop's keys."""
    name = "frog_segment_walk"
    _check_i32(name, "vertices", vertices)
    C = vertices.shape[0]
    if R < 1 or L < 1:
        raise ValueError(f"{name}: R and L must be ≥ 1, got R = {R}, "
                         f"L = {L}")
    _check_keys(name, "row_keys", row_keys, (C, 2))
    _check_graph(name, row_ptr, col_idx, deg, n)
    ep, vis = _segment_out(name, out, C, R, vertices.device)
    mask_block = kref.segment_mask_block_size(n)
    if impl == "stream":
        _segment_walk_stream(vertices, row_keys, R, L, row_ptr, col_idx, deg,
                             n, blocked, ep, vis, mask_block)
        return ep, vis
    use = _use_kernel(name, impl, vertices, row_keys, row_ptr, col_idx, deg,
                      ep, vis)
    if not use:
        e, m = kref.frog_segment_walk_ref(vertices, row_keys, R, L, row_ptr,
                                          col_idx, deg, n)
        ep.copy_(e)
        vis.view(torch.int32).copy_(m)
    elif C:
        _launch(name, vertices.device, vertices.data_ptr(),
                row_keys.data_ptr(), int(R), int(L), row_ptr.data_ptr(),
                col_idx.data_ptr(), ep.data_ptr(), vis.data_ptr(),
                mask_block, C * R)
    return ep, vis


def _segment_walk_stream(vertices, row_keys, R: int, L: int, row_ptr,
                         col_idx, deg, n: int, blocked, ep, vis,
                         mask_block: int) -> None:
    """:func:`frog_segment_walk` under ``"stream"``: hop ``s < L − 1``
    writes row ``s`` of the trail, the last hop the endpoints."""
    C = vertices.shape[0]
    if not C:
        return
    N = C * R
    pos = torch.repeat_interleave(vertices, R, output_size=N)
    trail = torch.empty(L - 1, N, dtype=torch.int32, device=pos.device)
    steps = torch.arange(L, device=pos.device)[:, None]
    keys = kref.hop_keys(row_keys, steps, impl=None)
    for step in range(L):
        dst = trail[step] if step < L - 1 else ep.view(-1)
        blocked, pos_s, order, seg_off, sched = _sorted_runs(
            "frog_segment_walk", pos, row_ptr, col_idx, deg, n, blocked)
        frog_hop_stream_sorted(pos_s, order, dst, row_keys, step, R, seg_off,
                               sched, blocked, hop_keys=keys[step])
        pos = dst
    frog_segment_masks(trail, vis.view(N, kref.MASK_WORDS), mask_block)


def _check_block(name: str, block: torch.Tensor, base: int) -> None:
    _check_i32(name, "block", block, ndim=2)
    if int(base) < 0:
        raise ValueError(f"{name}: base must be ≥ 0, got {base}")


def stitch_gather_local(pos: torch.Tensor, bits: torch.Tensor,
                        block: torch.Tensor, base: int, impl: str = "auto",
                        rng: str = "caller") -> torch.Tensor:
    """Per-shard gather-only stitch round against one shard's
    ``int32[sz, R]`` block: walks the shard owns (``0 ≤ pos − base < sz``)
    get ``block[pos − base, abs(bits) % R]``, the rest 0; ``bits`` is the
    key under ``rng="device"``."""
    name = "stitch_gather_local"
    use = _use_kernel(name, impl, pos, bits, block)
    W = pos.shape[0]
    _check_i32(name, "pos", pos)
    _slot_operand(name, "bits", bits, W, rng)
    _check_block(name, block, base)
    if not use:
        return kref.stitch_gather_local_ref(
            pos, torch.abs(_plain_bits(bits, W, rng)), block, base)
    nxt = torch.empty_like(pos)
    if W:
        _launch(name, pos.device, pos.data_ptr(), *_bits_ptrs(bits, rng),
                block.data_ptr(), nxt.data_ptr(), W, int(base),
                block.shape[0], block.shape[1])
    return nxt


def stitch_step_local(pos: torch.Tensor, stop: torch.Tensor,
                      bits: torch.Tensor, block: torch.Tensor, base: int,
                      impl: str = "auto", tally: bool = True,
                      rng: str = "caller"
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-shard stitch round → ``(next_contrib int32[W], stop_counts
    int32[sz])``: owned walks gather from the block and owned stopped walks
    are tallied into the shard's local bins; the rest contribute 0, so the
    outputs summed over the shards equal :func:`stitch_step`'s; ``bits``
    is the key under ``rng="device"``.

    ``tally=False`` runs the gather-only kernel and returns
    ``(next_contrib, None)``, byte-identical contributions.
    """
    if not tally:
        return stitch_gather_local(pos, bits, block, base, impl=impl,
                                   rng=rng), None
    name = "stitch_step_local"
    use = _use_kernel(name, impl, pos, stop, bits, block)
    stop = stop.to(torch.int32).contiguous()
    W = pos.shape[0]
    _check_i32(name, "pos", pos)
    _check_i32(name, "stop", stop, numel=W)
    _slot_operand(name, "bits", bits, W, rng)
    _check_block(name, block, base)
    if not use:
        return kref.stitch_step_local_ref(
            pos, stop, torch.abs(_plain_bits(bits, W, rng)), block, base)
    sz, R = block.shape
    nxt = torch.empty_like(pos)
    counts = torch.zeros(sz, dtype=torch.int32, device=pos.device)
    if W:
        _launch(name, pos.device, pos.data_ptr(), stop.data_ptr(),
                *_bits_ptrs(bits, rng), block.data_ptr(), nxt.data_ptr(),
                counts.data_ptr(), W, int(base), sz, R)
    return nxt, counts


@dataclasses.dataclass(frozen=True)
class BlockTable:
    """``S`` shard blocks (``int32[sz, R]`` each, ``None`` for a lost
    shard's) and the device table of their addresses that
    :func:`stitch_gather_local_rounds`' kernel reads (``ptrs``, int64[S] on
    the blocks' device, 0 for a ``None`` block). It holds the blocks, so
    the addresses stay valid while the table lives. Built once per set of
    blocks by :func:`block_table`."""

    blocks: Tuple[Optional[torch.Tensor], ...]
    ptrs: torch.Tensor
    sz: int
    R: int


def block_table(blocks: Sequence[Optional[torch.Tensor]]) -> BlockTable:
    """The :class:`BlockTable` of ``blocks``: contiguous ``int32[sz, R]``
    tensors of one shape on one device, each its own allocation or not;
    ``None`` stands for a lost shard's block, which is never read."""
    name = "block_table"
    blocks = tuple(blocks)
    given = [b for b in blocks if b is not None]
    if not given:
        raise ValueError(f"{name}: needs at least one block")
    for b in given:
        _check_i32(name, "block", b, ndim=2)
        if b.shape != given[0].shape or b.device != given[0].device:
            raise ValueError(f"{name}: blocks of shapes {list(b.shape)} and "
                             f"{list(given[0].shape)} on {b.device} and "
                             f"{given[0].device}; they must match")
    sz, R = given[0].shape
    if sz < 1 or R < 1 or sz >= 2 ** 31:
        raise ValueError(f"{name}: blocks must be [sz, R] with 1 ≤ sz < "
                         f"2**31 and R ≥ 1, got {[sz, R]}")
    ptrs = torch.tensor([0 if b is None else b.data_ptr() for b in blocks],
                        dtype=torch.int64, device=given[0].device)
    return BlockTable(blocks, ptrs, int(sz), int(R))


def stitch_gather_local_rounds(
        pos: torch.Tensor, q: torch.Tensor, s0: torch.Tensor,
        table: BlockTable, q_max: int, lost: Optional[torch.Tensor] = None,
        impl: str = "auto", lost_host: Optional[Sequence[bool]] = None,
        rng: str = "caller") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A loop wave's ``q_max`` stitch rounds over ``S`` shard blocks in one
    launch → ``(pos int32[W], alive bool[W] or None)``.

    ``table`` is the blocks' :class:`BlockTable` (:func:`block_table`,
    built once for many waves): block ``s`` holds rows ``[s·sz,
    (s+1)·sz)``, each block is read as a tensor of its own, never as one
    slab, and a ``None`` block (a lost shard's) is never read. Round ``j``
    moves the walks with ``j < q`` to ``block_s[pos − s·sz, abs(s0 + j) %
    R]`` of the shard ``s`` that owns their row (0 for a row no shard
    owns). With ``lost`` (bool[S]), a walk that still needs a gather while
    in a lost shard's rows (shard ``clip(pos // sz, 0, S − 1)``), or whose
    final vertex lies in one, dies and keeps its position; ``alive`` marks
    the others. The same bytes as ``q_max`` rounds of
    :func:`stitch_gather_local` summed over the shards that are not lost,
    and as :func:`stitch_gather_rounds` over the blocks stacked. Under
    ``rng="device"`` ``s0`` is the key, as for that function.

    Only a lost shard's block may be missing. ``lost_host``, ``lost``'s
    values on the host (the caller's copy), is what that check reads, so
    the call makes no device read; without it the check reads ``lost``
    back when the table has a missing block."""
    name = "stitch_gather_local_rounds"
    S = len(table.blocks)
    masked = lost is not None
    use = _use_kernel(name, impl, pos, q, s0, table.ptrs,
                      *((lost,) if masked else ()))
    W = pos.shape[0]
    _check_i32(name, "pos", pos)
    _check_i32(name, "q", q, numel=W)
    _slot_operand(name, "s0", s0, W, rng)
    if not 0 <= q_max < 2 ** 31:
        raise ValueError(f"{name}: q_max must be in [0, 2**31), got {q_max}")
    if masked and (lost.dtype != torch.bool or lost.dim() != 1
                   or not lost.is_contiguous() or lost.numel() != S):
        raise ValueError(f"{name}: lost must be a contiguous bool[S = {S}], "
                         f"got {lost.dtype} {list(lost.shape)}")
    if lost_host is not None and (not masked or len(lost_host) != S):
        raise ValueError(f"{name}: lost_host needs lost and S = {S} "
                         f"entries")
    missing = [s for s, b in enumerate(table.blocks) if b is None]
    if missing:
        if masked and lost_host is None:
            lost_host = lost.tolist()
        if not masked or not all(lost_host[s] for s in missing):
            raise ValueError(f"{name}: shards {missing} have no block; "
                             f"only a lost shard's block may be missing")
    if not use:
        return kref.stitch_gather_local_rounds_ref(
            pos, q, _plain_bits(s0, W, rng), table.blocks, q_max, lost)
    nxt = torch.empty_like(pos)
    alive = torch.empty(W, dtype=torch.bool, device=pos.device) \
        if masked else None
    if W:
        _launch(name, pos.device, pos.data_ptr(), q.data_ptr(),
                *_bits_ptrs(s0, rng), table.ptrs.data_ptr(),
                lost.data_ptr() if masked else None, nxt.data_ptr(),
                alive.data_ptr() if masked else None, W, table.R,
                int(q_max), S, table.sz)
    return nxt, alive


def spmv_ell_slab(idx: torch.Tensor, weight: torch.Tensor, x: torch.Tensor,
                  row_len: Optional[torch.Tensor] = None,
                  impl: str = "auto") -> torch.Tensor:
    """The ELL slab product ``y[r] = Σ_k weight[r, k] · x[idx[r, k]]``
    (float32[rows]) over an ``int32[rows, K]`` / ``float32[rows, K]``
    slab whose ids lie in ``[0, len(x))`` (``to_ell`` makes them so, padded
    lanes included); ragged row counts need no padding.

    ``row_len`` (int32[rows], ``EllGraph.row_len``) says that only the
    first ``row_len[r]`` lanes of row ``r`` are live and the rest carry
    weight 0, as ``to_ell`` lays them out: the kernel then reads the live
    lanes only. The plain version (``spmv_ref``, CPU tensors) reads every
    lane. The two are byte-equal whenever ``x`` is finite at the padded
    lanes' ids (``x[0]`` for ``to_ell``): a padded lane adds ``0 · x[0]``,
    which leaves a sum that starts from +0 as it is. A non-finite ``x[0]``
    makes ``spmv_ref``'s padded rows NaN and not the kernel's."""
    name = "spmv_ell_slab"
    tensors = (idx, weight, x) + (() if row_len is None else (row_len,))
    use = _use_kernel(name, impl, *tensors)
    if use:
        _refuse_autograd(name, " (nor has the reference's Pallas kernel)",
                         weight, x)
    _check_i32(name, "idx", idx, ndim=2)
    if row_len is not None:
        _check_i32(name, "row_len", row_len, numel=idx.shape[0])
    for arg, t in (("weight", weight), ("x", x)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: {arg} must be contiguous float32")
    if weight.shape != idx.shape or x.dim() != 1:
        raise ValueError(f"{name}: weight must have idx's shape "
                         f"{list(idx.shape)} and x be 1-D")
    if not use:
        return kref.spmv_ref(idx, weight, x)
    rows, K = idx.shape
    y = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        _launch(name, x.device, idx.data_ptr(), weight.data_ptr(),
                x.data_ptr(),
                None if row_len is None else row_len.data_ptr(),
                y.data_ptr(), rows, K)
    return y


def spmv(ell: EllGraph, x: torch.Tensor, impl: str = "auto"
         ) -> torch.Tensor:
    """Hybrid-ELL SpMV ``y = P @ x`` (float32[ell.n_rows]): the slab
    through :func:`spmv_ell_slab` over its live lanes (``ell.row_len``),
    plus the COO spill tail. ``x`` covers every vertex id the layout
    names; callers slice ``y`` to the true ``n``."""
    y = spmv_ell_slab(ell.idx, ell.weight, x, row_len=ell.row_len,
                      impl=impl)
    if ell.spill_nnz:
        y = y + kref.spill_ref(ell.spill_src, ell.spill_dst, ell.spill_w, x,
                               ell.n_rows)
    return y


ATTN_DTYPES = (torch.float32, torch.bfloat16)
ATTN_MAX_HEAD_DIM = 256
# the backward's tensor-core route: bf16 at head_dim up to this; its Δ and
# lse scratch padded to whole 64-row tiles (csrc/fa_bwd_hopper.cuh)
ATTN_BWD_TC_MAX_HEAD_DIM = 128
ATTN_BWD_TILE = 64
# the backward's launches by route (``attention_bwd_route``), and the codes
# its C entry point takes
BWD_ROUTES: Dict[str, int] = {"wgmma": 0, "simt": 0}
BWD_ROUTE_CODES = {"simt": 0, "wgmma": 1}


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's TMA loads can read ``t [B, H, S, D]`` as
    it lies: a 16-byte-aligned base, the last dimension contiguous, and
    the batch, head and sequence strides 16-byte multiples (a dimension of
    size 1 is never stepped)."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and
            all(st * size % 16 == 0
                for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))


def _tma_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that :func:`tma_ready` accepts: new (so aligned)
    contiguous storage, its head_dim zero-padded to a multiple of 8 (the
    zero columns add nothing to a dot product, and the kernel stores only
    the first D)."""
    pad = -t.shape[-1] % 8
    if pad:
        return torch.nn.functional.pad(t, (0, pad))
    return t.clone(memory_format=torch.contiguous_format)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, soft_cap: Optional[float] = None,
              impl: str = "auto", chunk: int = 512) -> torch.Tensor:
    """GQA attention ``q [B, Hq, Sq, D]``, ``k``/``v [B, Hkv, Skv, D]`` →
    ``[B, Hq, Sq, D]`` in ``q``'s dtype (port of the reference's
    ``ops.attention``). ``impl``: ``"auto"`` / ``"cuda"`` run the
    ``flash_attention`` kernel on CUDA tensors, ``"torch"`` (and
    ``"auto"`` on CPU tensors) the plain chunked version, ``"ref"`` the
    oracle. The kernel reads q, k and v through their strides (the last
    dimension contiguous and, in bf16, :func:`tma_ready`'s alignment; an
    operand that fails it is copied, the same kernel on the copy) and
    takes ``Skv`` as it is: keys at or past it are
    masked, so nothing is padded (the reference's wrapper pads K/V with
    zero keys that only its causal mask hides).

    With grad mode on and q, k or v requiring grad, the call goes through
    an autograd Function: the forward also writes the rows' log-sum-exp
    (the kernel's optional output, or ``attention_chunked``'s), and the
    backward is :func:`attention_bwd`, the ``flash_attention_bwd`` kernel
    on the kernel's route and ``ref.attention_bwd_ref`` on the plain one.
    Without grad the call is the forward alone, with no LSE written.
    Under autograd ``"ref"`` takes the plain route (the oracle computes
    in place and records no history)."""
    name = "flash_attention"
    grad = _grad_wanted(q, k, v)
    if impl == "ref" and not grad:
        return kref.attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, logit_soft_cap=soft_cap)
    use = impl != "ref" and _use_kernel(name, impl, q, k, v)
    _check_attention(name, q, k, v, soft_cap)
    if use:
        _check_attention_kernel(name, q, k, v, q_offset)
    if grad:
        return _Attention.apply(q, k, v, causal, window, q_offset, soft_cap,
                                use, chunk)
    if not use:
        return kref.attention_chunked(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset,
                                      logit_soft_cap=soft_cap, chunk=chunk)
    return _attention_kernel(q, k, v, causal, window, q_offset, soft_cap,
                             with_lse=False)[0]


def _check_attention(name: str, q, k, v, soft_cap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q must be [B, Hq, Sq, D] and k, v one "
                         f"[B, Hkv, Skv, D] shape; got {list(q.shape)}, "
                         f"{list(k.shape)}, {list(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{name}: q {list(q.shape)} and k {list(k.shape)} "
                         f"disagree in batch or head_dim, or Hq is not a "
                         f"multiple of Hkv")
    if soft_cap is not None and soft_cap <= 0:
        raise ValueError(f"{name}: soft_cap must be > 0, got {soft_cap}")


def _check_attention_kernel(name: str, q, k, v, q_offset: int) -> None:
    if q.dtype not in ATTN_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must all be float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    D, Sq, Skv = q.shape[3], q.shape[2], k.shape[2]
    if D > ATTN_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {D} > {ATTN_MAX_HEAD_DIM}")
    if not 0 <= q_offset < 2 ** 30 or Sq >= 2 ** 30 or Skv >= 2 ** 31:
        raise ValueError(f"{name}: q_offset {q_offset}, Sq {Sq} or Skv "
                         f"{Skv} out of the kernel's int32 range")


def _window_args(window: Optional[int], q_offset: int, Sq: int
                 ) -> Tuple[int, int]:
    """``(has_window, window)`` as the kernels take them: a window wider
    than every query's reach masks nothing."""
    has = window is not None and window <= q_offset + Sq - 1
    return int(has), int(window) if has else 0


def _attention_kernel(q, k, v, causal: bool, window: Optional[int],
                      q_offset: int, soft_cap: Optional[float],
                      with_lse: bool
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One ``flash_attention`` launch → ``(out, lse or None)``; ``lse``
    (float32 ``[B, Hq, Sq]``, natural log) is written only when asked, and
    the output is the same either way."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if q.dtype == torch.bfloat16:
        q, k, v = (t if tma_ready(t) else _tma_copy(t) for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if out.numel():
        _launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], B, Hq, Hkv, Sq, Skv, D,
                int(causal), *_window_args(window, q_offset, Sq),
                int(q_offset), kref.attention_scale(D),
                int(soft_cap is not None),
                float(soft_cap) if soft_cap is not None else 0.0,
                int(q.dtype == torch.bfloat16))
    elif with_lse:
        lse.fill_(float("inf"))
    return out, lse


class _Attention(torch.autograd.Function):
    """``attention`` under autograd: the forward with its LSE, saved with
    q, k, v and the output; the backward through :func:`attention_bwd`
    on the same route (kernel or plain) as the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, soft_cap, use,
                chunk):
        if use:
            out, lse = _attention_kernel(q, k, v, causal, window, q_offset,
                                         soft_cap, with_lse=True)
        else:
            out, lse = kref.attention_chunked(
                q, k, v, causal=causal, window=window, q_offset=q_offset,
                logit_soft_cap=soft_cap, chunk=chunk, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset,
                        soft_cap=soft_cap, chunk=chunk,
                        impl="cuda" if use else "torch")
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse, do, **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def attention_bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The ``flash_attention_bwd`` kernels a CUDA call runs, a rule by
    type and head_dim: ``"wgmma"`` (bf16 at head_dim ≤ 128: the tensor-core
    passes of ``csrc/fa_bwd_hopper.cuh``, q, k, v and dO read through their
    strides) or ``"simt"`` (float32, whose gate is 1e-5, and bf16 at
    head_dim 256: the float32 FMA passes, on contiguous inputs)."""
    if dtype == torch.bfloat16 and head_dim <= ATTN_BWD_TC_MAX_HEAD_DIM:
        return "wgmma"
    return "simt"


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, soft_cap: Optional[float] = None,
                  impl: str = "auto", chunk: int = 512
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of :func:`attention` from its
    inputs, output ``o``, LSE and the output's gradient ``do`` (``o`` and
    ``do`` q's shape, ``lse`` float32 ``[B, Hq, Sq]``), in q's, k's and
    v's dtypes (contiguous): the ``flash_attention_bwd`` kernels for CUDA
    tensors (one launch: Δ = rowsum(dO ∘ O), the key-tile pass for dK and
    dV, the query-tile pass for dQ; ``csrc/flash_attention_bwd.cu``) on
    the route :func:`attention_bwd_route` names, counted in
    ``BWD_ROUTES``; the plain ``ref.attention_bwd_ref`` for CPU tensors
    or ``impl="torch"``."""
    name = "flash_attention_bwd"
    use = _use_kernel(name, impl, q, k, v, o, lse, do)
    _check_attention(name, q, k, v, soft_cap)
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape or \
            tuple(lse.shape) != (B, Hq, Sq):
        raise ValueError(f"{name}: o {list(o.shape)} and do "
                         f"{list(do.shape)} must be q's shape and lse "
                         f"{list(lse.shape)} [B, Hq, Sq]")
    if not use:
        return kref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                      window=window, q_offset=q_offset,
                                      soft_cap=soft_cap, chunk=chunk)
    _check_attention_kernel(name, q, k, v, q_offset)
    if o.dtype != q.dtype or do.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise TypeError(f"{name}: o and do must be q's dtype {q.dtype} and "
                        f"lse float32; got {o.dtype}, {do.dtype}, "
                        f"{lse.dtype}")
    route = attention_bwd_route(q.dtype, D)
    if route == "wgmma":
        q, k, v, do = (t if tma_ready(t) else _tma_copy(t)
                       for t in (q, k, v, do))
        o = o if o.stride(-1) == 1 else o.contiguous()
        rows = -(-Sq // ATTN_BWD_TILE) * ATTN_BWD_TILE
    else:
        q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
        rows = Sq
    lse = lse.contiguous()
    dq = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty((B, Hkv, Skv, D), dtype=t.dtype, device=t.device)
              for t in (k, v))
    if Skv == 0:
        dq.zero_()
    if dq.numel() and dk.numel():
        delta = torch.empty((B, Hq, rows), dtype=torch.float32,
                            device=q.device)
        lse2 = torch.empty_like(delta) if route == "wgmma" else None
        _launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), None if lse2 is None else lse2.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], *do.stride()[:3], B, Hq, Hkv, Sq, Skv, D,
                int(causal), *_window_args(window, q_offset, Sq),
                int(q_offset), kref.attention_scale(D),
                int(soft_cap is not None),
                float(soft_cap) if soft_cap is not None else 0.0,
                int(q.dtype == torch.bfloat16), BWD_ROUTE_CODES[route])
        BWD_ROUTES[route] += 1
    elif dk.numel():
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the recurrent families' time recurrences (csrc/wkv6.cu, csrc/ssd_scan.cu)
# ---------------------------------------------------------------------------

SCAN_DTYPES = (torch.float32, torch.bfloat16)
# a CTA holds 32 columns (wkv6) or rows (ssd) of one head's state; a call
# shorter than a 32-step chunk runs the serial kernel, a longer one the
# pipelined kernel (csrc/scan.cuh)
SCAN_COLS = 32
SCAN_T = kref.SCAN_T
WKV6_HEAD_DIMS = (32, 64, 128)
SSD_STATES = (16, 32, 64, 128)


def _scan_operand(name: str, arg: str, t: torch.Tensor, shape,
                  dtypes) -> torch.Tensor:
    """Checks an operand's shape and dtype; returns it contiguous and
    16-byte aligned (the kernels stage rows with 16-byte async copies)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {list(t.shape)}, wanted "
                         f"{list(shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {arg} must be one of {dtypes}, got "
                        f"{t.dtype}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _wkv6_operands(name: str, r, k, v, w, u, S0):
    """The kernel's operands, checked and contiguous (``_scan_operand``)."""
    B, S, H, D = r.shape
    if D not in WKV6_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {WKV6_HEAD_DIMS}")
    io = (r.dtype,) if r.dtype in SCAN_DTYPES else SCAN_DTYPES
    r = _scan_operand(name, "r", r, (B, S, H, D), io)
    k, v = (_scan_operand(name, a, t, (B, S, H, D), (r.dtype,))
            for a, t in (("k", k), ("v", v)))
    f32 = (torch.float32,)
    w = _scan_operand(name, "w", w, (B, S, H, D), f32)
    u = _scan_operand(name, "u", u, (H, D), f32)
    if S0 is not None:
        S0 = _scan_operand(name, "S0", S0, (B, H, D, D), f32)
    return r, k, v, w, u, S0


def _wkv6_kernel(r, k, v, w, u, S0, checkpoints: bool):
    """One ``wkv6_scan`` launch on checked operands → ``(o, S_last, ckpt
    or None)``; ``ckpt`` (float32 ``[B, H, ⌈S/32⌉, D, D]``, the state
    before each chunk) is written only when asked, and ``o`` and
    ``S_last`` are the same bytes either way."""
    B, S, H, D = r.shape
    o = torch.empty((B, S, H, D), dtype=r.dtype, device=r.device)
    S_last = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    ckpt = torch.empty((B, H, -(-S // SCAN_T), D, D), dtype=torch.float32,
                       device=r.device) if checkpoints else None
    if S == 0 or B == 0 or H == 0:
        if S0 is None:
            S_last.zero_()
        else:
            S_last.copy_(S0)
        return o, S_last, ckpt
    _launch("wkv6_scan", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u.data_ptr(),
            None if S0 is None else S0.data_ptr(), o.data_ptr(),
            S_last.data_ptr(), None if ckpt is None else ckpt.data_ptr(), B,
            S, H, D, int(r.dtype == torch.bfloat16))
    return o, S_last, ckpt


def _wkv6_log_decay(name: str, w: torch.Tensor,
                    log_w: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel route's log-decay operand: ``log_w`` as given (checked
    against ``w``'s shape), or, where w's gradient is not wanted,
    ``log(w)``. A call that wants w's gradient needs ``log_w``: the
    backward kernel returns the gradient of log w, and w's own would be
    that divided by w, which underflows to 0."""
    if log_w is None:
        if _grad_wanted(w):
            raise ValueError(
                f"{name}: w requires grad, so the kernel route needs log_w "
                "(w = exp(log_w)); it returns the gradient of log_w and "
                "never divides by w")
        return torch.log(w.detach())
    return _scan_operand(name, "log_w", log_w, tuple(w.shape),
                         (torch.float32,))


class _Wkv6Scan(torch.autograd.Function):
    """``wkv6_scan``'s kernel under autograd: the forward also writes the
    chunk checkpoints, saved with the inputs; the backward is the
    ``wkv6_scan_bwd`` kernel (:func:`wkv6_scan_bwd`). The decay's gradient
    goes to ``log_w`` (``w = exp(log_w)``), none to ``w``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, S0, log_w):
        args = _wkv6_operands("wkv6_scan", r, k, v, w, u, S0)
        o, S_last, ckpt = _wkv6_kernel(*args, checkpoints=True)
        ctx.save_for_backward(*args, ckpt, log_w)
        ctx.set_materialize_grads(False)
        return o, S_last

    @staticmethod
    def backward(ctx, do, dS_last):
        r, k, v, w, u, S0, ckpt, log_w = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        dr, dk, dv, dlw, du, dS0 = wkv6_scan_bwd(
            r, k, v, w, u, S0, do, dS_last, ckpt=ckpt, log_w=log_w,
            impl="cuda")
        return (dr, dk, dv, None, du, None if S0 is None else dS0, dlw)


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              S0: Optional[torch.Tensor] = None, impl: str = "auto", *,
              log_w: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6's time recurrence over a whole sequence → (``o [B, S, H,
    D]`` in ``r``'s dtype, ``S_last [B, H, D, D]`` float32): per (batch,
    head), ``o_t = r_tᵀ(S_{t−1} + diag(u)·k_t v_tᵀ)``, ``S_t =
    diag(w_t)·S_{t−1} + k_t v_tᵀ`` (``ref.wkv6_scan_ref``). ``r``, ``k``,
    ``v`` ``[B, S, H, D]`` float32 or bfloat16 (one dtype; the kernel
    widens them in registers, as the reference's cast does), ``w`` the
    float32 decay, ``u [H, D]``, ``S0 [B, H, D, D]`` float32 (key row,
    value column) or None for zeros, ``log_w`` the float32 log-decay that
    ``w`` is ``exp`` of (the model passes both). The kernel writes a new
    ``S_last`` and leaves ``S0`` as it was. A decode step is the same call
    at S = 1. With grad mode on and an input requiring grad, the kernel
    runs under an autograd Function whose backward is the
    ``wkv6_scan_bwd`` kernel: the decay's gradient goes to ``log_w``, and
    a call whose ``w`` requires grad without ``log_w`` raises. On the
    plain route autograd runs through the reference's loop under
    ``chunked_scan``, and through ``w``."""
    name = "wkv6_scan"
    use = _use_kernel(name, impl, r, k, v, w, u,
                      *(t for t in (S0, log_w) if t is not None))
    if r.dim() != 4:
        raise ValueError(f"{name}: r must be [B, S, H, D], got "
                         f"{list(r.shape)}")
    if not use:
        for arg, t in (("k", k), ("v", v), ("w", w)):
            if t.shape != r.shape:
                raise ValueError(f"{name}: {arg} has shape {list(t.shape)},"
                                 f" wanted {list(r.shape)}")
        return kref.wkv6_scan_ref(r, k, v, w, u, S0)
    if _grad_wanted(r, k, v, w, u, S0, log_w):
        return _Wkv6Scan.apply(r, k, v, w, u, S0,
                               _wkv6_log_decay(name, w, log_w))
    return _wkv6_kernel(*_wkv6_operands(name, r, k, v, w, u, S0),
                        checkpoints=False)[:2]


def wkv6_bwd_scratch(B: int, S: int, H: int, D: int) -> int:
    """float32 elements of ``wkv6_scan_bwd``'s scratch: the chunk-end
    gradients ``[B, H, ⌈S/32⌉, D, D]`` and du's parts a (batch row,
    chunk) ``[B·⌈S/32⌉, H, D]``."""
    nch = -(-S // SCAN_T)
    return B * H * nch * D * D + B * nch * H * D


def ssd_bwd_groups(B: int, nch: int, H: int) -> int:
    """The head groups of ``ssd_scan_bwd``'s chunk pass: doubled while the
    grid (chunks × batch rows × groups) has fewer than two CTAs for each of
    the card's 132 SMs, then cut to the groups that hold a head. The
    wrapper passes them to ``fw_ssd_scan_bwd``, which checks them and
    lays out its scratch by them, as :func:`ssd_bwd_scratch` sizes it."""
    groups = 1
    while groups < H and B * nch * groups < 264:
        groups *= 2
    hpc = -(-H // groups)
    return -(-H // hpc)


def ssd_bwd_scratch(B: int, S: int, H: int, D: int, n: int) -> int:
    """float32 elements of ``ssd_scan_bwd``'s scratch: the chunk-end
    gradients ``[B, H, ⌈S/32⌉, D, n]``, da's parts a (batch row, chunk)
    and, with more than one head group, dB's and dC's parts a group."""
    nch = -(-S // SCAN_T)
    groups = ssd_bwd_groups(B, nch, H)
    return (B * H * nch * D * n + B * nch * H
            + (2 * groups * B * S * n if groups > 1 else 0))


def wkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  S0: Optional[torch.Tensor], do: torch.Tensor,
                  dS_last: Optional[torch.Tensor] = None, *,
                  ckpt: Optional[torch.Tensor],
                  log_w: Optional[torch.Tensor] = None, impl: str = "auto"
                  ) -> Tuple[torch.Tensor, ...]:
    """The gradients ``(dr, dk, dv, dlw, du, dS0)`` of :func:`wkv6_scan`
    from its inputs, the output's gradient ``do`` (``r``'s shape and
    dtype) and the final state's ``dS_last`` (float32, zeros when None),
    each in its input's dtype (``dlw``, the gradient of log w, and ``dS0``
    float32, also when ``S0`` is None): the ``wkv6_scan_bwd`` kernel for
    CUDA tensors (``csrc/wkv6_bwd.cu``: RWKV-6's chunked form on the
    tensor cores; one launch, its passes included), reading the forward's
    chunk checkpoints ``ckpt`` (float32 ``[B, H, ⌈S/32⌉, D, D]``, which
    :class:`_Wkv6Scan`'s forward writes) and the log-decay ``log_w``
    (float32, ``w = exp(log_w)``), both required; the plain
    ``ref.wkv6_scan_bwd_ref`` for CPU tensors or ``impl="torch"``, which
    recomputes its own states from ``w`` and takes ``ckpt=None``."""
    name = "wkv6_scan_bwd"
    use = _use_kernel(name, impl, r, k, v, w, u, do,
                      *(t for t in (S0, dS_last, ckpt, log_w)
                        if t is not None))
    if not use:
        return kref.wkv6_scan_bwd_ref(r, k, v, w, u, S0, do, dS_last)
    r, k, v, w, u, S0 = _wkv6_operands(name, r, k, v, w, u, S0)
    B, S, H, D = r.shape
    do = _scan_operand(name, "do", do, (B, S, H, D), (r.dtype,))
    if dS_last is not None:
        dS_last = _scan_operand(name, "dS_last", dS_last, (B, H, D, D),
                                (torch.float32,))
    nch = -(-S // SCAN_T)
    if ckpt is None:
        raise ValueError(f"{name}: the kernel reads the forward's chunk "
                         "checkpoints; ckpt is None")
    if log_w is None:
        raise ValueError(f"{name}: the kernel reads the log-decay log_w "
                         "(w = exp(log_w)) and returns its gradient; log_w "
                         "is None")
    ckpt = _scan_operand(name, "ckpt", ckpt, (B, H, nch, D, D),
                         (torch.float32,))
    log_w = _scan_operand(name, "log_w", log_w, (B, S, H, D),
                          (torch.float32,))
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlw = torch.empty_like(log_w)
    du = torch.empty_like(u)
    dS0 = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if S == 0 or B == 0 or H == 0:
        du.zero_()
        if dS_last is None:
            dS0.zero_()
        else:
            dS0.copy_(dS_last)
        return dr, dk, dv, dlw, du, dS0
    part = torch.empty(wkv6_bwd_scratch(B, S, H, D), dtype=torch.float32,
                       device=r.device)
    _launch(name, r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            log_w.data_ptr(), u.data_ptr(), ckpt.data_ptr(), do.data_ptr(),
            None if dS_last is None else dS_last.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(), du.data_ptr(),
            dS0.data_ptr(), part.data_ptr(), B, S, H, D,
            int(r.dtype == torch.bfloat16))
    return dr, dk, dv, dlw, du, dS0


def _ssd_operands(name: str, x, Bv, Cv, dt, a, h0):
    """The kernel's operands, checked and contiguous (``_scan_operand``)."""
    B, S, H, D = x.shape
    n = Bv.shape[-1]
    if D % SCAN_COLS or n not in SSD_STATES:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of "
                         f"{SCAN_COLS} and the state {n} in {SSD_STATES}")
    io = (x.dtype,) if x.dtype in SCAN_DTYPES else SCAN_DTYPES
    x = _scan_operand(name, "x", x, (B, S, H, D), io)
    Bv, Cv = (_scan_operand(name, arg, t, (B, S, n), (x.dtype,))
              for arg, t in (("Bv", Bv), ("Cv", Cv)))
    f32 = (torch.float32,)
    dt = _scan_operand(name, "dt", dt, (B, S, H), f32)
    a = _scan_operand(name, "a", a, (H,), f32)
    if h0 is not None:
        h0 = _scan_operand(name, "h0", h0, (B, H, D, n), f32)
    return x, Bv, Cv, dt, a, h0


def _ssd_kernel(x, Bv, Cv, dt, a, h0, checkpoints: bool):
    """One ``ssd_scan`` launch on checked operands → ``(y, h_last, ckpt or
    None)``; ``ckpt`` (float32 ``[B, H, ⌈S/32⌉, D, n]``) as
    :func:`_wkv6_kernel`'s."""
    B, S, H, D = x.shape
    n = Bv.shape[-1]
    y = torch.empty((B, S, H, D), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, H, D, n), dtype=torch.float32, device=x.device)
    ckpt = torch.empty((B, H, -(-S // SCAN_T), D, n), dtype=torch.float32,
                       device=x.device) if checkpoints else None
    if S == 0 or B == 0 or H == 0:
        if h0 is None:
            h_last.zero_()
        else:
            h_last.copy_(h0)
        return y, h_last, ckpt
    _launch("ssd_scan", x.device, x.data_ptr(), Bv.data_ptr(),
            Cv.data_ptr(), dt.data_ptr(), a.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), None if ckpt is None else ckpt.data_ptr(), B,
            S, H, D, n, int(x.dtype == torch.bfloat16))
    return y, h_last, ckpt


class _SsdScan(torch.autograd.Function):
    """``ssd_scan``'s kernel under autograd, as :class:`_Wkv6Scan`; the
    backward is the ``ssd_scan_bwd`` kernel (:func:`ssd_scan_bwd`)."""

    @staticmethod
    def forward(ctx, x, Bv, Cv, dt, a, h0):
        args = _ssd_operands("ssd_scan", x, Bv, Cv, dt, a, h0)
        y, h_last, ckpt = _ssd_kernel(*args, checkpoints=True)
        ctx.save_for_backward(*args, ckpt)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, Bv, Cv, dt, a, h0, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        *grads, dh0 = ssd_scan_bwd(x, Bv, Cv, dt, a, h0, dy, dh_last,
                                   ckpt=ckpt, impl="cuda")
        return (*grads, None if h0 is None else dh0)


def ssd_scan(x: torch.Tensor, Bv: torch.Tensor, Cv: torch.Tensor,
             dt: torch.Tensor, a: torch.Tensor,
             h0: Optional[torch.Tensor] = None, impl: str = "auto"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2's selective scan over a whole sequence → (``y [B, S, H,
    D]`` float32, ``h_last [B, H, D, n]`` float32): per (batch, head),
    ``h_t = exp(Δ_t·a)·h_{t−1} + Δ_t·(x_t ⊗ B_t)``, ``y_t = h_t·C_t``
    (``ref.ssd_scan_ref``; the ``D`` skip, the gate and the norm are the
    caller's). ``x [B, S, H, D]``, ``Bv`` / ``Cv [B, S, n]`` float32 or
    bfloat16 (one dtype, widened in registers), ``dt [B, S, H]`` float32
    (Δ after its softplus), ``a [H]`` float32 (negative), ``h0 [B, H, D,
    n]`` float32 or None for zeros. The kernel writes a new ``h_last``
    and leaves ``h0`` as it was. A decode step is the same call at S =
    1. Under autograd the kernel runs under an autograd Function whose
    backward is the ``ssd_scan_bwd`` kernel, as :func:`wkv6_scan`'s."""
    name = "ssd_scan"
    use = _use_kernel(name, impl, x, Bv, Cv, dt, a,
                      *(() if h0 is None else (h0,)))
    if x.dim() != 4 or Bv.dim() != 3:
        raise ValueError(f"{name}: x must be [B, S, H, D] and Bv [B, S, n],"
                         f" got {list(x.shape)}, {list(Bv.shape)}")
    B, S, H, D = x.shape
    if not use:
        if Cv.shape != Bv.shape or tuple(dt.shape) != (B, S, H):
            raise ValueError(f"{name}: Cv {list(Cv.shape)} or dt "
                             f"{list(dt.shape)} disagree with x and Bv")
        return kref.ssd_scan_ref(x, Bv, Cv, dt, a, h0)
    if _grad_wanted(x, Bv, Cv, dt, a, h0):
        return _SsdScan.apply(x, Bv, Cv, dt, a, h0)
    return _ssd_kernel(*_ssd_operands(name, x, Bv, Cv, dt, a, h0),
                       checkpoints=False)[:2]


def ssd_scan_bwd(x: torch.Tensor, Bv: torch.Tensor, Cv: torch.Tensor,
                 dt: torch.Tensor, a: torch.Tensor,
                 h0: Optional[torch.Tensor], dy: torch.Tensor,
                 dh_last: Optional[torch.Tensor] = None, *,
                 ckpt: Optional[torch.Tensor], impl: str = "auto"
                 ) -> Tuple[torch.Tensor, ...]:
    """The gradients ``(dx, dB, dC, ddt, da, dh0)`` of :func:`ssd_scan`
    from its inputs, ``dy`` (float32, ``x``'s shape) and ``dh_last``
    (float32, zeros when None), each in its input's dtype (``dh0``
    float32): the ``ssd_scan_bwd`` kernel for CUDA tensors
    (``csrc/ssd_scan_bwd.cu``: Mamba-2's chunked form on the tensor cores;
    one launch, its passes included) on the forward's chunk checkpoints
    ``ckpt`` (float32 ``[B, H, ⌈S/32⌉, D, n]``, which :class:`_SsdScan`'s
    forward writes); the plain
    ``ref.ssd_scan_bwd_ref`` for CPU tensors or ``impl="torch"``, which
    recomputes its own and takes ``ckpt=None``."""
    name = "ssd_scan_bwd"
    use = _use_kernel(name, impl, x, Bv, Cv, dt, a, dy,
                      *(t for t in (h0, dh_last, ckpt) if t is not None))
    if not use:
        return kref.ssd_scan_bwd_ref(x, Bv, Cv, dt, a, h0, dy, dh_last)
    x, Bv, Cv, dt, a, h0 = _ssd_operands(name, x, Bv, Cv, dt, a, h0)
    B, S, H, D = x.shape
    n = Bv.shape[-1]
    f32 = (torch.float32,)
    dy = _scan_operand(name, "dy", dy, (B, S, H, D), f32)
    if dh_last is not None:
        dh_last = _scan_operand(name, "dh_last", dh_last, (B, H, D, n), f32)
    if ckpt is None:
        raise ValueError(f"{name}: the kernel reads the forward's chunk "
                         "checkpoints; ckpt is None")
    ckpt = _scan_operand(name, "ckpt", ckpt, (B, H, -(-S // SCAN_T), D, n),
                         f32)
    dx = torch.empty_like(x)
    dB, dC = torch.empty_like(Bv), torch.empty_like(Cv)
    ddt, da = torch.empty_like(dt), torch.empty_like(a)
    dh0 = torch.empty((B, H, D, n), dtype=torch.float32, device=x.device)
    if S == 0 or B == 0 or H == 0:
        for t in (dB, dC, da):
            t.zero_()
        if dh_last is None:
            dh0.zero_()
        else:
            dh0.copy_(dh_last)
        return dx, dB, dC, ddt, da, dh0
    part = torch.empty(ssd_bwd_scratch(B, S, H, D, n), dtype=torch.float32,
                       device=x.device)
    _launch(name, x.device, x.data_ptr(), Bv.data_ptr(), Cv.data_ptr(),
            dt.data_ptr(), a.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(), da.data_ptr(),
            dh0.data_ptr(), part.data_ptr(), B, S, H, D, n,
            int(x.dtype == torch.bfloat16),
            ssd_bwd_groups(B, -(-S // SCAN_T), H))
    return dx, dB, dC, ddt, da, dh0
