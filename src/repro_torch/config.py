"""Layered runtime configuration: every dispatch flag defined exactly once.

The port's copy of ``repro/config.py``: the same dataclasses with the same
defaults, except the kernel flags, whose values name the port's backends:

* ``"auto"``  — (default) the hand-written CUDA kernel for CUDA tensors, the
  plain PyTorch version for CPU tensors;
* ``"cuda"``  — the CUDA kernel; a CPU tensor raises;
* ``"torch"`` — the plain PyTorch version on any device;
* ``"stream"`` (``step_impl`` only) — the streamed superstep over
  per-vertex-block slabs: its CUDA kernel for CUDA tensors, its plain
  version for CPU tensors. The reference picks it under ``"auto"`` when the
  graph outgrows a TPU core's VMEM; the card has no such budget, so here it
  is asked for by name.

``KernelConfig.draw`` picks the blocking-walk draw of the erasure models
(p_s < 1), as in the reference: ``"auto"``, ``"rejection"`` or
``"cumsum"``.

A field exists here once the port reads it: ``donate_wave_buffers`` /
``aot_warmup`` arrive with the captured wave programs (Queue 2 R2), so
passing one today is a ``TypeError``, not a setting silently ignored. The
engine's placement fields (``ShardConfig.capacity_factor`` and
``vertex_block``, :class:`EngineConfig`) came with the distributed engine
(``ROADMAP.md`` Queue 1 item 8b). ``axis_name`` stays out: the port's
mesh (:class:`~repro_torch.distributed.runtime.ShardMesh`) has one
unnamed shard axis, so nothing would read it. ``num_shards > 1`` serves a
sharded walk index on the service's one device
(``ServingConfig.sharded_dispatch``: ``"fused"`` or ``"loop"``) and sets
the channel erasure's destination shards. ``ServingConfig.checkpoint_dir``
persists and reloads the walk index, and ``RuntimeConfig.faults`` (a
:class:`~repro_torch.distributed.faults.FaultPlan`) drives the wave
supervisor's fault injection, whose timeout, retry and backoff fields
``ServingConfig`` holds.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

if TYPE_CHECKING:  # the faults module is stdlib-only, imported lazily
    from repro_torch.distributed.faults import FaultPlan

DEFAULT_NUM_FROGS = 100_000
DEFAULT_NUM_STEPS = 4
DEFAULT_P_T = 0.15
DEFAULT_P_S = 1.0

KERNEL_IMPLS = ("auto", "cuda", "torch")
STEP_IMPLS = KERNEL_IMPLS + ("stream",)
SHARDED_DISPATCHES = ("fused", "loop")
DRAWS = ("auto", "rejection", "cumsum")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Kernel dispatch flags. ``draw`` picks the erasure models' blocking
    draw (``core/frogwild.py:draw_next``), ``step_impl`` runs the walker
    superstep (``frog_step``, or ``frog_step_stream_sorted`` under
    ``"stream"``) of the batch walk and the index build, ``stitch_impl``
    the serving wave's stitch rounds (one launch a wave:
    ``stitch_gather_rounds``, or ``stitch_gather_local_rounds`` on the loop
    dispatch), ``tally_impl`` the endpoint
    histogram (``frog_count``: the batch walk's tallies and the wave
    tally)."""

    draw: str = "auto"          # auto | rejection | cumsum
    step_impl: str = "auto"     # auto | cuda | torch | stream
    stitch_impl: str = "auto"   # auto | cuda | torch
    tally_impl: str = "auto"    # auto | cuda | torch

    def __post_init__(self):
        for name, allowed in (("draw", DRAWS), ("step_impl", STEP_IMPLS),
                              ("stitch_impl", KERNEL_IMPLS),
                              ("tally_impl", KERNEL_IMPLS)):
            v = getattr(self, name)
            if v not in allowed:
                raise ValueError(
                    f"KernelConfig.{name} must be one of {allowed}, "
                    f"got {v!r}")


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Placement: ``num_shards`` range shards of the walk index, served on
    the service's one device (serving over a mesh is ROADMAP.md Queue 1
    item 8c), which are also the channel erasure's destination shards; the
    engine's per-channel buffer slack ``capacity_factor`` and the slab
    width ``vertex_block`` of its streamed step (Queue 1 item 8b); and the
    PRNG seed."""

    num_shards: int = 1
    capacity_factor: float = 4.0     # engine per-channel buffer slack (≥ 1)
    vertex_block: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(
                f"num_shards must be ≥ 1, got {self.num_shards}")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Walk-index geometry and scheduler shapes.

    ``build_shards`` is the index-build partitioning: it bounds the walkers
    alive per build step and, with the per-vertex key streams, leaves the
    slab content unchanged. ``walk_buckets`` / ``query_buckets`` override
    the wave-shape ladder (each wave runs at the smallest bucket that fits
    its allocation; ``None`` = the cap and its halvings).
    ``sharded_dispatch`` picks the wave over a sharded index: ``"fused"``,
    one gather per round over the stacked blocks, or ``"loop"``, one
    per-shard round per shard, byte-equal to it. ``checkpoint_dir`` makes
    the service persist and reuse the index through ``checkpoint/``
    atomic step dirs.

    The supervision fields govern the scheduler's waves: a wave that
    raises a transient fault or exceeds ``wave_timeout_s`` is retried up
    to ``max_retries`` times from the same key, after a backoff of
    ``backoff_base_s · 2^(attempt − 1)`` clamped to ``backoff_max_s``
    (× a seeded jitter in [0.5, 1.5)), then fails with ``WaveFailedError``;
    a permanent shard fault evicts the shard and serves degraded waves.
    """

    segments_per_vertex: int = 16    # R — endpoints stored per vertex
    segment_len: int = 4             # L — steps per precomputed segment
    build_shards: int = 8            # index-build partitioning
    max_walks: int = 8192            # walk slots per wave
    max_queries: int = 8             # query slots per wave
    max_steps: int = 32              # walk-truncation cap for query plans
    checkpoint_dir: Optional[str] = None
    wave_time_estimate_s: Optional[float] = None  # seeds the admission EMA
    wave_timeout_s: Optional[float] = None  # per-wave deadline (None = off)
    max_retries: int = 2             # bounded retry of a faulted wave
    backoff_base_s: float = 0.02     # exponential backoff: base · 2^(a−1)
    backoff_max_s: float = 0.5       # … clamped here (± jitter)
    walk_buckets: Optional[Tuple[int, ...]] = None
    query_buckets: Optional[Tuple[int, ...]] = None
    sharded_dispatch: str = "fused"  # fused | loop

    def __post_init__(self):
        if self.sharded_dispatch not in SHARDED_DISPATCHES:
            raise ValueError(
                f"sharded_dispatch must be 'fused' or 'loop', got "
                f"{self.sharded_dispatch!r}")


_KERNEL = KernelConfig()
_SHARD = ShardConfig()
_SERVING = ServingConfig()


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The one config :class:`repro_torch.service.FrogWildService` reads."""

    num_frogs: int = DEFAULT_NUM_FROGS
    num_steps: int = DEFAULT_NUM_STEPS
    p_T: float = DEFAULT_P_T
    p_s: float = DEFAULT_P_S
    erasure: str = "none"            # none | independent | channel
    kernel: KernelConfig = _KERNEL
    runtime: ShardConfig = _SHARD
    serving: ServingConfig = _SERVING
    faults: Optional["FaultPlan"] = None

    def __post_init__(self):
        from repro_torch.distributed.faults import FaultPlan
        if self.faults is not None and not isinstance(self.faults,
                                                      FaultPlan):
            raise TypeError(f"faults must be a FaultPlan, got "
                            f"{type(self.faults).__name__}")

    def frogwild(self) -> "FrogWildConfig":
        return FrogWildConfig(
            num_frogs=self.num_frogs, num_steps=self.num_steps,
            p_T=self.p_T, p_s=self.p_s, erasure=self.erasure,
            num_shards=max(1, self.runtime.num_shards),
            draw=self.kernel.draw, step_impl=self.kernel.step_impl,
            tally_impl=self.kernel.tally_impl,
        )

    def engine(self) -> "EngineConfig":
        return EngineConfig(
            num_frogs=self.num_frogs, num_steps=self.num_steps,
            p_T=self.p_T, p_s=self.p_s,
            capacity_factor=self.runtime.capacity_factor,
            draw=self.kernel.draw, step_impl=self.kernel.step_impl,
        )

    def walk_index(self) -> "WalkIndexConfig":
        return WalkIndexConfig(
            segments_per_vertex=self.serving.segments_per_vertex,
            segment_len=self.serving.segment_len,
            num_shards=self.serving.build_shards,
            step_impl=self.kernel.step_impl,
            seed=self.runtime.seed,
        )


@dataclasses.dataclass(frozen=True)
class FrogWildConfig:
    """Walker view (``core/frogwild.py``). ``num_shards`` is the channel
    erasure's granularity (destination range shards); ``tally_impl`` runs
    the walk's tallies, which the reference does with XLA scatters."""

    num_frogs: int = DEFAULT_NUM_FROGS
    num_steps: int = DEFAULT_NUM_STEPS
    p_T: float = DEFAULT_P_T
    p_s: float = DEFAULT_P_S
    erasure: str = "none"            # none | independent | channel
    num_shards: int = 16             # channel model: destination shards
    draw: str = _KERNEL.draw
    step_impl: str = _KERNEL.step_impl
    tally_impl: str = _KERNEL.tally_impl


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Distributed-engine view (``engine/gas.py``); the shard count comes
    from the mesh, not the config. ``step_impl`` runs the plain (p_s = 1)
    superstep through ``ops.frog_step``: ``"auto"`` (the resident kernel on
    the card, its plain version on the CPU), ``"cuda"`` or ``"stream"``
    (needs the graph's slabs, ``build_distributed_graph(...,
    vertex_block=)``); ``"torch"`` runs the reference's unfused ``"xla"``
    program (a scatter tally, then the draw). At p_s < 1 the blocking draw
    ``draw`` moves the frogs, so ``"cuda"`` and ``"stream"`` raise there
    and ``"auto"`` / ``"torch"`` take the draw paths, as the erasure walks
    of ``core/frogwild.py`` do."""

    num_frogs: int = DEFAULT_NUM_FROGS
    num_steps: int = DEFAULT_NUM_STEPS
    p_T: float = DEFAULT_P_T
    p_s: float = DEFAULT_P_S
    capacity_factor: float = _SHARD.capacity_factor
    draw: str = _KERNEL.draw
    step_impl: str = _KERNEL.step_impl

    def __post_init__(self):
        if self.draw not in DRAWS:
            raise ValueError(f"EngineConfig.draw must be one of {DRAWS}, "
                             f"got {self.draw!r}")
        if self.step_impl not in STEP_IMPLS:
            raise ValueError(f"EngineConfig.step_impl must be one of "
                             f"{STEP_IMPLS}, got {self.step_impl!r}")


@dataclasses.dataclass(frozen=True)
class WalkIndexConfig:
    """Index-build view (``query/index.py``)."""

    segments_per_vertex: int = _SERVING.segments_per_vertex
    segment_len: int = _SERVING.segment_len
    num_shards: int = _SERVING.build_shards
    step_impl: str = _KERNEL.step_impl
    seed: int = _SHARD.seed


__all__ = [
    "KernelConfig",
    "ShardConfig",
    "ServingConfig",
    "RuntimeConfig",
    "FrogWildConfig",
    "EngineConfig",
    "WalkIndexConfig",
]
