"""Shard-execution runtime (port of ``repro/distributed/runtime.py``): the
mesh, its collectives, the host-loop dispatch and the per-shard checkpoint
round-trip.

:class:`ShardMesh` takes the place of the reference's one-axis ``Mesh``
wherever an entry point takes ``mesh=``: ``S`` range shards spread over the
ranks of a ``torch.distributed`` process group, each rank holding ``S /
world`` contiguous shards stacked on axis 0 on its own device. With no group
every shard lives in the calling process. Its collectives keep the
reference's semantics on those stacked ``[S_local, ...]`` tensors: without
a group they are device ops (a sum, a transpose, a reshape); with one, the
local part is, and the exchange goes through ``dist.all_reduce``,
``dist.all_to_all_single`` and ``dist.all_gather_into_tensor`` (a group of
one rank included). The reference's ``axis_name`` has no
counterpart: the mesh has one shard axis.

A :class:`ShardRuntime` says how a per-shard program runs: over a mesh
(:meth:`ShardRuntime.for_mesh`, the engine's entry), or as a host loop
over the shard ids on the caller's one device
(:meth:`ShardRuntime.map_shards`, sharded serving). Serving over a mesh is
``ROADMAP.md`` Queue 1 item 8c; a machine with several cards never spreads
shards across them behind the caller's back. The reference's
compiled-wave cache has no counterpart (the port runs its waves eagerly).

The module-level helpers persist and restore one atomic checkpoint dir
per shard (``<dir>/shard_<s>/step_<k>/``), so a sharded index can be
written, verified and repaired one shard at a time without exposing a
torn artifact.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import prng
from repro_torch.checkpoint import (CheckpointCorruptError, latest_step,
                                    save_checkpoint)
from repro_torch.checkpoint.checkpointer import read_checkpoint
from repro_torch.device import DeviceLike, on_device, resolve_device

# the device type each process-group backend moves tensors of
_BACKEND_DEVICE = {"gloo": "cpu", "nccl": "cuda"}


class ShardMesh:
    """``num_shards`` range shards over the ranks of ``group`` (``None``:
    all in this process), each rank's ``num_shards / world`` contiguous
    shards stacked on axis 0 of its tensors on ``device`` (default: the
    card; raises without one).

    A group of a size that does not divide ``num_shards``, or whose backend
    does not move tensors of ``device``'s type (gloo: CPU, NCCL: CUDA),
    raises: no collective copies between devices behind the caller's back.
    """

    def __init__(self, num_shards: int, device: DeviceLike = None,
                 group=None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be ≥ 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.device = resolve_device(device)
        self.group = group
        if group is None:
            self.world, self.rank = 1, 0
        else:
            import torch.distributed as dist
            backend = str(dist.get_backend(group)).lower()
            want = _BACKEND_DEVICE.get(backend)
            if want != self.device.type:
                raise ValueError(
                    f"a {backend} process group moves "
                    f"{want or 'unknown'} tensors, the mesh's device is "
                    f"{self.device}")
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        if self.num_shards % self.world:
            raise ValueError(
                f"{self.num_shards} shards do not split over a process "
                f"group of {self.world} ranks")

    @property
    def shards_per_rank(self) -> int:
        return self.num_shards // self.world

    @property
    def first_shard(self) -> int:
        """The id of this rank's first shard."""
        return self.rank * self.shards_per_rank

    def local(self, stacked: torch.Tensor) -> torch.Tensor:
        """This rank's shards of an ``[S, ...]`` stack, on the mesh's
        device."""
        if stacked.shape[0] != self.num_shards:
            raise ValueError(f"leading dim {stacked.shape[0]} != "
                             f"num_shards {self.num_shards}")
        lo = self.first_shard
        return stacked[lo:lo + self.shards_per_rank].to(self.device)

    def _check(self, name: str, x: torch.Tensor, ndim: int = 1) -> None:
        if x.dim() < ndim or x.shape[0] != self.shards_per_rank:
            raise ValueError(
                f"{name}: wanted [{self.shards_per_rank}, ...] stacked "
                f"shards, got shape {list(x.shape)}")
        if not on_device(x, self.device):
            raise ValueError(f"{name}: tensor on {x.device}, the mesh's "
                             f"device is {self.device}")

    # --- collectives (the reference's, on stacked shards) ----------------

    def axis_index(self) -> torch.Tensor:
        """int32[S_local]: each local shard's id (``lax.axis_index``)."""
        lo = self.first_shard
        return torch.arange(lo, lo + self.shards_per_rank,
                            dtype=torch.int32, device=self.device)

    def shard_key(self, key: torch.Tensor) -> torch.Tensor:
        """``[S_local, 2]``: ``fold_in(key, shard id)`` for each local
        shard, the reference's per-shard stream."""
        return prng.fold_in(key, self.axis_index())

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the sum over every shard, replicated back to each
        (``[S_local, ...]``)."""
        self._check("psum", x)
        total = x.sum(0, keepdim=True, dtype=x.dtype)
        if self.group is not None:
            import torch.distributed as dist
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        return total.expand_as(x).contiguous()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all`` (``split_axis=concat_axis=0``, untiled):
        block ``x[s, d]`` of shard ``s`` goes to shard ``d``, so
        ``out[d, s]`` on shard ``d`` is what shard ``s`` sent it
        (``[S_local, S, ...] → [S_local, S, ...]``)."""
        self._check("all_to_all", x, 2)
        S, Sl = self.num_shards, self.shards_per_rank
        if x.shape[1] != S:
            raise ValueError(f"all_to_all: wanted [{Sl}, {S}, ...], got "
                             f"{list(x.shape)}")
        if self.group is None:
            return x.transpose(0, 1).contiguous()
        import torch.distributed as dist
        rest = tuple(x.shape[2:])
        # [src, dst rank, dst local, ...] → one contiguous block a rank
        send = x.reshape((Sl, self.world, Sl) + rest).transpose(0, 1)
        send = send.contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        # recv[src rank, src local, dst local] → out[dst local, src]
        perm = (2, 0, 1) + tuple(range(3, recv.dim()))
        return recv.permute(perm).reshape((Sl, S) + rest)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather(tiled=True)``: every shard's block, concatenated
        (``[S_local, m, ...] → [S_local, S·m, ...]``). The local shards
        share one gathered tensor (a broadcast view)."""
        self._check("all_gather", x)
        Sl = self.shards_per_rank
        block = x.contiguous()
        if self.group is not None:
            import torch.distributed as dist
            out = torch.empty((self.world * Sl,) + tuple(block.shape[1:]),
                              dtype=block.dtype, device=block.device)
            dist.all_gather_into_tensor(out, block, group=self.group)
            block = out
        full = block.reshape((1, -1) + tuple(x.shape[2:]))
        return full.expand((Sl,) + tuple(full.shape[1:]))


@dataclasses.dataclass(frozen=True)
class ShardRuntime:
    """Dispatch context for per-shard programs: over a :class:`ShardMesh`
    (``mesh``), or ``num_shards`` shards one after another on one device
    (``mesh is None``)."""

    num_shards: int
    mesh: Optional[ShardMesh] = None

    @classmethod
    def acquire(cls, num_shards: int) -> "ShardRuntime":
        """A host-loop runtime for ``num_shards`` shards."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be ≥ 1, got {num_shards}")
        return cls(num_shards=num_shards)

    @classmethod
    def for_mesh(cls, mesh: ShardMesh) -> "ShardRuntime":
        """Adopts an existing mesh (the engine's entry point)."""
        if not isinstance(mesh, ShardMesh):
            raise TypeError(f"mesh must be a ShardMesh, got "
                            f"{type(mesh).__name__}")
        return cls(num_shards=mesh.num_shards, mesh=mesh)

    @property
    def is_mesh(self) -> bool:
        return self.mesh is not None

    @staticmethod
    def shard_key(key: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
        """``fold_in(key, shard id)`` for each of ``mesh``'s local shards:
        each shard draws an independent stream that does not depend on
        how the shards spread over ranks."""
        return mesh.shard_key(key)

    @staticmethod
    def key_data(key: torch.Tensor) -> torch.Tensor:
        return prng.key_data(key)

    def map_shards(self, program: Callable, *args, **kwargs) -> list:
        """Runs ``program(shard_id, *args, **kwargs)`` for every shard id
        in order and returns the per-shard results."""
        return [program(s, *args, **kwargs) for s in range(self.num_shards)]


# --- per-shard checkpoint round-trip ----------------------------------------


def shard_dir(directory: str, shard: int) -> str:
    return os.path.join(directory, f"shard_{shard:04d}")


def list_shard_dirs(directory: str) -> list:
    """Sorted shard subdirectories under ``directory`` (empty if none —
    i.e. the directory holds a monolithic checkpoint or nothing)."""
    if not os.path.isdir(directory):
        return []
    return sorted(d for d in os.listdir(directory) if d.startswith("shard_"))


def save_shard_checkpoint(directory: str, shard: int, tree: Any,
                          step: int = 0) -> str:
    """Atomic save of one shard's tree under ``<dir>/shard_<s>/step_<k>/``."""
    return save_checkpoint(shard_dir(directory, shard), step, tree)


def load_checkpoint_tree(directory: str, step: Optional[int] = None,
                         device: DeviceLike = None) -> dict:
    """Self-describing restore: ``{leaf path: tensor on device}`` (default:
    the card) from the checkpoint's own ``tree.json``, so callers need not
    know shapes up front.

    A missing checkpoint raises :class:`FileNotFoundError`; a present but
    torn or corrupt one raises :class:`~repro_torch.checkpoint.
    CheckpointCorruptError` naming the step dir.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory!r}")
    meta, leaves = read_checkpoint(directory, step, device)
    return dict(zip(meta["paths"], leaves))


def quarantine_shard_dir(directory: str, shard: int) -> str:
    """Moves a corrupt shard checkpoint dir aside (``quarantine.shard_<s>``
    — invisible to :func:`list_shard_dirs`) so a rebuild can atomically
    write a fresh one in its place. Returns the quarantine path."""
    src = shard_dir(directory, shard)
    dst = os.path.join(directory, f"quarantine.shard_{shard:04d}")
    k = 0
    while os.path.exists(dst):
        k += 1
        dst = os.path.join(directory, f"quarantine.shard_{shard:04d}.{k}")
    os.rename(src, dst)
    return dst


def load_shard_checkpoints(directory: str, step: Optional[int] = None,
                           on_error: str = "raise",
                           device: DeviceLike = None) -> Dict[int, Any]:
    """Restores every shard checkpoint under ``directory`` onto ``device``
    (default: the card) → ``{shard index from the dir name: tree}``.
    Whether the shards agree and none is missing is the caller's to check.

    ``on_error="raise"`` propagates the first corrupt or partial shard;
    ``on_error="collect"`` maps each failing shard to its exception
    instead, so a caller can quarantine and rebuild exactly the broken
    shards.
    """
    if on_error not in ("raise", "collect"):
        raise ValueError(f"on_error must be 'raise' or 'collect', "
                         f"got {on_error!r}")
    dirs = list_shard_dirs(directory)
    if not dirs:
        raise FileNotFoundError(f"no shard checkpoints under {directory!r}")
    out: Dict[int, Any] = {}
    for d in dirs:
        shard = int(d.split("_")[1])
        try:
            out[shard] = load_checkpoint_tree(os.path.join(directory, d),
                                              step, device)
        except (CheckpointCorruptError, FileNotFoundError) as e:
            if on_error == "raise":
                raise
            out[shard] = e
    return out
