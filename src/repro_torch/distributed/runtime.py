"""Shard-execution runtime (port of the host-loop part and the per-shard
checkpoint round-trip of ``repro/distributed/runtime.py``).

A :class:`ShardRuntime` says how a per-shard program runs. Here it always
runs as a host loop over the shard ids on the caller's one device
(:meth:`ShardRuntime.map_shards`), with the sums across shards taken on
that device. The mesh the reference builds with ``shard_map`` over several
devices, and the ``axis_name`` that names its axis, become
``torch.distributed`` with ROADMAP.md Queue 1 item 8; until then no
runtime spans several cards, so a machine with several never spreads
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

from repro_torch.checkpoint import (CheckpointCorruptError, latest_step,
                                    save_checkpoint)
from repro_torch.checkpoint.checkpointer import read_checkpoint
from repro_torch.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class ShardRuntime:
    """Dispatch context for per-shard programs: ``num_shards`` shards run
    one after another on one device."""

    num_shards: int

    @classmethod
    def acquire(cls, num_shards: int) -> "ShardRuntime":
        """A host-loop runtime for ``num_shards`` shards."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be ≥ 1, got {num_shards}")
        return cls(num_shards=num_shards)

    @property
    def is_mesh(self) -> bool:
        return False

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
