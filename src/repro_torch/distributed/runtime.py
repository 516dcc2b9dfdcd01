"""Shard-execution runtime (port of the host-loop part of
``repro/distributed/runtime.py``).

A :class:`ShardRuntime` says how a per-shard program runs. Here it always
runs as a host loop over the shard ids on the caller's one device
(:meth:`ShardRuntime.map_shards`), with the sums across shards taken on
that device. The mesh the reference builds with ``shard_map`` over several
devices, and the ``axis_name`` that names its axis, become
``torch.distributed`` with ROADMAP.md Queue 1 item 8; until then no
runtime spans several cards, so a machine with several never spreads
shards across them behind the caller's back. The reference's checkpoint
round-trip comes with item 10 and its compiled-wave cache has no
counterpart (the port runs its waves eagerly).
"""
from __future__ import annotations

import dataclasses
from typing import Callable


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
