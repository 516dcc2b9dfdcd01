"""FrogWild-style partial synchronization of data-parallel gradients
(port of ``repro/training/grad_sync.py``): the configuration only.

The reference's ``sync_grads_shard`` and ``sync_grads_layer`` run inside a
``shard_map`` over the data axes of a mesh; they come with the mesh,
``ROADMAP.md`` Queue 1 item 8. ``TrainStepConfig(mode="partial_sync")``
raises until then.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PartialSyncConfig:
    p_s: float = 1.0
    granularity: str = "shard"      # shard | layer
    mode: str = "unbiased"          # unbiased | error_feedback (shard gran.)
