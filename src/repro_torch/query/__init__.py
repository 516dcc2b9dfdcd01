"""Walk index, query engine and continuous-batching scheduler (port of
``repro/query``). The front door is :class:`repro_torch.FrogWildService`;
these are the modules under it:

* ``index.py``     — the offline walk-segment index (``WalkIndex``, or
                     ``ShardedWalkIndex`` blocks), its persistence and
                     repair;
* ``engine.py``    — online stitching and Theorem 1 planning;
* ``scheduler.py`` — continuous batching with deadline-aware admission.

``__all__`` is the reference's, less its deprecated build shims
(``build_walk_index`` and ``build_walk_index_sharded``, which the port
does not carry: its builds go through the service). The wave program
(``engine.WaveSpec``, ``engine.build_wave_program``) stays importable
from ``repro_torch.query.engine``.
"""
from repro_torch.config import WalkIndexConfig
from repro_torch.query.engine import (QueryPlan, plan_query, query_counts,
                                      sample_walk_lengths, walk_wave)
from repro_torch.query.index import (ShardedWalkIndex, WalkIndex,
                                     load_or_repair_walk_index,
                                     load_walk_index, rebuild_shard_blocks,
                                     save_walk_index, save_walk_index_shard,
                                     shard_walk_index)
from repro_torch.query.scheduler import (AdmissionDecision, QueryPartial,
                                         QueryRequest, QueryResult,
                                         QueryScheduler, RejectReason,
                                         SchedulerStats)

__all__ = [
    "ShardedWalkIndex",
    "WalkIndex",
    "WalkIndexConfig",
    "load_or_repair_walk_index",
    "load_walk_index",
    "rebuild_shard_blocks",
    "save_walk_index",
    "save_walk_index_shard",
    "shard_walk_index",
    "QueryPlan",
    "plan_query",
    "query_counts",
    "sample_walk_lengths",
    "walk_wave",
    "AdmissionDecision",
    "QueryPartial",
    "QueryRequest",
    "QueryResult",
    "QueryScheduler",
    "RejectReason",
    "SchedulerStats",
]
