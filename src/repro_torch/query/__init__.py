"""Walk index, query engine and continuous-batching scheduler."""
from repro_torch.query.engine import (QueryPlan, WaveSpec, build_wave_program,
                                      plan_query, query_counts,
                                      sample_walk_lengths, walk_wave)
from repro_torch.query.index import (ShardedWalkIndex, WalkIndex,
                                     shard_walk_index)
from repro_torch.query.scheduler import (AdmissionDecision, QueryPartial,
                                         QueryRequest, QueryResult,
                                         QueryScheduler, RejectReason,
                                         SchedulerStats)

__all__ = [
    "AdmissionDecision",
    "QueryPartial",
    "QueryPlan",
    "QueryRequest",
    "QueryResult",
    "QueryScheduler",
    "RejectReason",
    "SchedulerStats",
    "ShardedWalkIndex",
    "WalkIndex",
    "WaveSpec",
    "build_wave_program",
    "plan_query",
    "query_counts",
    "sample_walk_lengths",
    "shard_walk_index",
    "walk_wave",
]
