"""Distributed GAS engine: the GraphLab-PowerGraph role, over a
:class:`~repro_torch.distributed.runtime.ShardMesh` (``ROADMAP.md`` Queue 1
item 8b).

``gas.py`` runs FrogWild! supersteps over the mesh's shards with the
paper's randomized partial synchronization; ``baseline.py`` is the
distributed GraphLab-PR power iteration it is compared against;
``netcost.py`` is the wire-byte cost model (what GraphLab's network
counters measured), with ``frogwild_bytes_measured`` pricing an engine
run's own counts.
"""
from repro_torch.config import EngineConfig
from repro_torch.engine.baseline import distributed_power_iteration
from repro_torch.engine.gas import (DistributedGraph, EngineResult,
                                    build_distributed_graph,
                                    distributed_frogwild)
from repro_torch.engine.netcost import (BytesReport, frogwild_bytes_measured,
                                        frogwild_bytes_model,
                                        pagerank_bytes_model)

__all__ = [
    "BytesReport",
    "DistributedGraph",
    "EngineConfig",
    "EngineResult",
    "build_distributed_graph",
    "distributed_frogwild",
    "distributed_power_iteration",
    "frogwild_bytes_measured",
    "frogwild_bytes_model",
    "pagerank_bytes_model",
]
