from repro_torch.graph.csr import (CSRGraph, build_csr, load_graph,
                                   save_graph, transition_edges,
                                   uniform_successor)
from repro_torch.graph.generators import (chung_lu_powerlaw, ring_of_cliques,
                                          uniform_random)
from repro_torch.graph.partition import (EllGraph, VertexPartition,
                                         partition_graph, to_ell)

__all__ = [
    "CSRGraph",
    "EllGraph",
    "VertexPartition",
    "build_csr",
    "chung_lu_powerlaw",
    "load_graph",
    "partition_graph",
    "ring_of_cliques",
    "save_graph",
    "to_ell",
    "transition_edges",
    "uniform_random",
    "uniform_successor",
]
