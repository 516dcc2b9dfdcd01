"""The estimator and its erasure draws, exact PageRank and the
reduced-iteration baseline, the sparsification baseline, accuracy metrics,
analytic bounds and the partial-synchronization primitives over a mesh."""
from repro_torch.core import theory
from repro_torch.core.frogwild import FrogWildResult, draw_next, frogwild
from repro_torch.core.metrics import (exact_identification, mass_captured,
                                      normalized_mass_captured)
from repro_torch.core.pagerank import (pagerank_residual, power_iteration,
                                       reduced_iteration_baseline)
from repro_torch.core.partial_sync import (partial_all_to_all,
                                           partial_channel_mask,
                                           partial_psum)
from repro_torch.core.sparsify import sparsify_uniform

__all__ = [
    "FrogWildResult",
    "draw_next",
    "exact_identification",
    "frogwild",
    "mass_captured",
    "normalized_mass_captured",
    "pagerank_residual",
    "partial_all_to_all",
    "partial_channel_mask",
    "partial_psum",
    "power_iteration",
    "reduced_iteration_baseline",
    "sparsify_uniform",
    "theory",
]
