"""The estimator, exact PageRank, accuracy metrics and analytic bounds."""
from repro_torch.core import theory
from repro_torch.core.frogwild import FrogWildResult, frogwild
from repro_torch.core.metrics import (exact_identification, mass_captured,
                                      normalized_mass_captured)
from repro_torch.core.pagerank import pagerank_residual, power_iteration

__all__ = [
    "FrogWildResult",
    "exact_identification",
    "frogwild",
    "mass_captured",
    "normalized_mass_captured",
    "pagerank_residual",
    "power_iteration",
    "theory",
]
