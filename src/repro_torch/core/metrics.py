"""Top-k accuracy metrics (paper Definition 2 and §2.1.1).

* ``mass_captured``: μ_k(v) = π(argmax_{|S|=k} v(S)), the true PageRank
  mass of the k vertices the estimate ranks highest.
* ``exact_identification``: |top_k(v) ∩ top_k(π)| / k.

Ties rank the lower index first, as ``jax.lax.top_k`` does; a stable
descending sort gives that order, ``torch.topk`` does not promise it.
"""
from __future__ import annotations

import torch


def topk_set(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of ``v`` (ties: lower index first)."""
    return torch.sort(v, descending=True, stable=True).indices[:k]


def mass_captured(estimate: torch.Tensor, pi: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """μ_k(estimate) per paper Definition 2."""
    return pi[topk_set(estimate, k)].sum()


def normalized_mass_captured(estimate: torch.Tensor, pi: torch.Tensor,
                             k: int) -> torch.Tensor:
    """μ_k(estimate) / μ_k(π) ∈ [0, 1], the paper's plotted accuracy."""
    return mass_captured(estimate, pi, k) / mass_captured(pi, pi, k)


def exact_identification(estimate: torch.Tensor, pi: torch.Tensor, k: int
                         ) -> torch.Tensor:
    """Fraction of the true top-k list recovered (paper Fig. 2b)."""
    a = topk_set(estimate, k)
    b = topk_set(pi, k)
    return (a[:, None] == b[None, :]).any(dim=1).float().mean()
