"""Exact PageRank by power iteration, the GraphLab-PR baseline (port of
``repro/core/pagerank.py``).

x ← (1 − p_T)·P·x + p_T/n in float32: the ground truth of the accuracy
metrics, and, run for 1-2 iterations, the paper's reduced-iteration
comparison point. Two SpMV paths:

* ``spmv="coo"`` — ``index_add_`` over the transition edges. The
  reference sums with XLA's ``segment_sum``, in another order, so results
  agree to float32 rounding, not bit for bit.
* ``spmv="ell"`` — the hybrid ELL layout (``to_ell(g, K=32)``, built once
  per call) through ``ops.spmv``: the ``spmv_ell_slab`` CUDA kernel on the
  card plus the COO spill tail. It is the loop the reference writes
  (``pagerank.py:59-71``, starting from ``1/n_round(n)``), with the
  reference's ``ops.spmv`` in place of the module it imports, which does
  not exist (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import torch

from repro_torch.graph.csr import CSRGraph, transition_edges
from repro_torch.graph.partition import to_ell
from repro_torch.kernels import ops


def _power_iter_coo(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                    n: int, num_iters: int, p_T: float) -> torch.Tensor:
    x = torch.full((n,), 1.0 / n, dtype=torch.float32, device=w.device)
    for _ in range(num_iters):
        px = torch.zeros_like(x).index_add_(0, dst, x[src] * w)
        x = (1.0 - p_T) * px + p_T / n
    return x


def power_iteration(g: CSRGraph, num_iters: int = 50, p_T: float = 0.15,
                    spmv: str = "coo") -> torch.Tensor:
    """PageRank by power iteration on ``g``'s device (float32[n]);
    ``spmv`` is ``"coo"`` or ``"ell"``."""
    if spmv == "coo":
        src, dst, w = transition_edges(g)
        return _power_iter_coo(src, dst, w, g.n, num_iters, p_T)
    if spmv == "ell":
        ell = to_ell(g, K=32)
        x = torch.full((g.n,), 1.0 / n_round(g.n), dtype=torch.float32,
                       device=g.device)
        for _ in range(num_iters):
            px = ops.spmv(ell, x)[: g.n]
            x = (1.0 - p_T) * px + p_T / g.n
        return x
    raise ValueError(f"unknown spmv impl {spmv!r}")


def n_round(n: int, m: int = 8) -> int:
    """``n`` rounded up to a multiple of ``m``."""
    return ((n + m - 1) // m) * m


def reduced_iteration_baseline(g: CSRGraph, num_iters: int,
                               p_T: float = 0.15) -> torch.Tensor:
    """The paper's GraphLab-PR comparison point: PageRank run for 1-2
    iterations only (a good top-k approximation, much faster than
    convergence)."""
    return power_iteration(g, num_iters=num_iters, p_T=p_T)


def pagerank_residual(g: CSRGraph, x: torch.Tensor, p_T: float = 0.15
                      ) -> torch.Tensor:
    """‖Qx − x‖₁, the fixed-point residual."""
    src, dst, w = transition_edges(g)
    px = torch.zeros_like(x).index_add_(0, dst, x[src] * w)
    qx = (1.0 - p_T) * px + p_T / g.n
    return (qx - x).abs().sum()
