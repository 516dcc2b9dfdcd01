"""Exact PageRank by power iteration, the ground truth for the accuracy
metrics (port of ``repro/core/pagerank.py``, COO path).

x ← (1 − p_T)·P·x + p_T/n in float32. The reference sums each iteration
with XLA's ``segment_sum``; here it is ``index_add_``, which sums in
another order, so results agree to float32 rounding, not bit for bit. The
ELL path (``spmv="ell"``) waits for the SpMV slice.
"""
from __future__ import annotations

import torch

from repro_torch.graph.csr import CSRGraph, transition_edges


def _power_iter_coo(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                    n: int, num_iters: int, p_T: float) -> torch.Tensor:
    x = torch.full((n,), 1.0 / n, dtype=torch.float32, device=w.device)
    for _ in range(num_iters):
        px = torch.zeros_like(x).index_add_(0, dst, x[src] * w)
        x = (1.0 - p_T) * px + p_T / n
    return x


def power_iteration(g: CSRGraph, num_iters: int = 50, p_T: float = 0.15,
                    spmv: str = "coo") -> torch.Tensor:
    """PageRank by power iteration on ``g``'s device (float32[n])."""
    if spmv != "coo":
        raise NotImplementedError(
            f"spmv={spmv!r} is not ported to repro_torch yet (ROADMAP.md "
            f"Queue 1 item 13, SpMV baseline)")
    src, dst, w = transition_edges(g)
    return _power_iter_coo(src, dst, w, g.n, num_iters, p_T)


def pagerank_residual(g: CSRGraph, x: torch.Tensor, p_T: float = 0.15
                      ) -> torch.Tensor:
    """‖Qx − x‖₁, the fixed-point residual."""
    src, dst, w = transition_edges(g)
    px = torch.zeros_like(x).index_add_(0, dst, x[src] * w)
    qx = (1.0 - p_T) * px + p_T / g.n
    return (qx - x).abs().sum()
