"""Uniform graph sparsification baseline (port of
``repro/core/sparsify.py``; paper §2.4, Figure 5).

The heuristic FrogWild is compared against: delete each edge
independently with probability ``1 − q``, then run a couple of power
iterations on what is left. Host-side numpy, the same ``default_rng``
draws as the reference, so the sparsified graph is byte-equal.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr


def sparsify_uniform(g: CSRGraph, keep_prob: float, seed: int = 0
                     ) -> CSRGraph:
    """Keeps each edge i.i.d. with probability ``keep_prob`` (q in Fig. 5)
    and returns a host-side graph; vertices that lose every out-edge are
    repaired by ``build_csr``'s dangling fix."""
    if not (0.0 < keep_prob <= 1.0):
        raise ValueError("keep_prob must be in (0, 1]")
    rng = np.random.default_rng(seed)
    keep = rng.random(g.nnz) < keep_prob
    deg = g.out_deg.cpu().numpy().astype(np.int64)
    src = np.repeat(np.arange(g.n, dtype=np.int64), deg)
    col = g.col_idx.cpu().numpy().astype(np.int64)
    return build_csr(g.n, src[keep], col[keep])
