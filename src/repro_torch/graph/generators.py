"""Synthetic graph generators (numpy copy of ``repro/graph/generators.py``).

Same seeds, same numpy calls in the same order, so each generator returns
arrays identical to the reference's. ``chung_lu_powerlaw`` gives the
power-law in-degree (and hence power-law PageRank, θ ≈ 2.2) the paper's
analysis leans on. Graphs are built on the host; move them with
:meth:`CSRGraph.to`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr


def chung_lu_powerlaw(n: int, avg_out_deg: float = 16.0, theta: float = 2.2,
                      seed: int = 0, self_loops: bool = False) -> CSRGraph:
    """Directed Chung–Lu-style graph: vertex ``i`` receives edges with
    probability ∝ ``(i + 1)^(-1/(theta - 1))`` (ids permuted so hubs are
    scattered); out-degrees are ``1 + Poisson(avg_out_deg - 1)``."""
    rng = np.random.default_rng(seed)
    out_deg = 1 + rng.poisson(max(avg_out_deg - 1.0, 0.0), size=n)
    m = int(out_deg.sum())
    src = np.repeat(np.arange(n, dtype=np.int64), out_deg)

    alpha = 1.0 / (theta - 1.0)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-alpha)
    perm = rng.permutation(n)
    w = w[perm.argsort()]
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    dst = np.searchsorted(cdf, rng.random(m), side="left").astype(np.int64)
    dst = np.minimum(dst, n - 1)
    if not self_loops:
        loop = dst == src
        dst[loop] = (dst[loop] + 1) % n
    return build_csr(n, src, dst)


def uniform_random(n: int, avg_out_deg: float = 8.0, seed: int = 0
                   ) -> CSRGraph:
    """Erdős–Rényi-style directed graph: destinations uniform over [n]."""
    rng = np.random.default_rng(seed)
    out_deg = 1 + rng.poisson(max(avg_out_deg - 1.0, 0.0), size=n)
    src = np.repeat(np.arange(n, dtype=np.int64), out_deg)
    dst = rng.integers(0, n, size=src.shape[0], dtype=np.int64)
    loop = dst == src
    dst[loop] = (dst[loop] + 1) % n
    return build_csr(n, src, dst)


def ring_of_cliques(num_cliques: int, clique_size: int) -> CSRGraph:
    """Cliques joined in a ring (deterministic test graph)."""
    n = num_cliques * clique_size
    src_l: list[int] = []
    dst_l: list[int] = []
    for c in range(num_cliques):
        base = c * clique_size
        for i in range(clique_size):
            for j in range(clique_size):
                if i != j:
                    src_l.append(base + i)
                    dst_l.append(base + j)
        src_l.append(base)
        dst_l.append(((c + 1) % num_cliques) * clique_size)
    return build_csr(n, np.asarray(src_l), np.asarray(dst_l))
