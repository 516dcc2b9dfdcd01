"""Analytic bounds from the paper (Theorems 1 & 2, Proposition 7, Remark 6).

A verbatim copy of ``repro/core/theory.py`` (pure ``math``): the query
planner inverts Theorem 1 with these, and the service reports the ε they
certify.
"""
from __future__ import annotations

import math


def mixing_term(p_T: float, t: int) -> float:
    """First term of (4): sqrt((1 − p_T)^{t+1} / p_T) — truncation penalty."""
    return math.sqrt((1.0 - p_T) ** (t + 1) / p_T)


def sampling_term(k: int, delta: float, N: int, p_s: float, p_cap: float) -> float:
    """Second term of (4): sqrt(k/δ · [1/N + (1 − p_s²)·p_∩(t)])."""
    return math.sqrt((k / delta) * (1.0 / N + (1.0 - p_s**2) * p_cap))


def epsilon_bound(
    p_T: float, t: int, k: int, delta: float, N: int, p_s: float, p_cap: float
) -> float:
    """Theorem 1: with probability ≥ 1 − δ,  μ_k(π̂) > μ_k(π) − ε with this ε."""
    return mixing_term(p_T, t) + sampling_term(k, delta, N, p_s, p_cap)


def p_cap_bound(n: int, t: int, pi_inf: float, p_T: float) -> float:
    """Theorem 2: p_∩(t) ≤ 1/n + t·‖π‖∞/p_T for uniformly-started walks."""
    return 1.0 / n + t * pi_inf / p_T


def pi_inf_powerlaw_bound(n: int, gamma: float = 0.5) -> float:
    """Proposition 7 instance: ‖π‖∞ ≤ n^{-γ} w.h.p. for θ ≈ 2.2 power laws."""
    return n ** (-gamma)


def suggested_steps(mu_k: float, p_T: float = 0.15) -> int:
    """Remark 6: t = O(log 1/μ_k(π)). Constant chosen so the mixing term is
    below μ_k/4."""
    target = (mu_k / 4.0) ** 2 * p_T
    t = math.log(target) / math.log(1.0 - p_T) - 1.0
    return max(1, math.ceil(t))


def suggested_frogs(k: int, mu_k: float, delta: float = 0.1) -> int:
    """Remark 6: N = O(k / μ_k(π)²), constant so the 1/N part of the sampling
    term is below μ_k/4 at confidence δ."""
    return max(1, math.ceil(16.0 * k / (delta * mu_k**2)))
