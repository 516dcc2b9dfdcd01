"""FrogWild! walker estimator, plain (p_s = 1) path (port of
``repro/core/frogwild.py``).

N frogs start uniformly at random, take at most ``t`` steps along P, die
with probability ``p_T`` at each apply() and are tallied where they stop;
π̂ = c/N (Definition 5). Every superstep runs through ``ops.frog_step``
(the fused CUDA kernel on the card, or with ``step_impl="stream"`` the
streamed kernel over the graph's :class:`BlockedCSR` slabs, built once per
run or passed in) and the cut-off tally through ``ops.frog_count``. The
key stream is the reference's, so counts and ``pi_hat`` are byte-equal to
``repro.core.frogwild`` for the same key.
Erasure models (p_s < 1) come with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.config import FrogWildConfig
from repro_torch.device import DeviceLike
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import ops
from repro_torch.kernels.frog_step_stream import BlockedCSR, blocked_csr_of


@dataclasses.dataclass
class FrogWildResult:
    counts: torch.Tensor              # int32[n] — c(i), frogs stopped at i
    pi_hat: torch.Tensor              # f32[n]   — counts / N (Definition 5)
    num_frogs: int


def _frogwild_walks(g: CSRGraph, cfg: FrogWildConfig, key: torch.Tensor,
                    blocked: Optional[BlockedCSR] = None) -> FrogWildResult:
    """Runs the FrogWild! process on ``g``'s device with ``key`` (a key on
    the same device) and returns the stop-counter estimator. ``blocked``
    is ``g``'s slab layout for ``step_impl="stream"`` (built here when not
    given)."""
    n = g.n
    N, t = cfg.num_frogs, cfg.num_steps
    if cfg.step_impl == "stream" and blocked is None:
        blocked = blocked_csr_of(g)
    k_init, k_loop = prng.split(key)
    pos = prng.randint(k_init, (N,), 0, n)
    alive = torch.ones(N, dtype=torch.bool, device=pos.device)
    counts = torch.zeros(n, dtype=torch.int32, device=pos.device)
    for step_key in prng.split(k_loop, t):
        k_die, k_move = prng.split(step_key)
        # apply(): each arriving frog dies w.p. p_T and is tallied here.
        die = prng.bernoulli(k_die, cfg.p_T, (N,)) & alive
        slot_bits = prng.randint(k_move, (N,), 0, 1 << 30)
        nxt, death_counts = ops.frog_step(
            pos, die, slot_bits, g.row_ptr, g.col_idx, g.out_deg, n,
            impl=cfg.step_impl, blocked=blocked)
        counts += death_counts
        alive &= ~die
        pos = torch.where(alive, nxt, pos)
    # cut-off at t: all surviving frogs halt and are tallied (Process 15).
    counts += ops.frog_count(torch.where(alive, pos, -1), n,
                             impl=cfg.tally_impl)
    pi_hat = counts.to(torch.float32) / N
    return FrogWildResult(counts=counts, pi_hat=pi_hat, num_frogs=N)


def compiled_estimate(res: FrogWildResult) -> FrogWildResult:
    """``res`` with ``pi_hat`` as the reference's jitted entry points
    (``frogwild``, ``FrogWildService.pagerank``) return it: XLA compiles
    ``counts / N`` into a multiply by the float32 reciprocal of ``N``, which
    differs from a true division in the last bit for some counts. The
    counts are the same either way."""
    inv = torch.tensor(1.0 / res.num_frogs, dtype=torch.float32,
                       device=res.counts.device)
    return dataclasses.replace(res, pi_hat=res.counts.to(torch.float32) * inv)


def frogwild(g: CSRGraph, cfg: FrogWildConfig, seed: int = 0,
             device: DeviceLike = None) -> FrogWildResult:
    """The estimator from ``PRNGKey(seed)`` on ``device`` (default: the
    card)."""
    key = prng.PRNGKey(seed, device)
    return compiled_estimate(_frogwild_walks(g.to(key.device), cfg, key))
