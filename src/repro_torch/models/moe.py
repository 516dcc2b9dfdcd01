"""Mixture-of-Experts block: top-k router and capacity dispatch (port of
``repro/models/moe.py``).

``moe_forward`` computes what the reference's does, in the order that
decides the result:

* routing groups: a sequence longer than 4,096 tokens is halved while it
  is even, each part a group with its own capacity
  ``C = capacity(cfg, group length)``;
* the router: logits in the compute dtype, then a float32 softmax with
  masked experts at ``-inf``, and the top k by a stable descending sort,
  so ties go to the lower expert index as ``lax.top_k``'s do
  (``torch.topk`` leaves their order open); the k weights renormalised
  by ``max(sum, 1e-9)``;
* dispatch: per group, a stable sort of the (token, pick) pairs by
  expert (``jnp.argsort`` is stable), each pair's rank inside its expert,
  and the pairs at rank ``>= C`` dropped, so the dropped set, and
  ``dropped``, are the reference's;
* the experts: three batched products over the ``[E, groups * C, d]``
  buffer in the compute dtype (the reference's are XLA einsums, outside
  any Pallas kernel);
* combine: each kept pair's output times its weight, summed over the k
  picks in top-k order, a fixed order (``index_add_`` on the card is not
  deterministic in bf16).

Groups are dispatched in chunks of the batch, as the reference's scan
does, to bound the transients; the chunks change no value. The
reference's sharding constraints are the identity on one device and its
``jax.checkpoint`` is for training; neither is ported. The stages run
under ``torch.profiler.record_function`` ranges (``moe.route``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``), by which a trace
splits the layer's device time.

``expert_mask`` is the reference's partial-synchronisation hook: the
experts it leaves out take no token (the FrogWild! channel lottery
applied to expert dispatch), and their tokens fall through to the next
best experts.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (compute_weight, dense_init, dtype_of,
                                       pdtype_of)
from repro_torch.models.mlp import ACTIVATIONS

GROUP_MAX = 4096


class MoE(nn.Module):
    """``router [E, d]`` (the reference's ``[d, E]`` transposed, as every
    dense matrix is); ``w_gate`` / ``w_up [E, d, f]`` and ``w_down
    [E, f, d]`` in the reference's layout, which the batched products
    take as they are."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        pd = pdtype_of(cfg)
        self.router = dense_init((E, d), pd, device, generator)
        self.w_gate = dense_init((E, d, f), pd, device, generator, fan_in=d)
        self.w_up = dense_init((E, d, f), pd, device, generator, fan_in=d)
        self.w_down = dense_init((E, f, d), pd, device, generator, fan_in=f)


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Slots per expert in a group of ``num_tokens``: ``ceil(tokens · k /
    E · factor)`` rounded up to a multiple of 8, at least 8."""
    c = num_tokens * cfg.num_experts_per_tok / cfg.num_experts
    c = math.ceil(c * cfg.moe_capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def group_size(seq: int) -> int:
    """The routing group's length: ``seq`` halved while above 4,096 and
    even."""
    while seq > GROUP_MAX and seq % 2 == 0:
        seq //= 2
    return seq


def route(params: MoE, x: torch.Tensor, cfg: ModelConfig,
          expert_mask: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x [..., d]`` → (float32 router probabilities ``[..., E]``, the
    top-k weights renormalised ``[..., k]``, their experts ``[..., k]``,
    ties to the lower index)."""
    logits = F.linear(x, compute_weight(params, "router", cfg)).float()
    if expert_mask is not None:
        keep = expert_mask.to(device=logits.device, dtype=torch.bool)
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def _dispatch_combine(params: MoE, x: torch.Tensor, top_e: torch.Tensor,
                      top_p: torch.Tensor, cfg: ModelConfig, C: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of ``G`` groups: ``x [G, S, d]``, ``top_e`` / ``top_p
    [G, S, k]`` → (the mixture ``[G, S, d]`` in the compute dtype, the
    number of dropped pairs)."""
    G, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    dt, dev = dtype_of(cfg), x.device
    n, slots = S * k, E * G * C
    with record_function("moe.dispatch"):
        e_s, order = torch.sort(top_e.reshape(G, n), dim=1, stable=True)
        experts = torch.arange(E, device=dev).expand(G, E).contiguous()
        first = torch.searchsorted(e_s, experts, side="left")
        rank = torch.arange(n, device=dev) - first.gather(1, e_s)
        kept = rank < C
        g = torch.arange(G, device=dev)[:, None]
        # each sorted pair's slot in the [E, G, C] buffer; a dropped
        # pair's is the one past its end
        slot = torch.where(kept, (e_s * G + g) * C + rank, slots)
        # the row that fills each slot: its token's, or the zero row
        # past the tokens where no pair fills it
        tok = torch.full((slots + 1,), G * S, dtype=torch.long, device=dev)
        tok.scatter_(0, slot.reshape(-1), (g * S + order // k).reshape(-1))
        rows = torch.cat([x.reshape(G * S, d).to(dt),
                          x.new_zeros(1, d, dtype=dt)])
        buf = rows[tok[:slots]].view(E, G * C, d)
    with record_function("moe.experts"):
        act = ACTIVATIONS[cfg.act]
        h = act(torch.bmm(buf, compute_weight(params, "w_gate", cfg))) \
            * torch.bmm(buf, compute_weight(params, "w_up", cfg))
        out = torch.bmm(h, compute_weight(params, "w_down", cfg))
    with record_function("moe.combine"):
        # each (token, pick) pair's slot, in the pairs' own order
        pair_slot = torch.empty_like(slot).scatter_(1, order, slot)
        pair_slot = pair_slot.view(G, S, k)
        outs = torch.cat([out.reshape(slots, d), out.new_zeros(1, d)])
        w = top_p.to(dt)
        y = outs[pair_slot[..., 0]] * w[..., 0, None]
        for j in range(1, k):
            y = y + outs[pair_slot[..., j]] * w[..., j, None]
        dropped = (~kept).sum()
    return y, dropped


def moe_forward(params: MoE, x: torch.Tensor, cfg: ModelConfig,
                expert_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``x [B, S, d]`` → (``[B, S, d]`` in the compute dtype, ``{"aux_loss":
    the float32 load-balancing loss, "dropped": the int64 count of (token,
    pick) pairs past their expert's capacity}``). ``expert_mask``
    (``bool[E]``) leaves experts out."""
    B0, S0, d = x.shape
    gs = group_size(S0)
    B, S = B0 * (S0 // gs), gs
    x = x.reshape(B, S, d)
    E = cfg.num_experts
    C = capacity(cfg, S)
    with record_function("moe.route"):
        probs, top_p, top_e = route(params, x, cfg, expert_mask)
        me = probs.mean(dim=(0, 1))
        ce = F.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1))
        aux_loss = E * (me * ce).sum()
    # batch chunks, as the reference's: at most moe_dispatch_chunks, each
    # at least 32 groups, one chunk where they do not divide the batch
    n_chunks = min(cfg.moe_dispatch_chunks, max(1, B // 32))
    if B % n_chunks:
        n_chunks = 1
    Bc = B // n_chunks
    ys, dropped = [], 0
    for c0 in range(0, B, Bc):
        y, drop = _dispatch_combine(params, x[c0:c0 + Bc],
                                    top_e[c0:c0 + Bc], top_p[c0:c0 + Bc],
                                    cfg, C)
        ys.append(y)
        dropped = dropped + drop
    y = ys[0] if n_chunks == 1 else torch.cat(ys)
    return y.reshape(B0, S0, d), {"aux_loss": aux_loss, "dropped": dropped}


def moe_mixture_ref(params: MoE, x: torch.Tensor, cfg: ModelConfig
                    ) -> torch.Tensor:
    """The explicit top-k mixture of each token's experts with no
    capacity, in float32 (the oracle of the reference's
    ``tests/test_models.py::test_moe_matches_dense_per_token``): equal to
    ``moe_forward`` wherever no pair dropped. Only tests and
    ``chip_smoke.py`` call it."""
    B, S, d = x.shape
    k, act = cfg.num_experts_per_tok, ACTIVATIONS[cfg.act]
    xf = x.reshape(B * S, d).float()
    probs = torch.softmax(xf @ params.router.float().T, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(xf)
    for e in range(cfg.num_experts):
        weight = (top_p * (top_e == e)).sum(-1)        # 0 where not picked
        h = act(xf @ params.w_gate[e].float()) * (xf @ params.w_up[e].float())
        y += weight[:, None] * (h @ params.w_down[e].float())
    return y.view(B, S, d)
