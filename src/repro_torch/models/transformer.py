"""Model assembly for the dense and MoE families (port of those branches
of ``repro/models/transformer.py``).

The parameters are an ``nn.Module`` tree (``Transformer``: ``embed``,
``final_norm``, an optional untied ``head`` and one ``Block`` per layer,
with ``mlp`` or, in the MoE family, ``moe``) whose names follow the
reference's parameter tree; the reference stacks
the blocks into ``[L, …]`` arrays for its scan, the port keeps one module
per layer. The functions take the config separately, as the reference's
do, so one set of weights runs under another ``attn_impl`` or compute
dtype. Both the full-sequence forward and decode loop over the layers in
Python; gemma3's local:global pattern (the reference's ``lax.cond`` on a
per-layer flag) is ``cfg.layer_is_global(i)``. MoE layers attend
globally, as the reference's do, and ``forward_train`` returns their mean
load-balancing loss as ``aux["moe_aux_loss"]``. The reference's sharding
constraints (``distributed.context.constrain``) are the identity on one
device and its MoE checkpoint is for training; neither is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (Attention, attention_forward,
                                          decode_attention, init_kv_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Embedding, LMHead, RMSNorm,
                                       embed_tokens, pdtype_of, rmsnorm,
                                       unembed)
from repro_torch.models.mlp import MLP, mlp_forward
from repro_torch.models.moe import MoE, moe_forward


class Block(nn.Module):
    """One decoder block: ``ln1``, ``attn``, ``ln2`` and ``mlp``, or
    ``moe`` in the MoE family."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        pd = pdtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, pd, device)
        self.attn = Attention(cfg, device, generator)
        self.ln2 = RMSNorm(cfg.d_model, pd, device)
        if cfg.family == "moe":
            self.moe = MoE(cfg, device, generator)
        else:
            self.mlp = MLP(cfg, device, generator)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.embed = Embedding(cfg, device, generator)
        self.final_norm = RMSNorm(cfg.d_model, pdtype_of(cfg), device)
        self.head = (None if cfg.tie_embeddings
                     else LMHead(cfg, device, generator))
        self.blocks = nn.ModuleList(Block(cfg, device, generator)
                                    for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device


def init_params(cfg: ModelConfig,
                generator: Union[torch.Generator, int, None] = None,
                device: DeviceLike = None) -> Transformer:
    """Random parameters on ``device`` (the card unless asked; ``"meta"``
    builds the tree without storage). ``generator`` is a
    ``torch.Generator`` on that device or an int seed (default 0)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    if dev.type == "meta":
        generator = None
    elif not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(
            0 if generator is None else int(generator))
    return Transformer(cfg, dev, generator)


def forward_train(params: Transformer, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, remat: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward: ``batch["tokens"] [B, S]`` → (logits
    ``[B, S, V]`` in the compute dtype, aux losses: ``{}``, or for the MoE
    family ``{"moe_aux_loss": the layers' mean}``). It records
    autograd history like any module call; serving callers run it under
    ``torch.inference_mode()``."""
    if remat:
        raise NotImplementedError(
            "remat=True is training, which is not ported to repro_torch yet "
            "(ROADMAP.md Queue 1 item 14: training/)")
    moe = cfg.family == "moe"
    x = embed_tokens(params.embed, batch["tokens"], cfg)
    aux_losses = []
    for i, bp in enumerate(params.blocks):
        h = rmsnorm(bp.ln1, x, cfg.norm_eps)
        x = x + attention_forward(bp.attn, h, cfg,
                                  is_global=moe or cfg.layer_is_global(i))
        h2 = rmsnorm(bp.ln2, x, cfg.norm_eps)
        if moe:
            y, moe_aux = moe_forward(bp.moe, h2, cfg)
            x = x + y
            aux_losses.append(moe_aux["aux_loss"])
        else:
            x = x + mlp_forward(bp.mlp, h2, cfg)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    aux = {"moe_aux_loss": torch.stack(aux_losses).mean()} if moe else {}
    return unembed(params.embed, x, cfg, params.head), aux


# ----------------------------------------------------------------------------
# decode (KV-cache serving path)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeState:
    pos: int                                  # next position to write
    layers: List[Dict[str, Any]]              # per-layer KV cache


def init_decode_state(params: Transformer, cfg: ModelConfig, batch: int,
                      max_len: int) -> DecodeState:
    layers = [init_kv_cache(cfg, batch, max_len, cfg.layer_is_global(i),
                            params.device)
              for i in range(cfg.num_layers)]
    return DecodeState(pos=0, layers=layers)


@torch.no_grad()
def decode_step(params: Transformer, state: DecodeState,
                tokens: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One autoregressive step for ``tokens int[B]`` → (logits ``[B, V]``,
    the state at ``pos + 1``), without autograd (decode is inference
    only). The caches are written in place: the returned state shares
    them with the one given. An MoE layer routes each sequence's token as
    a group of its own, whose capacity (8) no token exceeds."""
    moe = cfg.family == "moe"
    pos = state.pos
    x = embed_tokens(params.embed, tokens[:, None], cfg)       # [B, 1, d]
    layers = []
    for i, bp in enumerate(params.blocks):
        h = rmsnorm(bp.ln1, x, cfg.norm_eps)
        a, lc = decode_attention(bp.attn, h, state.layers[i], pos, cfg,
                                 is_global=moe or cfg.layer_is_global(i))
        x = x + a
        h2 = rmsnorm(bp.ln2, x, cfg.norm_eps)
        if moe:
            x = x + moe_forward(bp.moe, h2, cfg)[0]
        else:
            x = x + mlp_forward(bp.mlp, h2, cfg)
        layers.append(lc)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(params.embed, x[:, 0], cfg, params.head)
    return logits, DecodeState(pos=pos + 1, layers=layers)
