"""LM loss: causal cross-entropy with float32 logits, z-loss and masking
(port of ``repro/training/loss.py``). The reference's sharding
constraints are the identity on one device."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None, z_loss: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy of ``logits [B, S, V]`` (any float dtype,
    taken in float32) against ``labels int[B, S]`` (already shifted by the
    data pipeline), over the positions ``mask [B, S]`` keeps (all when
    None), plus ``z_loss`` times the mean squared log-normaliser. Returns
    (the scalar loss, ``{"ce_loss", "accuracy", "tokens"}``); the
    denominator is ``max(mask.sum(), 1)`` and accuracy is the argmax's."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)                              # [B, S]
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    zl = lse * lse
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=lf.device)
    mask = mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / denom
    total = loss + z_loss * (zl * mask).sum() / denom
    acc = ((lf.argmax(-1) == labels).float() * mask).sum() / denom
    return total, {"ce_loss": loss, "accuracy": acc, "tokens": mask.sum()}
