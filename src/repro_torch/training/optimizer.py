"""AdamW, from scratch, as the reference writes it (port of
``repro/training/optimizer.py``): linear warmup into a cosine schedule,
global-norm clipping, bias correction from the step count, and decoupled
weight decay on matrices only. ``torch.optim.AdamW`` differs in all of
these, so it is not used.

The parameters are the model's ``nn.Module`` (or a mapping of names to
tensors); the optimizer state mirrors them by name, float32 moments
``{"m": {name: tensor}, "v": {...}, "step": int32 scalar}``, as the
reference's state mirrors its parameter tree leaf for leaf. The update
writes the parameters and moments in place (the reference returns new
arrays): at llama3.2-1b's width the copies would be 15 GB.

Weight decay follows the reference's leaf rank (``p.ndim >= 2``), not the
port tensor's. The reference stacks the per-layer parameters with a
leading layer axis (``blocks``, whisper's ``enc_blocks`` and
``dec_blocks``), so a per-layer norm scale is a matrix there and is
decayed; the port keeps a module a layer, where the scale is a vector.
:func:`reference_rank` adds the stacked axis back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple, Union

import torch
from torch import nn

# the reference's stacked parameter groups, [L, ...] there and one module
# a layer here
STACKED = ("blocks", "enc_blocks", "dec_blocks")

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named_leaves(params: Params) -> Dict[str, torch.Tensor]:
    """The parameters by name: a module's ``named_parameters()``, or the
    mapping as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def reference_rank(name: str, t: torch.Tensor) -> int:
    """The rank of leaf ``name`` in the reference's tree: one more than
    the port tensor's for a per-layer parameter (under :data:`STACKED`),
    the port tensor's otherwise."""
    return t.dim() + (name.split(".", 1)[0] in STACKED)


def adamw_init(params: Params) -> Dict[str, Any]:
    leaves = named_leaves(params)
    dev = next(iter(leaves.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in leaves.items()}
    return {"m": zeros,
            "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio · lr``, float32."""
    step = torch.as_tensor(step)
    warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The float32 norm of all leaves together."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: Dict[str, Any],
                 params: Params, cfg: AdamWConfig
                 ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping → (the parameters, the new
    optimizer state, ``{"grad_norm" (before clipping), "lr"}``). The
    parameters and the moments are written in place; ``step`` is a new
    tensor."""
    leaves = named_leaves(params)
    step = opt_state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float() + 1.0
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    for name, p in leaves.items():
        g = grads[name].float() * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        m.copy_(b1 * m + (1.0 - b1) * g)
        v.copy_(b2 * v + (1.0 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if reference_rank(name, p) >= 2:     # decoupled decay on matrices
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
