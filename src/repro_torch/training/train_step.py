"""Train-step factory (port of ``repro/training/train_step.py``).

``mode="gspmd"``, the reference's baseline, on one device: the loss and
its gradient through autograd (``forward_train`` under ``remat``; on the
card the attention kernel's and the scan kernels' backward kernels),
``accum_steps`` microbatches summed in float32, then AdamW. Every family
trains, the recurrent ones (``"ssm"``, ``"hybrid"``) included: on the
CPU their plain scans run under ``models/scan_utils.chunked_scan``. The
reference's ``mode="partial_sync"`` (a ``shard_map`` over the data axes
and the p_s-lottery gradient sync) needs the mesh, ``ROADMAP.md`` Queue 1
item 8e, and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward_train, init_params
from repro_torch.training.grad_sync import PartialSyncConfig
from repro_torch.training.loss import lm_loss
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, named_leaves)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    opt: AdamWConfig = AdamWConfig()
    remat: bool = True
    moe_aux_weight: float = 0.01
    mode: str = "gspmd"                     # gspmd | partial_sync
    partial_sync: PartialSyncConfig = PartialSyncConfig()
    accum_steps: int = 1                    # microbatches per optimizer step


def _check(cfg: ModelConfig, tcfg: TrainStepConfig) -> None:
    if tcfg.mode == "partial_sync":
        raise NotImplementedError(
            "mode='partial_sync' syncs gradients inside a shard_map over "
            "the data mesh, which is not ported yet (ROADMAP.md Queue 1 "
            "item 8e)")
    if tcfg.mode != "gspmd":
        raise ValueError(tcfg.mode)


def _loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
             tcfg: TrainStepConfig
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward_train(params, batch, cfg, remat=tcfg.remat)
    if cfg.family == "vlm":
        logits = logits[:, cfg.num_prefix_embeddings:]
    loss, metrics = lm_loss(logits, batch["labels"])
    if "moe_aux_loss" in aux:
        loss = loss + tcfg.moe_aux_weight * aux["moe_aux_loss"]
        metrics["moe_aux_loss"] = aux["moe_aux_loss"]
    return loss, metrics


def _value_and_grad(params, batch, cfg, tcfg
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """(loss, metrics, float32-or-parameter-dtype gradients by name); a
    parameter the loss does not reach gets zeros."""
    leaves = named_leaves(params)
    with torch.enable_grad():
        loss, metrics = _loss_fn(params, batch, cfg, tcfg)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainStepConfig,
                    mesh: Any = None,
                    data_axes: Tuple[str, ...] = ("data",)) -> Callable:
    """Returns ``step(train_state, batch, key=None) -> (train_state,
    metrics)``, train_state = ``{"params", "opt"}`` (see
    :func:`init_train_state`). The step updates the parameters and the
    moments in place and returns the same state dict with a new ``opt``
    step; ``key`` is unused, as in the reference's ``gspmd`` mode. With
    ``accum_steps`` A > 1 the batch splits into A microbatches along
    its first axis (A rows of ``B / A``), their float32 gradients summed
    and divided by A, the loss and metrics averaged. ``mesh`` and
    ``data_axes`` are the reference's arguments of its ``partial_sync``
    mode, which raises here."""
    _check(cfg, tcfg)
    A = tcfg.accum_steps

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
             key: Optional[torch.Tensor] = None
             ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params, opt_state = state["params"], state["opt"]
        if A <= 1:
            loss, metrics, grads = _value_and_grad(params, batch, cfg, tcfg)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % A:
                raise ValueError(f"batch of {n} rows does not split into "
                                 f"accum_steps={A} microbatches")
            mb = n // A
            grads, loss, per = None, None, []
            for a in range(A):
                micro = {k: t[a * mb:(a + 1) * mb] for k, t in batch.items()}
                l_a, m_a, g_a = _value_and_grad(params, micro, cfg, tcfg)
                if grads is None:
                    grads = {k: g.float() for k, g in g_a.items()}
                    loss = l_a.float()
                else:
                    for k, g in g_a.items():
                        grads[k] += g.float()
                    loss = loss + l_a
                per.append(m_a)
            grads = {k: g / A for k, g in grads.items()}
            loss = loss / A
            metrics = {k: torch.stack([m[k].float() for m in per]).mean()
                       for k in per[0]}
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             tcfg.opt)
        metrics = dict(metrics, loss=loss, **om)
        return {"params": params, "opt": opt_state}, metrics

    return step


def init_train_state(cfg: ModelConfig,
                     generator: Union[torch.Generator, int, None] = None,
                     tcfg: Optional[TrainStepConfig] = None,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """``{"params": init_params(cfg, generator, device), "opt":
    adamw_init(params)}`` (the card unless ``device`` says otherwise).
    The reference's ``partial_sync`` residual comes with its mode."""
    if tcfg is not None:
        _check(cfg, tcfg)
    params = init_params(cfg, generator, device=device)
    return {"params": params, "opt": adamw_init(params)}
