"""Config registry (port of ``repro/configs/registry.py``). The public
surface is the graph workload family: ``GRAPHS`` and
:func:`get_graph_config`, which ``repro_torch.configs`` exports.

The LLM architecture registry below (``ARCHS``, ``get_config``,
``SHAPES``, ``shape_applicable``, ``reduced_config``) stays off that
surface (``__all__``), as in the reference: the model tests and
``launch/serve.py`` import it from this module by name.

Every architecture of the reference is ported: the four dense ones, the
two MoE ones, rwkv6-3b (``"ssm"``), zamba2-1.2b (``"hybrid"``),
whisper-medium (``"encdec"``) and llava-next-mistral-7b (``"vlm"``). The
reference's ``input_specs`` / ``param_specs`` are ``eval_shape`` tooling
and come with the launch tools (Queue 1 item 15); a vlm batch's text is
``S − num_prefix_embeddings`` tokens and an encdec batch carries
``encoder_seq`` frames, as its ``input_specs`` gives them.

Shape semantics:
  * train_4k     — train_step   (tokens+labels, seq 4096, global batch 256)
  * prefill_32k  — serve prefill (forward, seq 32768, batch 32)
  * decode_32k   — serve_step    (ONE new token, KV cache of 32768, batch 128)
  * long_500k    — serve_step    (one token, 524288 cache, batch 1) —
                   sub-quadratic archs only (``ModelConfig.subquadratic``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

from repro_torch.configs.frogwild_graphs import (GraphConfig,
                                                 LIVEJOURNAL_BENCH,
                                                 LIVEJOURNAL_FULL,
                                                 TWITTER_BENCH, TWITTER_FULL)
from repro_torch.models.config import ModelConfig

__all__ = [
    "GraphConfig",
    "GRAPHS",
    "get_graph_config",
]

# --- the registered config family: the paper's graph workloads --------------

GRAPHS: Dict[str, GraphConfig] = {
    cfg.name: cfg
    for cfg in (LIVEJOURNAL_BENCH, TWITTER_BENCH,
                LIVEJOURNAL_FULL, TWITTER_FULL)
}


def get_graph_config(name: str) -> GraphConfig:
    if name not in GRAPHS:
        raise KeyError(f"unknown graph {name!r}; known: {sorted(GRAPHS)}")
    return GRAPHS[name]


# --- the LLM architecture registry (not exported) ----------------------------


_ARCH_MODULES = {
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "llama3.2-1b": "repro_torch.configs.llama32_1b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1b",
}
ARCHS = tuple(_ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(applicable?, reason-if-not)."""
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch — 500k decode needs "
                       "sub-quadratic attention (skip per brief)")
    if cfg.family == "encdec" and spec.name == "long_500k":
        return False, "enc-dec ASR: 30s audio yields no 500k decode context"
    return True, ""


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Same wiring, toy width: one forward/decode runs on a CPU. The
    reference's rules for every family."""
    kw: Dict[str, Any] = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        rope_theta=cfg.rope_theta,
        tie_embeddings=cfg.tie_embeddings,
        dtype="float32",
    )
    # keep the kv:q ratio flavour
    kw["num_kv_heads"] = 4 if cfg.num_kv_heads == cfg.num_heads else 2
    if cfg.sliding_window is not None:
        kw["sliding_window"] = 8
    if cfg.global_every is not None:
        kw["global_every"] = 2
        kw["num_layers"] = 4
    if cfg.family == "moe":
        kw.update(num_experts=8, num_experts_per_tok=min(
            cfg.num_experts_per_tok, 2), d_ff=64, moe_capacity_factor=2.0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_head_dim=32, ssm_state=16, num_kv_heads=4)
    if cfg.family == "hybrid":
        kw.update(shared_attn_every=2, num_layers=4)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2, encoder_seq=16, num_layers=2,
                  num_kv_heads=4)
    if cfg.family == "vlm":
        kw.update(num_prefix_embeddings=4)
    return ModelConfig(**kw)
