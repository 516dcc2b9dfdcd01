"""Carries the reference package's state across through numpy.

The reference (``repro``) hands out graphs, walk-index slabs (dense or as
per-shard blocks), streamed-step slab layouts, hybrid ELL layouts, PRNG
keys and LM parameter trees (every family) as JAX or numpy arrays;
``np.asarray`` of them gives plain arrays, and these helpers turn those
into the port's objects, so both packages compute on the same graph,
slab, layout, key and weights.
Each puts its result on ``device``, the card unless the caller asks for
the CPU (``device="cpu"``), as every entry point of the port does: with
no card and no ``device`` they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.csr import CSRGraph, _from_arrays
from repro_torch.graph.partition import EllGraph
from repro_torch.kernels.frog_step_stream import BlockedCSR
from repro_torch.models.config import ATTN_RENAMED, ModelConfig
from repro_torch.models.layers import pdtype_of
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.query.index import ShardedWalkIndex, WalkIndex


def graph_from_numpy(n: int, row_ptr, col_idx, epoch: int = 0,
                     mutation_offset: int = 0,
                     device: DeviceLike = None) -> CSRGraph:
    """A CSRGraph from ``row_ptr`` / ``col_idx`` arrays (degrees
    re-derived), on ``device``."""
    row_ptr = np.asarray(row_ptr)
    if row_ptr.shape != (int(n) + 1,):
        raise ValueError(f"row_ptr has shape {row_ptr.shape}, wanted "
                         f"({int(n) + 1},)")
    return _from_arrays(n, row_ptr, np.asarray(col_idx), epoch,
                        mutation_offset).to(device)


def walk_index_from_numpy(endpoints, segment_len: int, seed: int,
                          graph_epoch: int = 0, mutation_offset: int = 0,
                          device: DeviceLike = None) -> WalkIndex:
    """A WalkIndex from an ``int[n, R]`` endpoint slab, on ``device``."""
    ep = np.asarray(endpoints)
    if ep.ndim != 2:
        raise ValueError(f"endpoints must be [n, R], got shape {ep.shape}")
    return WalkIndex(
        endpoints=torch.from_numpy(ep.astype(np.int32)).to(
            resolve_device(device)),
        segment_len=int(segment_len), seed=int(seed),
        graph_epoch=int(graph_epoch), mutation_offset=int(mutation_offset))


def sharded_walk_index_from_numpy(blocks, n: int, segment_len: int,
                                  seed: int, graph_epoch: int = 0,
                                  mutation_offset: int = 0,
                                  device: DeviceLike = None
                                  ) -> ShardedWalkIndex:
    """A ShardedWalkIndex from stacked ``int[S, shard_size, R]`` blocks, on
    ``device``."""
    b = np.asarray(blocks)
    if b.ndim != 3 or b.shape[0] * b.shape[1] < int(n):
        raise ValueError(f"blocks must be [S, shard_size, R] covering "
                         f"n={n} rows, got shape {b.shape}")
    return ShardedWalkIndex(
        blocks=_i32(b, device), n=int(n), segment_len=int(segment_len),
        seed=int(seed), graph_epoch=int(graph_epoch),
        mutation_offset=int(mutation_offset))


def blocked_csr_from_numpy(vertex_block: int, row_off, deg, col,
                           device: DeviceLike = None) -> BlockedCSR:
    """A BlockedCSR from the reference's ``row_off`` / ``deg``
    (``[num_vb, BV]``) and ``col`` (``[num_vb, E_blk]``) arrays."""
    arrays = [np.asarray(a) for a in (row_off, deg, col)]
    if any(a.ndim != 2 for a in arrays) or arrays[0].shape != arrays[1].shape:
        raise ValueError("row_off and deg must be [num_vb, BV] and col "
                         "[num_vb, E_blk]")
    return BlockedCSR(int(vertex_block), *(_i32(a, device) for a in arrays))


def ell_from_numpy(n_rows: int, K: int, idx, valid, weight, spill_src,
                   spill_dst, spill_w, device: DeviceLike = None
                   ) -> EllGraph:
    """An EllGraph from the reference's arrays (``idx`` / ``valid`` /
    ``weight`` ``[n_rows, K]`` and the spill tail), on ``device``."""
    dev = resolve_device(device)
    slab = [np.asarray(a) for a in (idx, valid, weight)]
    if any(a.shape != (int(n_rows), int(K)) for a in slab):
        raise ValueError(f"idx, valid and weight must be [{n_rows}, {K}]")

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    return EllGraph(
        n_rows=int(n_rows), K=int(K), idx=t(idx, np.int32),
        valid=t(valid, np.bool_), weight=t(weight, np.float32),
        spill_src=t(spill_src, np.int32), spill_dst=t(spill_dst, np.int32),
        spill_w=t(spill_w, np.float32))


def _i32(a: np.ndarray, device: DeviceLike) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(
        resolve_device(device))


def key_from_jax(key_data, device: DeviceLike = None) -> torch.Tensor:
    """The port's key for the reference key whose ``jax.random.key_data``
    (``uint32[..., 2]``) is given."""
    return prng.wrap_key_data(np.asarray(key_data).astype(np.int64), device)


def model_config_from_reference(fields: Mapping[str, Any]) -> ModelConfig:
    """The port's ``ModelConfig`` for the reference config whose
    ``dataclasses.asdict`` is ``fields``: the fields the ported paths read
    (the MoE, SSM, hybrid, encoder-decoder and VLM fields among them),
    with ``attn_impl`` renamed (``"pallas"`` → ``"auto"``,
    ``"jnp_flash"`` → ``"torch"``). The reference's other fields
    (``ssm_state_sharding``, ``attn_bf16_probs``) are dropped: no ported
    path reads them."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in fields.items() if k in names}
    impl = kw.get("attn_impl", "auto")
    kw["attn_impl"] = ATTN_RENAMED.get(impl, impl)
    return ModelConfig(**kw)


# matrices the reference applies as ``x @ W`` (``[in, out]``), transposed to
# the port's ``[out, in]``; every other leaf keeps its layout
_ATTN_MATRICES = ("wq", "wk", "wv", "wo")
_MLP_MATRICES = ("w_up", "w_gate", "w_down")
_TIME_MIX_MATRICES = ("w_r", "w_k", "w_v", "w_g", "w_o", "w_lora_a",
                      "w_lora_b")
_MAMBA_MATRICES = ("w_in_z", "w_in_x", "w_in_B", "w_in_C", "w_in_dt",
                   "w_out")


def _leaves(prefix: str, tree: Mapping[str, Any], i=None,
            transpose=()) -> Dict[str, np.ndarray]:
    """``{prefix + name: leaf}`` for a module's leaves, layer ``i`` of a
    stacked tree (or the whole leaf when None), the ``transpose`` names
    from ``[in, out]`` to ``[out, in]``."""
    out = {}
    for name, leaf in tree.items():
        a = np.asarray(leaf)
        a = a if i is None else a[i]
        out[prefix + name] = a.T if name in transpose else a
    return out


def _block_leaves(pre: str, blocks: Mapping[str, Any], i: int,
                  cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Layer ``i`` of a stacked block tree: its norm scales and its
    family's modules (whisper's ``cross_attn`` where the block has one)."""
    state = {pre + ln + ".scale": np.asarray(blocks[ln]["scale"])[i]
             for ln in ("ln1", "ln2", "ln", "ln_cross") if ln in blocks}
    if cfg.family == "ssm":
        state.update(_leaves(pre + "time_mix.", blocks["time_mix"], i,
                             _TIME_MIX_MATRICES))
        state.update(_leaves(pre + "channel_mix.", blocks["channel_mix"], i,
                             ("w_in", "w_out")))
        return state
    if cfg.family == "hybrid":
        state.update(_leaves(pre + "mamba.", blocks["mamba"], i,
                             _MAMBA_MATRICES))
        return state
    for attn in ("attn", "cross_attn"):
        if attn in blocks:
            state.update(_leaves(f"{pre}{attn}.", blocks[attn], i,
                                 _ATTN_MATRICES))
    if cfg.family == "moe":
        state.update(_leaves(pre + "moe.", blocks["moe"], i, ("router",)))
    else:
        state.update(_leaves(pre + "mlp.", blocks["mlp"], i, _MLP_MATRICES))
    return state


def model_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                            device: DeviceLike = None) -> Transformer:
    """The port's parameter modules from the reference's tree (``embed``,
    ``final_norm``, optional ``head``, ``blocks`` stacked ``[L, …]`` —
    or whisper's ``enc_blocks``, ``dec_blocks`` and ``enc_final_norm`` —
    and, for the hybrid family, ``shared_attn``, for the VLM
    ``vision_proj``), each leaf taken through ``np.asarray``. The dense
    matrices (``head``, the attention, cross-attention and MLP weights,
    the VLM's square projector, the MoE ``router [L, d, E]``, the RWKV-6
    and Mamba-2 projections applied as ``x @ W``) are transposed from the
    reference's ``[in, out]`` to ``[out, in]``; the expert weights
    (``w_gate`` / ``w_up [L, E, d, f]``, ``w_down [L, E, f, d]``), the
    vectors and the conv taps ``conv_w [W, C]`` keep the reference's
    layout."""
    dev = resolve_device(device)
    params = init_params(cfg, device="meta")
    state: Dict[str, np.ndarray] = {
        "embed.embedding": tree["embed"]["embedding"],
        "final_norm.scale": tree["final_norm"]["scale"],
    }
    if params.head is not None:
        state["head.kernel"] = np.asarray(tree["head"]["kernel"]).T
    if cfg.family == "encdec":
        stacks = (("enc_blocks", cfg.encoder_layers),
                  ("dec_blocks", cfg.num_layers))
        state["enc_final_norm.scale"] = tree["enc_final_norm"]["scale"]
    else:
        stacks = (("blocks", cfg.num_layers),)
    for name, n in stacks:
        for i in range(n):
            state.update(_block_leaves(f"{name}.{i}.", tree[name], i, cfg))
    if cfg.family == "hybrid":
        shared = tree["shared_attn"]
        for ln in ("ln", "ln2"):
            state[f"shared_attn.{ln}.scale"] = shared[ln]["scale"]
        state.update(_leaves("shared_attn.attn.", shared["attn"],
                             transpose=_ATTN_MATRICES))
        state.update(_leaves("shared_attn.mlp.", shared["mlp"],
                             transpose=_MLP_MATRICES))
    if cfg.family == "vlm":
        state["vision_proj.kernel"] = np.asarray(
            tree["vision_proj"]["kernel"]).T
    tensors = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
        dev, pdtype_of(cfg))
        for k, v in state.items()}
    params.load_state_dict(tensors, strict=True, assign=True)
    return params


def train_state_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                           device: DeviceLike = None) -> Dict[str, Any]:
    """The port's train state (``training.train_step.init_train_state``'s
    layout) from the reference's ``{"params", "opt": {"m", "v",
    "step"}}``: the parameters through :func:`model_params_from_numpy`,
    and each moment tree through it too (the same names and transposes),
    as float32 tensors by parameter name; ``step`` an int32 scalar. Both
    packages then start a step from the same numbers."""
    dev = resolve_device(device)
    params = model_params_from_numpy(tree["params"], cfg, device=dev)
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    opt = tree["opt"]
    moments = {
        name: {k: p.detach().float() for k, p in model_params_from_numpy(
            opt[name], f32, device=dev).named_parameters()}
        for name in ("m", "v")}
    step = torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                        device=dev)
    return {"params": params, "opt": dict(moments, step=step)}
