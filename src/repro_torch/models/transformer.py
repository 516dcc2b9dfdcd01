"""Model assembly for every family: dense, MoE, RWKV-6 (``"ssm"``),
Mamba-2 hybrid (``"hybrid"``), encoder-decoder (``"encdec"``, whisper) and
VLM (``"vlm"``, llava) (port of ``repro/models/transformer.py``).

The parameters are an ``nn.Module`` tree (``Transformer``: ``embed``,
``final_norm``, an optional untied ``head`` and one block per layer)
whose names follow the reference's parameter tree:

* dense, MoE and VLM: ``Block`` with ``ln1``, ``attn``, ``ln2`` and
  ``mlp`` (or ``moe``); the VLM adds ``vision_proj.kernel``, the d×d
  projector of the precomputed patch embeddings;
* ``"ssm"`` (rwkv6): ``RWKVBlock`` with ``ln1``, ``time_mix``, ``ln2``
  and ``channel_mix``, and no attention (rwkv6-3b's ``num_heads`` is
  informational);
* ``"hybrid"`` (zamba2): ``MambaBlock`` with ``ln`` and ``mamba``, and one
  weight-shared ``shared_attn`` (``ln``, ``attn``, ``ln2``, ``mlp``)
  applied after every ``shared_attn_every`` Mamba layers;
* ``"encdec"`` (whisper): ``enc_blocks`` and ``dec_blocks`` of
  ``EncDecBlock`` (``ln1``, ``attn``, ``ln2``, ``mlp``; a decoder block
  also ``ln_cross`` and ``cross_attn``) and ``enc_final_norm``, in place
  of ``blocks``.

The reference stacks the blocks into ``[L, …]`` arrays for its scan, the
port keeps one module per layer. The functions take the config
separately, as the reference's do, so one set of weights runs under
another ``attn_impl`` or compute dtype. Both the
full-sequence forward and decode loop over the layers in Python; gemma3's
local:global pattern (the reference's ``lax.cond`` on a per-layer flag) is
``cfg.layer_is_global(i)``. MoE layers attend globally, as the
reference's do, and ``forward_train`` returns their mean load-balancing
loss as ``aux["moe_aux_loss"]``. The hybrid forward runs ``L // period``
groups of ``period`` Mamba layers, each followed by the shared block, then
the ``L − groups·period`` tail layers without it. whisper's encoder runs
non-causal self-attention without RoPE over ``batch["encoder_frames"]``
plus a sinusoidal table; its decoder runs causal self-attention without
RoPE, then cross-attention to the encoder's output, then the MLP. Decode
runs the encoder once, in ``init_decode_state``, and keeps one ``(k, v)``
a decoder layer. The VLM projects ``batch["prefix_embeds"]`` and puts
them before the text's embeddings, RoPE positions running over both;
its decode is the dense path over text alone, as the reference's is. The
reference's sharding constraints (``distributed.context.constrain``) are
the identity on one device. ``forward_train(remat=True)`` recomputes each
block in the backward (``torch.utils.checkpoint``), as the reference's
``_maybe_remat`` does. Inside a recurrent block the scan keeps its own
checkpoints: the plain scans run under ``scan_utils.chunked_scan`` (the
segment boundaries' states), the kernels' autograd Functions keep the
state before every 32-step chunk.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.profiler import record_function

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ref as kref
from repro_torch.models.attention import (Attention, _project_q,
                                          attention_forward,
                                          decode_attention, init_kv_cache,
                                          project_kv)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Embedding, LMHead, RMSNorm,
                                       compute_weight, dense_init, dtype_of,
                                       embed_tokens, pdtype_of, rmsnorm,
                                       unembed)
from repro_torch.models.mamba2 import Mamba2, _dims, mamba2_forward
from repro_torch.models.mlp import MLP, mlp_forward
from repro_torch.models.moe import MoE, moe_forward
from repro_torch.models.rwkv6 import (RWKVChannelMix, RWKVTimeMix,
                                      rwkv_channel_mix, rwkv_time_mix)


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


class RWKVBlock(nn.Module):
    """One RWKV-6 block: ``ln1``, ``time_mix``, ``ln2``, ``channel_mix``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        pd = pdtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, pd, device)
        self.time_mix = RWKVTimeMix(cfg, device, generator)
        self.ln2 = RMSNorm(cfg.d_model, pd, device)
        self.channel_mix = RWKVChannelMix(cfg, device, generator)


class MambaBlock(nn.Module):
    """One Mamba-2 block: ``ln`` and ``mamba``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, pdtype_of(cfg), device)
        self.mamba = Mamba2(cfg, device, generator)


class SharedAttn(nn.Module):
    """zamba2's weight-shared transformer block: ``ln``, ``attn``,
    ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        pd = pdtype_of(cfg)
        self.ln = RMSNorm(cfg.d_model, pd, device)
        self.attn = Attention(cfg, device, generator)
        self.ln2 = RMSNorm(cfg.d_model, pd, device)
        self.mlp = MLP(cfg, device, generator)


class EncDecBlock(Block):
    """One whisper block: :class:`Block`'s ``ln1``, ``attn``, ``ln2`` and
    ``mlp``; a decoder block (``cross``) also ``ln_cross`` and
    ``cross_attn``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator], cross: bool):
        super().__init__(cfg, device, generator)
        if cross:
            self.ln_cross = RMSNorm(cfg.d_model, pdtype_of(cfg), device)
            self.cross_attn = Attention(cfg, device, generator)


class VisionProj(nn.Module):
    """The VLM's projector stub, ``kernel [d, d]`` (``[out, in]``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.kernel = dense_init((cfg.d_model, cfg.d_model),
                                 pdtype_of(cfg), device, generator)


BLOCKS = {"dense": Block, "moe": Block, "vlm": Block, "ssm": RWKVBlock,
          "hybrid": MambaBlock}


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.embed = Embedding(cfg, device, generator)
        self.final_norm = RMSNorm(cfg.d_model, pdtype_of(cfg), device)
        self.head = (None if cfg.tie_embeddings
                     else LMHead(cfg, device, generator))
        if cfg.family == "encdec":
            self.enc_blocks = nn.ModuleList(
                EncDecBlock(cfg, device, generator, cross=False)
                for _ in range(cfg.encoder_layers))
            self.dec_blocks = nn.ModuleList(
                EncDecBlock(cfg, device, generator, cross=True)
                for _ in range(cfg.num_layers))
            self.enc_final_norm = RMSNorm(cfg.d_model, pdtype_of(cfg),
                                          device)
            return
        block = BLOCKS[cfg.family]
        self.blocks = nn.ModuleList(block(cfg, device, generator)
                                    for _ in range(cfg.num_layers))
        if cfg.family == "hybrid":
            self.shared_attn = SharedAttn(cfg, device, generator)
        if cfg.family == "vlm":
            self.vision_proj = VisionProj(cfg, device, generator)

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


def _maybe_remat(fn: Callable, remat: bool) -> Callable:
    """``fn`` as it is, or, under ``remat`` with autograd recording, ``fn``
    through ``torch.utils.checkpoint`` (non-reentrant): the block keeps
    only its inputs for the backward and runs again there, attention and
    scan kernels and weight casts included (``compute_weight`` casts anew
    under grad, so the recompute casts again). The reference's policy for
    the dense and MoE blocks, which also keeps the block's matrix
    products, changes memory only; for the recurrent blocks and zamba2's
    shared sites (its ``"ssm"`` and ``"hybrid"`` policy) it saves nothing
    inside a block, as this does."""
    if not remat or not torch.is_grad_enabled():
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def _attention_block(bp: Block, x: torch.Tensor, cfg: ModelConfig,
                     is_global: bool
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One dense or MoE block → (x, the MoE layer's load-balancing loss or
    None)."""
    h = rmsnorm(bp.ln1, x, cfg.norm_eps)
    x = x + attention_forward(bp.attn, h, cfg, is_global=is_global)
    h2 = rmsnorm(bp.ln2, x, cfg.norm_eps)
    if cfg.family == "moe":
        y, moe_aux = moe_forward(bp.moe, h2, cfg)
        return x + y, moe_aux["aux_loss"]
    return x + mlp_forward(bp.mlp, h2, cfg), None


def _attention_forward(params: Transformer, x: torch.Tensor,
                       cfg: ModelConfig, remat: bool = False
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The dense and MoE blocks; the MoE layers' mean load-balancing
    loss as ``aux["moe_aux_loss"]``."""
    moe = cfg.family == "moe"
    block = _maybe_remat(_attention_block, remat)
    aux_losses = []
    for i, bp in enumerate(params.blocks):
        x, aux_loss = block(bp, x, cfg, moe or cfg.layer_is_global(i))
        aux_losses.append(aux_loss)
    aux = {"moe_aux_loss": torch.stack(aux_losses).mean()} if moe else {}
    return x, aux


def _rwkv_block(bp: RWKVBlock, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(bp.ln1, x, cfg.norm_eps)
    x = x + rwkv_time_mix(bp.time_mix, h, cfg)[0]
    h2 = rmsnorm(bp.ln2, x, cfg.norm_eps)
    return x + rwkv_channel_mix(bp.channel_mix, h2, cfg)[0]


def _rwkv_forward(params: Transformer, x: torch.Tensor,
                  cfg: ModelConfig, remat: bool = False) -> torch.Tensor:
    """The RWKV-6 blocks, each recurrence from a zero state."""
    block = _maybe_remat(_rwkv_block, remat)
    for bp in params.blocks:
        x = block(bp, x, cfg)
    return x


def _period(cfg: ModelConfig) -> int:
    """The hybrid's shared-block period (every layer's depth when 0)."""
    return cfg.shared_attn_every or cfg.num_layers


def _shared_block(sp: SharedAttn, x: torch.Tensor, cfg: ModelConfig,
                  attend: Callable[[torch.Tensor], torch.Tensor]
                  ) -> torch.Tensor:
    """zamba2's shared block at one site; ``attend`` is its attention on
    the normed input (the full sequence, or one decode step through the
    site's cache)."""
    with record_function("shared_attn"):
        x = x + attend(rmsnorm(sp.ln, x, cfg.norm_eps))
        h2 = rmsnorm(sp.ln2, x, cfg.norm_eps)
        return x + mlp_forward(sp.mlp, h2, cfg)


def _mamba_block(bp: MambaBlock, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return x + mamba2_forward(bp.mamba, rmsnorm(bp.ln, x, cfg.norm_eps),
                              cfg)[0]


def _shared_site(sp: SharedAttn, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The shared block at one site of the full-sequence forward."""
    return _shared_block(sp, x, cfg, lambda h: attention_forward(
        sp.attn, h, cfg, is_global=True))


def _hybrid_forward(params: Transformer, x: torch.Tensor,
                    cfg: ModelConfig, remat: bool = False) -> torch.Tensor:
    """zamba2: groups of ``period`` Mamba-2 blocks, the shared block after
    each group (after layer i where ``(i + 1) % period == 0``), then the
    tail blocks without it."""
    period = _period(cfg)
    block = _maybe_remat(_mamba_block, remat)
    shared = _maybe_remat(_shared_site, remat)
    for i, bp in enumerate(params.blocks):
        x = block(bp, x, cfg)
        if (i + 1) % period == 0:
            x = shared(params.shared_attn, x, cfg)
    return x


def _sinusoidal_at(pos: torch.Tensor, d: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """whisper's sinusoidal embedding at ``pos`` (any shape) →
    ``[*pos.shape, d]``: ``[sin, cos]`` of ``pos / 10000^(2i/d)``,
    concatenated, in float32, then cast to ``dtype``. The divisor is the
    float32 power rounded correctly (taken in float64, then rounded), as
    the reference's float32 ``pow`` gives it: torch's is an ulp off at
    some exponents, which moves the table by 3e-5 at position 1,500."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    div = torch.pow(10000.0, (2.0 * dim / d).double()).float()
    ang = pos.float()[..., None] / div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _sinusoidal(S: int, d: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """The table at positions ``0 … S − 1``, ``[S, d]``."""
    return _sinusoidal_at(torch.arange(S, dtype=torch.float32,
                                       device=device), d, dtype)


def _encdec_block(bp: EncDecBlock, x: torch.Tensor, cfg: ModelConfig,
                  enc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One whisper block without RoPE: self-attention (causal in the
    decoder, not in the encoder), then, in a decoder block, cross-attention
    to ``enc``, then the MLP."""
    h = rmsnorm(bp.ln1, x, cfg.norm_eps)
    x = x + attention_forward(bp.attn, h, cfg, causal=enc is not None,
                              use_rope=False)
    if enc is not None:
        with record_function("encdec.cross"):
            hc = rmsnorm(bp.ln_cross, x, cfg.norm_eps)
            x = x + attention_forward(bp.cross_attn, hc, cfg, causal=False,
                                      kv_source=enc)
    h2 = rmsnorm(bp.ln2, x, cfg.norm_eps)
    return x + mlp_forward(bp.mlp, h2, cfg)


def _encoder_forward(params: Transformer, frames: torch.Tensor,
                     cfg: ModelConfig, remat: bool = False) -> torch.Tensor:
    """whisper's encoder over precomputed frame embeddings ``[B, T, d]``
    (the conv frontend is a stub): the sinusoidal table added, the
    encoder blocks, ``enc_final_norm``."""
    with record_function("encdec.encoder"):
        dt = dtype_of(cfg)
        x = frames.to(dt)
        x = x + _sinusoidal(x.shape[1], cfg.d_model, dt, x.device)[None]
        block = _maybe_remat(_encdec_block, remat)
        for bp in params.enc_blocks:
            x = block(bp, x, cfg)
        return rmsnorm(params.enc_final_norm, x, cfg.norm_eps)


def _encdec_forward(params: Transformer, x: torch.Tensor,
                    frames: torch.Tensor, cfg: ModelConfig,
                    remat: bool = False) -> torch.Tensor:
    """The encoder over ``frames``, then the decoder blocks over the
    token embeddings ``x`` plus the sinusoidal table."""
    enc = _encoder_forward(params, frames, cfg, remat)
    x = x + _sinusoidal(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    block = _maybe_remat(_encdec_block, remat)
    for bp in params.dec_blocks:
        x = block(bp, x, cfg, enc)
    return x


def forward_train(params: Transformer, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, remat: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward: ``batch["tokens"] [B, S]`` → (logits
    ``[B, S, V]`` in the compute dtype, aux losses: ``{}``, or for the MoE
    family ``{"moe_aux_loss": the layers' mean}``). The VLM also takes
    ``batch["prefix_embeds"] [B, P, d]`` and returns ``[B, P + S, V]``;
    whisper takes ``batch["encoder_frames"] [B, T, d]``. It records
    autograd history like any module call, on the card too (the attention
    and scan kernels run under autograd Functions with their backward
    kernels); serving callers run it under ``torch.inference_mode()``.
    ``remat=True`` checkpoints each block (:func:`_maybe_remat`): the
    backward keeps each block's input and recomputes the rest, so a step
    launches the attention or scan forward twice a layer."""
    x = embed_tokens(params.embed, batch["tokens"], cfg)
    aux: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        dt = dtype_of(cfg)
        prefix = F.linear(batch["prefix_embeds"].to(dt),
                          compute_weight(params.vision_proj, "kernel", cfg))
        x = torch.cat([prefix, x], dim=1)
    if cfg.family == "ssm":
        x = _rwkv_forward(params, x, cfg, remat)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(params, x, cfg, remat)
    elif cfg.family == "encdec":
        x = _encdec_forward(params, x, batch["encoder_frames"], cfg, remat)
    else:
        x, aux = _attention_forward(params, x, cfg, remat)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.embed, x, cfg, params.head), aux


# ----------------------------------------------------------------------------
# decode (KV-cache serving path)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeState:
    pos: int                                  # next position to write
    layers: List[Dict[str, Any]]              # per-layer cache / SSM state
    # whisper: one (k, v) ``[B, Hkv, T, hd]`` a decoder layer, from the
    # encoder's output
    cross: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
    shared: Optional[List[Dict[str, Any]]] = None   # zamba2: a KV cache a site


def init_decode_state(params: Transformer, cfg: ModelConfig, batch: int,
                      max_len: int,
                      encoder_frames: Optional[torch.Tensor] = None
                      ) -> DecodeState:
    """The decode state at position 0: a KV cache a layer (dense, MoE,
    VLM; whisper's, all global, and the encoder run once over
    ``encoder_frames [B, T, d]``, its output projected to one cross
    ``(k, v)`` a decoder layer); ``x_prev_tm``, ``S`` and ``x_prev_cm`` a
    layer (``"ssm"``); ``conv_buf`` and ``h`` a layer and one KV cache for
    each application site of the shared block (``"hybrid"``: weights
    shared, histories not). SSM states are float32, the token-shift and
    conv carries in the compute dtype."""
    dev, dt, B = params.device, dtype_of(cfg), batch
    if cfg.family == "ssm":
        d, H, D = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim
        layers = [{"x_prev_tm": torch.zeros(B, d, dtype=dt, device=dev),
                   "S": torch.zeros(B, H, D, D, dtype=torch.float32,
                                    device=dev),
                   "x_prev_cm": torch.zeros(B, d, dtype=dt, device=dev)}
                  for _ in range(cfg.num_layers)]
        return DecodeState(pos=0, layers=layers)
    if cfg.family == "hybrid":
        d_inner, H, D, n = _dims(cfg)
        W = cfg.conv_width
        layers = [{"conv_buf": torch.zeros(B, W - 1, d_inner, dtype=dt,
                                           device=dev),
                   "h": torch.zeros(B, H, D, n, dtype=torch.float32,
                                    device=dev)}
                  for _ in range(cfg.num_layers)]
        shared = [init_kv_cache(cfg, B, max_len, True, dev)
                  for _ in range(cfg.num_layers // _period(cfg))]
        return DecodeState(pos=0, layers=layers, shared=shared)
    if cfg.family == "encdec":
        if encoder_frames is None:
            raise ValueError("whisper decode needs encoder_frames")
        layers = [init_kv_cache(cfg, B, max_len, True, dev)
                  for _ in range(cfg.num_layers)]
        with torch.no_grad():
            enc = _encoder_forward(params, encoder_frames, cfg)
            cross = [project_kv(bp.cross_attn, enc, cfg)
                     for bp in params.dec_blocks]
        return DecodeState(pos=0, layers=layers, cross=cross)
    layers = [init_kv_cache(cfg, B, max_len, cfg.layer_is_global(i), dev)
              for i in range(cfg.num_layers)]
    return DecodeState(pos=0, layers=layers)


def _attention_decode(params: Transformer, state: DecodeState,
                      x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, DecodeState]:
    """The dense and MoE layers of one decode step."""
    moe = cfg.family == "moe"
    pos = state.pos
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
    return x, DecodeState(pos=pos + 1, layers=layers)


def _recurrent_decode(params: Transformer, state: DecodeState,
                      x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, DecodeState]:
    """The ``"ssm"`` and ``"hybrid"`` layers of one decode step: each
    recurrence is its scan at S = 1 from the carried state (new state
    tensors); a hybrid site's shared attention writes its own cache in
    place."""
    pos, layers = state.pos, []
    shared = None if state.shared is None else list(state.shared)
    period = _period(cfg)
    for i, bp in enumerate(params.blocks):
        lc = state.layers[i]
        if cfg.family == "ssm":
            h = rmsnorm(bp.ln1, x, cfg.norm_eps)
            y, (x_tm, S) = rwkv_time_mix(bp.time_mix, h, cfg,
                                         state=(lc["x_prev_tm"], lc["S"]))
            x = x + y
            h2 = rmsnorm(bp.ln2, x, cfg.norm_eps)
            y2, x_cm = rwkv_channel_mix(bp.channel_mix, h2, cfg,
                                        x_prev=lc["x_prev_cm"])
            x = x + y2
            layers.append({"x_prev_tm": x_tm, "S": S, "x_prev_cm": x_cm})
            continue
        h = rmsnorm(bp.ln, x, cfg.norm_eps)
        y, (cb, hst) = mamba2_forward(bp.mamba, h, cfg,
                                      state=(lc["conv_buf"], lc["h"]))
        x = x + y
        layers.append({"conv_buf": cb, "h": hst})
        if (i + 1) % period == 0:
            site = (i + 1) // period - 1

            def attend(h):
                a, shared[site] = decode_attention(
                    params.shared_attn.attn, h, shared[site], pos, cfg)
                return a

            x = _shared_block(params.shared_attn, x, cfg, attend)
    return x, DecodeState(pos=pos + 1, layers=layers, shared=shared)


def _cross_decode(params: Attention, x: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of one decode token ``x [B, 1, d]`` over the
    cached encoder K/V: the plain oracle, non-causal, as in the
    reference."""
    B = x.shape[0]
    q = _project_q(params, x, cfg)
    out = kref.attention_ref(q, k, v, causal=False,
                             logit_soft_cap=cfg.logit_soft_cap)
    out = out.transpose(1, 2).reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return F.linear(out, compute_weight(params, "wo", cfg))


def _encdec_decode(params: Transformer, state: DecodeState,
                   x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, DecodeState]:
    """whisper's decoder layers at one step: the sinusoid at ``pos``,
    self-attention through the cache without RoPE, cross-attention over
    the layer's cached encoder K/V, the MLP."""
    pos = state.pos
    p = torch.full((), pos, dtype=torch.float32, device=x.device)
    x = x + _sinusoidal_at(p, cfg.d_model, x.dtype)
    layers = []
    for i, bp in enumerate(params.dec_blocks):
        h = rmsnorm(bp.ln1, x, cfg.norm_eps)
        a, lc = decode_attention(bp.attn, h, state.layers[i], pos, cfg,
                                 use_rope=False)
        x = x + a
        with record_function("encdec.cross"):
            hc = rmsnorm(bp.ln_cross, x, cfg.norm_eps)
            x = x + _cross_decode(bp.cross_attn, hc, *state.cross[i], cfg)
        h2 = rmsnorm(bp.ln2, x, cfg.norm_eps)
        x = x + mlp_forward(bp.mlp, h2, cfg)
        layers.append(lc)
    return x, DecodeState(pos=pos + 1, layers=layers, cross=state.cross)


@torch.no_grad()
def decode_step(params: Transformer, state: DecodeState,
                tokens: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One autoregressive step for ``tokens int[B]`` → (logits ``[B, V]``,
    the state at ``pos + 1``), without autograd (decode is inference
    only). The KV caches are written in place: the returned state shares
    them with the one given; the recurrent families' states are new
    tensors. An MoE layer routes each sequence's token as a group of its
    own, whose capacity (8) no token exceeds."""
    x = embed_tokens(params.embed, tokens[:, None], cfg)       # [B, 1, d]
    if cfg.family in ("ssm", "hybrid"):
        x, new_state = _recurrent_decode(params, state, x, cfg)
    elif cfg.family == "encdec":
        x, new_state = _encdec_decode(params, state, x, cfg)
    else:
        x, new_state = _attention_decode(params, state, x, cfg)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.embed, x[:, 0], cfg, params.head), new_state
