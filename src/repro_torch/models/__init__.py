"""The LM stack's dense, MoE, RWKV-6, Mamba-2 hybrid, whisper
encoder-decoder and LLaVA families on PyTorch (port of ``repro/models``).

Parameters are ``nn.Module`` trees built by ``init_params``; the
functions take them with a ``ModelConfig``, as the reference's take its
parameter dicts. ``forward_train`` is the full-sequence forward (the
prefill program), whose attention runs the hand-written CUDA
``flash_attention`` kernel on the card; ``init_decode_state`` and
``decode_step`` are the serving path (KV caches, and the recurrent
families' constant-size states). MoE layers (``models/moe.py``) route
each token to its top-k experts under the reference's capacity dispatch.
The RWKV-6 time mix (``models/rwkv6.py``, ``family="ssm"``) and the
Mamba-2 layer (``models/mamba2.py``, ``family="hybrid"``, with zamba2's
weight-shared attention block) run their time recurrences in the
hand-written CUDA scans ``wkv6_scan`` and ``ssd_scan`` on the card.
whisper's encoder (``batch["encoder_frames"]``, non-causal) and its
decoder's cross-attention run ``flash_attention`` too, and its decode
state holds the encoder's K/V a layer; the VLM puts the projected
``batch["prefix_embeds"]`` before the text (a stub vision frontend).
``forward_train`` is also the training forward (``repro_torch.training``):
on the card its attention's backward is the hand-written
``flash_attention_bwd`` kernel.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (DecodeState, Transformer,
                                            decode_step, forward_train,
                                            init_decode_state, init_params)

__all__ = [
    "DecodeState",
    "ModelConfig",
    "Transformer",
    "init_params",
    "forward_train",
    "init_decode_state",
    "decode_step",
]
