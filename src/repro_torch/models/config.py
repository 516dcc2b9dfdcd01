"""The model configuration of the port's LM stack (port of
``repro/models/config.py``).

Every family of the reference is ported: dense, MoE, the RWKV-6
``"ssm"`` family, the Mamba-2 ``"hybrid"`` one, the encoder-decoder
``"encdec"`` (whisper: ``encoder_layers`` blocks over ``encoder_seq``
precomputed frame embeddings) and the ``"vlm"`` one (llava:
``num_prefix_embeddings`` precomputed patch embeddings before the text).
Only the fields a ported path reads exist here: passing one of the
reference's others is a ``TypeError``, not a setting silently ignored.
Its ``ssm_state_sharding`` is a mesh knob (``ROADMAP.md`` Queue 1 item 8e)
and its ``attn_bf16_probs`` a probability dtype of its ``cp_kv`` path;
neither is a field.

``attn_impl`` takes the port's names:

* ``"auto"``  — (default) the hand-written CUDA ``flash_attention`` for
  CUDA tensors, the plain chunked version for CPU tensors;
* ``"cuda"``  — the CUDA kernel; CPU tensors raise;
* ``"torch"`` — the plain chunked version (``ref.attention_chunked``) on
  any device;
* ``"ref"``   — the O(S²)-memory oracle (``ref.attention_ref``).

The reference's ``"pallas"`` and ``"jnp_flash"`` raise ``ValueError``
naming the port's equivalent; ``"cp_kv"`` needs the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
ATTN_IMPLS = ("auto", "cuda", "torch", "ref")
ATTN_RENAMED = {"pallas": "auto", "jnp_flash": "torch"}
ACTS = ("silu", "gelu", "relu")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: Optional[int] = None   # default: d_model // num_heads

    # --- attention pattern ---
    sliding_window: Optional[int] = None   # SWA width (danube, gemma3 locals)
    global_every: Optional[int] = None     # gemma3: every Nth layer is global
    rope_theta: float = 10_000.0
    logit_soft_cap: Optional[float] = None

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_dispatch_chunks: int = 8       # batch sub-chunks per dispatch pass

    # --- SSM (rwkv6 / mamba2) ---
    ssm_state: int = 64
    ssm_heads: Optional[int] = None        # default d_model // ssm_head_dim
    ssm_head_dim: int = 64
    conv_width: int = 4                    # mamba2 depthwise conv

    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0             # shared attention block period

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500                # precomputed frame embeddings

    # --- frontend stubs ---
    num_prefix_embeddings: int = 0         # VLM: precomputed patch embeds

    # --- numerics / misc ---
    act: str = "silu"
    mlp_gated: bool = True                 # False: classic 2-matrix MLP
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"                # compute dtype
    param_dtype: str = "float32"           # storage dtype
    attn_impl: str = "auto"                # auto | cuda | torch | ref
    attn_chunk: int = 512                  # q-chunk of the plain version
    kv_cache_dtype: str = "compute"        # "compute" (=dtype) | "int8"

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family == "moe" and not (
                1 <= self.num_experts_per_tok <= self.num_experts):
            raise ValueError(
                f"an MoE config needs 1 <= num_experts_per_tok <= "
                f"num_experts, got num_experts_per_tok="
                f"{self.num_experts_per_tok}, num_experts="
                f"{self.num_experts}")
        if self.attn_impl in ATTN_RENAMED:
            raise ValueError(
                f"attn_impl={self.attn_impl!r} is the reference's name; the "
                f"port's equivalent is "
                f"attn_impl={ATTN_RENAMED[self.attn_impl]!r}")
        if self.attn_impl == "cp_kv":
            raise NotImplementedError(
                "attn_impl='cp_kv' needs the mesh, which is not ported to "
                "repro_torch yet (ROADMAP.md Queue 1 item 8e)")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}")
        if self.act not in ACTS:
            raise ValueError(f"act must be one of {ACTS}, got {self.act!r}")
        if self.kv_cache_dtype not in ("compute", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'compute' or 'int8', "
                             f"got {self.kv_cache_dtype!r}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads={self.num_heads} is not a multiple "
                             f"of num_kv_heads={self.num_kv_heads}")
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.ssm_heads is None:
            object.__setattr__(self, "ssm_heads",
                               max(1, self.d_model // self.ssm_head_dim))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context? The recurrent families
        can (constant-size state; zamba2's shared block keeps one KV cache
        a site); dense archs only with a sliding window (danube's SWA,
        gemma3's local layers)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def layer_is_global(self, i: int) -> bool:
        """gemma3-style local:global pattern; True ⇒ full attention."""
        if self.global_every is None:
            return self.sliding_window is None
        return (i + 1) % self.global_every == 0

    @property
    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula as written:
        embeddings, attention and MLP or expert matrices and the router
        (the norm scales left out); for the ``"ssm"`` family five d×d
        time-mix matrices, the decay LoRA and the two channel-mix
        matrices a layer; for the ``"hybrid"`` family ``6d² + 2d·n + 2d``
        a Mamba-2 layer plus one shared attention + MLP block; for
        ``"encdec"`` also the encoder's attention + MLP blocks and a
        cross-attention a decoder layer; for ``"vlm"`` also the d×d
        projector. The two recurrent families' module trees hold more
        than the formula (the mix and decay vectors, the Δ projection,
        the conv); the tests compare the trees with the reference's
        trees, not with it."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd, Hq, Hkv = self.head_dim, self.num_heads, self.num_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (Hq + 2 * Hkv) + Hq * hd * d
        mlp = (3 if self.mlp_gated else 2) * d * f
        if self.family == "moe":
            mlp = self.num_experts * 3 * d * f + d * self.num_experts
        if self.family == "ssm":
            per_layer = 5 * d * d + d * 64 + 64 * d + 2 * d * f
        elif self.family == "hybrid":
            per_layer = 6 * d * d + 2 * d * self.ssm_state + d * 2
        else:
            per_layer = attn + mlp
        total = emb + L * per_layer
        if self.family == "encdec":
            total += self.encoder_layers * (attn + mlp) + L * attn
        if self.family == "hybrid" and self.shared_attn_every:
            total += attn + 3 * d * f
        if self.family == "vlm":
            total += d * d
        return int(total)

    @property
    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: its top-k experts only)."""
        if self.family != "moe":
            return self.param_count
        d, f, L = self.d_model, self.d_ff, self.num_layers
        unused = (self.num_experts - self.num_experts_per_tok) * 3 * d * f
        return int(self.param_count - L * unused)
