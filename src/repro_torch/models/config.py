"""Unified model configuration covering all assigned architecture families.

One frozen dataclass describes dense, GQA, MLA, MoE, SSM (Mamba-1/2),
hybrid (Mamba + shared attention), encoder-decoder (audio) and VLM decoder
architectures; the block assembly in :mod:`repro.models.transformer` reads
only this config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # -- attention ----------------------------------------------------------
    rope_theta: float = 1e4
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0   # gemma2 attention softcap
    final_logit_softcap: float = 0.0  # gemma2 final logit softcap
    sliding_window: int = 0           # window size for local layers (0 = none)
    local_global_every: int = 0       # every k-th layer is global (gemma2: 2)

    # -- MLA (deepseek-v2) -----------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64

    # -- MoE --------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert FFN width
    capacity_factor: float = 1.25
    first_dense_layers: int = 0       # leading dense (non-MoE) layers
    router_aux_weight: float = 0.01

    # -- SSM ----------------------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1
    ssm_head_dim: int = 64            # mamba2 P (head channel dim)
    ssm_chunk: int = 256

    # -- hybrid (zamba2) -------------------------------------------------------------
    shared_attn_every: int = 0        # shared attn block after every k SSM blocks

    # -- encoder-decoder (seamless) -----------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # -- modality frontend stub ---------------------------------------------------------
    frontend: str = ""                # "vision" | "audio" | ""
    n_media_tokens: int = 0           # patch/frame embeddings per sample

    # -- misc -------------------------------------------------------------------------
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                  # citation for the config numbers

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # -- derived -----------------------------------------------------------------------

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def uses_moe(self) -> bool:
        return self.n_experts > 0

    def window_for_layer(self, i: int) -> int:
        """Sliding-window size of decoder layer ``i`` (-1 = global)."""
        if self.sliding_window <= 0:
            return -1
        if self.local_global_every and (i % self.local_global_every
                                        == self.local_global_every - 1):
            return -1  # every k-th layer attends globally
        return self.sliding_window

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb
        n_dec = self.n_layers
        if self.arch_type == "ssm":
            di, N = self.d_inner, self.ssm_state
            per = (
                D * 2 * di            # in_proj (x and z)
                + di * self.ssm_conv  # conv
                + di * (2 * N + 1)    # B,C,dt projections (x -> dt,B,C)
                + di * N              # A
                + di * D              # out_proj
                + 2 * D               # norms
            )
            return total + n_dec * per
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        if self.use_mla:
            r, rh = self.kv_lora_rank, self.rope_head_dim
            attn = (
                D * (self.q_lora_rank or D)
                + (self.q_lora_rank or D) * H * (hd + rh)
                + D * (r + rh)
                + r * H * (hd + hd)
                + H * hd * D
            )
        mlp_dense = 3 * D * F
        if self.uses_moe:
            fe = self.moe_d_ff or F
            moe = self.n_experts * 3 * D * fe + self.n_shared_experts * 3 * D * fe
            moe += D * self.n_experts  # router
            n_moe = n_dec - self.first_dense_layers
            total += self.first_dense_layers * (attn + mlp_dense)
            total += n_moe * (attn + moe)
            return total
        if self.arch_type == "hybrid":
            di, N = self.d_inner, self.ssm_state
            heads = di // self.ssm_head_dim
            ssm_per = (
                D * 2 * di + di * self.ssm_conv + di * D
                + heads * (2 * N + 2) * self.ssm_head_dim  # B,C,dt,A per head
                + 2 * D
            )
            n_shared = (
                n_dec // self.shared_attn_every if self.shared_attn_every else 0
            )
            total += n_dec * ssm_per + (attn + mlp_dense)  # one shared block
            total += n_shared * 0
            return total
        n_dec_total = n_dec + self.n_encoder_layers
        cross = D * H * hd + 2 * D * K * hd + H * hd * D if self.is_encoder_decoder else 0
        total += n_dec_total * (attn + mlp_dense) + n_dec * cross
        return total

    def offload_transfer_bytes(self, context_len: int, batch: int = 1) -> int:
        """Bytes that migrate when an in-flight request is offloaded to
        another worker — the scheduler's transfer unit ``D`` for this arch
        (DESIGN.md §4).  Dense/GQA archs ship their KV cache; MLA ships the
        compressed latents; SSM/hybrid ship O(1) recurrent state — the
        quantitative reason offloading SSM work is cheap."""
        bpe = 2  # bf16
        if self.arch_type == "ssm":
            di, N = self.d_inner, self.ssm_state
            state = self.n_layers * di * N * 4           # fp32 h
            conv = self.n_layers * (self.ssm_conv - 1) * di * bpe
            return batch * (state + conv)
        if self.arch_type == "hybrid":
            di, N = self.d_inner, self.ssm_state
            heads = di // self.ssm_head_dim
            state = self.n_layers * heads * self.ssm_head_dim * N * 4
            n_attn = self.n_layers // max(self.shared_attn_every, 1)
            kv = n_attn * context_len * self.n_kv_heads * self.head_dim * 2 * bpe
            return batch * (state + kv)
        if self.use_mla:
            lat = self.n_layers * context_len * (
                self.kv_lora_rank + self.rope_head_dim
            ) * bpe
            return batch * lat
        L = self.n_layers
        kv = L * context_len * self.n_kv_heads * self.head_dim * 2 * bpe
        return batch * kv

    def active_param_count(self) -> int:
        """Active-per-token params (MoE: shared + top-k experts only)."""
        if not self.uses_moe:
            return self.param_count()
        D = self.d_model
        fe = self.moe_d_ff or self.d_ff
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        if self.use_mla:
            r, rh = self.kv_lora_rank, self.rope_head_dim
            attn = (
                D * (self.q_lora_rank or D)
                + (self.q_lora_rank or D) * H * (hd + rh)
                + D * (r + rh)
                + r * H * (hd + hd)
                + H * hd * D
            )
        act_moe = (self.top_k + self.n_shared_experts) * 3 * D * fe
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        n_moe = self.n_layers - self.first_dense_layers
        return (
            emb
            + self.first_dense_layers * (attn + 3 * D * self.d_ff)
            + n_moe * (attn + act_moe)
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
