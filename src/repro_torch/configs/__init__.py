"""Assigned-architecture registry: ``get_config(arch_id)`` / ``ARCHS``.

Every config cites its source in ``ModelConfig.source``.  ``reduced()``
produces the ≤512-wide, 2-layer smoke variant of the same family.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "falcon-mamba-7b",
    "qwen2.5-3b",
    "llava-next-34b",
    "deepseek-v2-236b",
    "kimi-k2-1t-a32b",
    "moonshot-v1-16b-a3b",
    "granite-8b",
    "seamless-m4t-medium",
    "gemma2-2b",
    "zamba2-7b",
    "waste-pipeline",  # the paper's own application (§III)
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests:
    2 layers, d_model ≤ 512, ≤ 4 experts."""
    kw: dict = dict(
        n_layers=2,
        d_model=256,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
        dtype="float32",
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, min(cfg.n_kv_heads, 2))
    if cfg.uses_moe:
        kw["n_experts"] = 4
        kw["top_k"] = 2
        kw["moe_d_ff"] = 128
        kw["n_shared_experts"] = min(cfg.n_shared_experts, 1)
        kw["first_dense_layers"] = min(cfg.first_dense_layers, 1)
    if cfg.use_mla:
        kw["kv_lora_rank"] = 64
        kw["q_lora_rank"] = 96
        kw["rope_head_dim"] = 16
    if cfg.ssm_state:
        kw["ssm_state"] = min(cfg.ssm_state, 16)
        kw["ssm_chunk"] = 16
        kw["ssm_head_dim"] = 32
    if cfg.arch_type == "hybrid":
        kw["n_layers"] = 5
        kw["shared_attn_every"] = 2
    if cfg.is_encoder_decoder:
        kw["n_encoder_layers"] = 2
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.n_media_tokens:
        kw["n_media_tokens"] = 16
    return dataclasses.replace(cfg, **kw)
