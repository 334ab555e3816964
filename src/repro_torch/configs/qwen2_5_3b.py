"""Qwen2.5-3B — dense GQA decoder with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-3B model card (GQA 16/2, qkv bias, tied embeds)",
)
