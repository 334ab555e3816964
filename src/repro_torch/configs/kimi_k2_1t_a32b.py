"""Kimi K2 — trillion-parameter MoE, 32B active [arXiv:2501.kimi2 paper-table].

Per the assigned table: 61L, d=7168, 64 query heads with 8 KV heads (GQA),
384 routed experts top-8 with expert FFN 2048, one shared expert, first
layer dense.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,                # dense FFN of the first layer
    vocab_size=163840,
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_dense_layers=1,
    source="arXiv:2501.kimi2 paper table (1T total / 32B active)",
)
