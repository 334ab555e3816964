"""Moonlight-16B-A3B — small-activation MoE [hf:moonshotai/Moonlight-16B-A3B].

64 routed experts top-6 (+2 shared), expert FFN 1408, dense first layer
(11264); 16 MHA heads (kv=16).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=11264,                # dense FFN of the first layer
    vocab_size=163840,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    source="hf:moonshotai/Moonlight-16B-A3B (DeepSeek-V3-style MoE)",
)
