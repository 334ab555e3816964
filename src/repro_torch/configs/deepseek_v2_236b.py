"""DeepSeek-V2 236B — MLA + fine-grained MoE [arXiv:2405.04434].

MLA: kv_lora_rank=512, q_lora_rank=1536, decoupled rope head 64.
MoE: 2 shared + 160 routed experts, top-6, expert FFN 1536; the first
layer keeps a dense FFN (12288).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,                # dense FFN of the first layer
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    source="arXiv:2405.04434 (DeepSeek-V2: 60L, MLA r_kv=512, 160e top-6)",
)
