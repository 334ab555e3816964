"""Zamba2-7B — Mamba-2 backbone with a shared attention block
[arXiv:2411.15242].

81 Mamba-2 blocks; one *shared* transformer block (attention + MLP with a
single parameter set) is interleaved after every 6th SSM block — the
Zamba parameter-sharing trick.  d_inner=7168, 112 SSD heads of 64, N=64.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    mamba_version=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    shared_attn_every=6,
    source="arXiv:2411.15242 (Zamba2: Mamba2 + shared attn blocks)",
)
