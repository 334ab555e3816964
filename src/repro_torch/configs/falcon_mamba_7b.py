"""Falcon-Mamba-7B — attention-free Mamba-1 SSM [arXiv:2410.05355]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                    # attention-free: Mamba block replaces attn+FFN
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    mamba_version=1,
    ssm_chunk=256,
    source="arXiv:2410.05355 (Falcon Mamba: 64 blocks, d=4096, N=16)",
)
