"""IBM Granite-8B-Code — llama-arch dense decoder [arXiv:2405.04324]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=1e7,
    source="arXiv:2405.04324 (Granite Code Models, 8B: 36L GQA 32/8)",
)
