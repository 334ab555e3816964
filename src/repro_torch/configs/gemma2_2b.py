"""Gemma-2 2B — alternating local/global attention + logit softcaps
[arXiv:2408.00118]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    sliding_window=4096,
    local_global_every=2,      # odd layers global, even layers local-4096
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    act="gelu",
    source="arXiv:2408.00118 (Gemma 2: 2.6B, SWA 4096 alternating, softcaps)",
)
