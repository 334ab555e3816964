"""SeamlessM4T-medium — encoder-decoder audio/text [arXiv:2308.11596].

The mel-spectrogram + conformer feature frontend is a STUB per the brief:
``input_specs`` provides frame embeddings; we implement the text decoder
(causal self-attn + cross-attn) over the 12-layer encoder.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12,               # decoder
    n_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    act="gelu",
    source="arXiv:2308.11596 (SeamlessM4T medium: 12+12, d=1024)",
)
