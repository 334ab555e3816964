"""LLaVA-NeXT-34B — VLM decoder backbone, anyres tiling stub
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision tower (SigLIP/CLIP) + projector is a STUB per the brief:
``input_specs`` feeds precomputed patch embeddings.  anyres tiling at the
default 2x2 grid + base view = 5 views x 576 patches = 2880 media tokens.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5e6,
    frontend="vision",
    n_media_tokens=2880,       # anyres: (1 base + 4 tiles) x 24x24 patches
    source="hf:llava-hf/llava-v1.6 (34B: Yi-34B backbone 60L/7168)",
)
