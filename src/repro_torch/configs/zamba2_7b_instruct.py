"""Zamba2-7B-Instruct at its published block
[hf:Zyphra/Zamba2-7B-Instruct, config.json; layer equations of
transformers' ``modeling_zamba2.py``].

81 Mamba-2 blocks of width 3,584 (112 SSD heads of 64, state 64, B and C
in 2 groups, conv of 4 with a bias, chunk 256). Before the Mamba-2 block
of each of the 13 ``hybrid_layer_ids``, one of two shared blocks (in
turn) runs over the hidden state concatenated with the embedding (7,168
wide): RMS norm, 32 heads of 224 (scale (224 / 2)^-0.5, rope over the
whole head), RMS norm, a GeGLU MLP of 14,336 with the call's own rank-128
adapter on its gate and up projections; the call's 3,584² ``linear`` adds
the result to that block's mixer input. Tied embeddings, 7.36 B
parameters. It is kept out of ``configs.ARCHS`` (the JAX package has no
such model): import this module for it.
"""

from repro_torch.models.zamba2_layout import Zamba2LayoutConfig

CONFIG = Zamba2LayoutConfig(
    name="zamba2-7b-instruct",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=10000.0,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    mamba_version=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    attention_hidden_size=7168,
    num_mem_blocks=2,
    adapter_rank=128,
    mamba_ngroups=2,
    norm_eps=1e-5,
    act="gelu_exact",
    tie_embeddings=True,
    source=("https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/"
            "config.json"),
)
