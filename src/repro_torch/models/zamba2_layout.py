"""The configuration of the published Zamba2 layout (Zamba2-7B-Instruct,
transformers' ``modeling_zamba2.py``), which the JAX package has no
counterpart of.

``ModelConfig`` stays the reference's, field for field; this subclass adds
what the published layout needs. Before the Mamba-2 block of each layer in
``hybrid_layer_ids``, shared block ``k % num_mem_blocks`` (the k-th call)
attends over [x, embedding] (``attention_hidden_size`` wide) with its
scores scaled by (head_dim / 2)^-0.5, its MLP carries call k's own
rank-``adapter_rank`` adapter, and the call's ``linear`` adds the result
to that block's mixer input; the Mamba-2 mixers take B and C in
``mamba_ngroups`` state groups.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Zamba2LayoutConfig(ModelConfig):
    hybrid_layer_ids: tuple = ()
    attention_hidden_size: int = 0
    num_mem_blocks: int = 0
    adapter_rank: int = 0
    mamba_ngroups: int = 1

    def __post_init__(self):
        super().__post_init__()
        # a list from a JSON file compares equal to the module's tuple
        object.__setattr__(self, "hybrid_layer_ids",
                           tuple(self.hybrid_layer_ids))

    def param_count(self) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        di, N, G = self.d_inner, self.ssm_state, self.mamba_ngroups
        heads = di // self.ssm_head_dim
        conv = di + 2 * G * N
        mixer = (D * (di + conv + heads) + conv * (self.ssm_conv + 1)
                 + di * D + 3 * heads + di + D)
        A = self.attention_hidden_size
        block = A * (H + 2 * K) * hd + H * hd * D + 3 * D * F + A + D
        calls = len(self.hybrid_layer_ids)
        return (V * D * (1 if self.tie_embeddings else 2) + D
                + self.n_layers * mixer + self.num_mem_blocks * block
                + calls * (self.adapter_rank * (D + 2 * F) + D * D))


def is_published(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` is a hybrid in the published Zamba2 layout."""
    return isinstance(cfg, Zamba2LayoutConfig) and bool(cfg.hybrid_layer_ids)


def mamba_ngroups(cfg: ModelConfig) -> int:
    """B and C's state groups of the published mixer, 0 for the
    reference's mixer."""
    return cfg.mamba_ngroups if is_published(cfg) else 0
