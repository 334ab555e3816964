"""Operations and bytes of one prefill step of a dense decoder with
grouped-query attention (``reference/dense_decoder.py``'s model, read
from the configuration's keys): B prompts of S positions each.

The model's FLOPs are its matmuls at 2 a multiply-add: per layer the
q, k, v and o projections and the gated MLP's three, at every position;
the logits at each prompt's last position, the first token's, which is
all a prefill serves (the port's forward computes them at every
position: ``logit_flops`` of the rest is its own waste, not counted);
and causal attention, ``q k^T`` and the weights times v over the pairs
of a query and a key at or before it, S(S+1)/2 of them. Elementwise
work (norms, rope, softmax, the residuals) is not counted.

A launch of the attention kernel (one a layer) reads q [B, H, S, hd], k
and v [B, K, S, hd] once and writes its output [B, H, S, hd] once, in
bfloat16.
"""

from chipbench.reference.dense_decoder import dims


def causal_pairs(S: int) -> int:
    """Pairs of a query and a key at or before it."""
    return S * (S + 1) // 2


def layer_flops(config: dict, S: int) -> int:
    """The projections and the MLPs of every layer at all S positions."""
    L, D, H, K, hd, F, V = dims(config)
    return 2 * S * L * (2 * D * H * hd + 2 * D * K * hd + 3 * D * F)


def logit_flops(config: dict, positions: int) -> int:
    """The logits at ``positions`` positions."""
    L, D, H, K, hd, F, V = dims(config)
    return 2 * positions * D * V


def attention_flops(config: dict, S: int, causal: bool = True) -> int:
    """``q k^T`` and the weights times v of every layer: over the causal
    pairs, or over all S^2 (what a masked dense product computes)."""
    L, D, H, K, hd, F, V = dims(config)
    pairs = causal_pairs(S) if causal else S * S
    return L * 4 * H * hd * pairs


def forward_flops(config: dict, S: int, B: int = 1) -> int:
    """The model FLOPs of a causal prefill of B prompts of S positions."""
    return B * (layer_flops(config, S) + logit_flops(config, 1)
                + attention_flops(config, S))


def attention_launches(config: dict, S: int,
                       B: int = 1) -> list[tuple[int, int]]:
    """``(ops, bytes)`` of each attention launch of one step."""
    L, D, H, K, hd, F, V = dims(config)
    ops = B * 4 * H * hd * causal_pairs(S)
    nbytes = B * 2 * S * hd * (2 * H + 2 * K)
    return [(ops, nbytes)] * L
