"""Operations and bytes of one prefill step of Zamba2
(``reference/zamba2.py``'s model, read from the configuration's keys): B
prompts of S positions each, S a multiple of ``chunk_size``.

The model's FLOPs are its matmuls at 2 a multiply-add, at every position:
each Mamba-2 layer's in and out projections; each hybrid call's q, k, v
and o projections over the concatenated input, its MLP with the call's
adapter, and its ``linear``; the logits at each prompt's last position
only, which is all a prefill serves (the port's forward computes them at
every position: ``logit_flops`` of the rest is its own waste, not
counted); causal attention over the S(S+1)/2 pairs of a query and a key
at or before it; and the SSD's products as its chunked form computes them
in chunks of Q = ``chunk_size``: a group's ``C B^T``, the weights times x
within a chunk, C times the carried state, and the new state. Elementwise
work (norms, the conv, rope, softmax, the gates, residuals) is not
counted.

An attention launch (one a hybrid call) reads q [B, H, S, hd], k and v
[B, K, S, hd] once and writes its output once, in bfloat16. An SSD launch
(one a Mamba-2 layer) reads x [B, S, H, P] and B and C [B, S, G, N] in
bfloat16, dt [B, S, H] and A [H] in float32, once, and writes y once; its
operations are the chunked form's at the kernel's 64-row chunks (the
causal half of ``C B^T`` and of the weights times x, all of C times the
state and of the state update), as ``chip_smoke.py::ssd_bound`` counts
them.
"""

from chipbench.reference.zamba2 import dims

#: rows of a chunk in the SSD kernel (``kQ`` of ``ssd_scan.cu``)
KERNEL_CHUNK = 64


def causal_pairs(S: int) -> int:
    """Pairs of a query and a key at or before it."""
    return S * (S + 1) // 2


def layer_flops(config: dict, S: int) -> int:
    """Every layer's projections at all S positions: the Mamba-2 layers'
    and the hybrid calls' (attention projections, MLP, adapter,
    ``linear``)."""
    d = dims(config)
    D, di, A, F = d["D"], d["di"], d["A"], d["F"]
    mamba = d["L"] * (D * (di + d["conv"] + d["H_ssm"]) + di * D)
    call = (A * (d["H"] + 2 * d["K"]) * d["hd"] + d["H"] * d["hd"] * D
            + 3 * D * F + d["r"] * (D + 2 * F) + D * D)
    return 2 * S * (mamba + len(d["calls"]) * call)


def logit_flops(config: dict, positions: int) -> int:
    """The logits at ``positions`` positions."""
    d = dims(config)
    return 2 * positions * d["D"] * d["V"]


def attention_flops(config: dict, S: int, causal: bool = True) -> int:
    """``q k^T`` and the weights times v of every hybrid call: over the
    causal pairs, or over all S^2 (what a masked dense product
    computes)."""
    d = dims(config)
    pairs = causal_pairs(S) if causal else S * S
    return len(d["calls"]) * 4 * d["H"] * d["hd"] * pairs


def ssd_flops(config: dict, S: int) -> int:
    """The SSD's products in its chunked form, every Mamba-2 layer."""
    d = dims(config)
    Q, G, N, H, P = d["Q"], d["G"], d["N"], d["H_ssm"], d["P"]
    per_chunk = 2 * Q * Q * (G * N + H * P) + 4 * Q * N * H * P
    return d["L"] * (S // Q) * per_chunk


def forward_flops(config: dict, S: int, B: int = 1) -> int:
    """The model FLOPs of a causal prefill of B prompts of S positions."""
    return B * (layer_flops(config, S) + logit_flops(config, 1)
                + attention_flops(config, S) + ssd_flops(config, S))


def attention_launches(config: dict, S: int,
                       B: int = 1) -> list[tuple[int, int]]:
    """``(ops, bytes)`` of each attention launch of one step."""
    d = dims(config)
    H, K, hd = d["H"], d["K"], d["hd"]
    ops = B * 4 * H * hd * causal_pairs(S)
    nbytes = B * 2 * S * hd * (2 * H + 2 * K)
    return [(ops, nbytes)] * len(d["calls"])


def ssd_launches(config: dict, S: int, B: int = 1) -> list[tuple[int, int]]:
    """``(ops, bytes)`` of each SSD launch of one step."""
    d = dims(config)
    H, P, N, G = d["H_ssm"], d["P"], d["N"], d["G"]
    nbytes = B * S * (2 * 2 * H * P + 4 * H + 2 * 2 * G * N) + 4 * H
    ops = 0
    for t0 in range(0, S, KERNEL_CHUNK):
        q = min(KERNEL_CHUNK, S - t0)
        ops += 2 * causal_pairs(q) * (N + P) + 4 * q * P * N
    return [(B * H * ops, nbytes)] * d["L"]
