"""Roofline terms of one step on one H100: the port of
``repro/roofline/hlo.py``.

Hardware model: NVIDIA H100 SXM, from NVIDIA's data sheet (the card at its
700 W limit): 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32
outside them, 3.35 TB/s of HBM3.

    compute term    = dot FLOPs / peak FLOP/s of the config's dtype
    memory term     = (argument bytes + dot bytes) / HBM bytes/s
    collective term = 0: one card has no collective

The dot FLOPs and bytes come from ``roofline/trace.py``: every matmul of
the step as the eager program runs it, each counted as often as it runs,
which is what the reference's trip-weighted HLO analysis counts.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12            # H100 SXM, non-tensor f32
BF16_OPS_PER_S = 989e12           # H100 SXM, dense bf16 tensor cores
SMS = 132                         # H100 SXM
BOOST_CLOCK_HZ = 1.98e9           # H100 SXM, data sheet's maximum boost
EX2_PER_CLOCK_SM = 16             # special-function unit results a clock

#: peak FLOP/s by the config's dtype (``ModelConfig.dtype``)
PEAK_OPS_PER_S = {"bfloat16": BF16_OPS_PER_S, "float32": FP32_OPS_PER_S}


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for training, 2·N_active·D for inference
    (D = processed tokens), plus attention quadratic terms."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    flops = mult * n_active * tokens
    # attention score/value FLOPs (not in param count)
    if cfg.arch_type != "ssm" and cfg.n_heads:
        hd = cfg.head_dim
        H = cfg.n_heads
        L = cfg.n_layers + cfg.n_encoder_layers
        if cfg.arch_type == "hybrid" and cfg.shared_attn_every:
            # only the shared attention block attends (every k-th position)
            L = cfg.n_layers // cfg.shared_attn_every
        if shape.kind == "decode":
            att = 2 * 2 * H * hd * shape.seq_len * shape.global_batch * L
        else:
            causal = 0.5
            att = (
                2 * 2 * H * hd * shape.seq_len ** 2 * causal
                * shape.global_batch * L
            )
        flops += att * (3.0 if shape.kind == "train" else 1.0)
    return flops


def roofline_terms(cfg, shape, counts: dict, arg_bytes: float) -> dict:
    """The reference's roofline terms (seconds) on one card, with its keys,
    the bottleneck and the useful-FLOPs ratio. ``counts`` is
    ``trace.StepTrace.counts()``: ``dot_flops`` and ``dot_bytes``;
    ``arg_bytes`` the step's arguments (parameters, optimizer moments,
    decode state, batch), each read or written once a step."""
    flops = counts["dot_flops"]
    dot_bytes = counts["dot_bytes"]
    mf = model_flops(cfg, shape)
    compute_s = flops / PEAK_OPS_PER_S[cfg.dtype]
    memory_s = (arg_bytes + dot_bytes) / HBM_BYTES_PER_S
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": 0.0,
        "hlo_flops_per_chip": flops,
        "model_flops": mf,
        "model_flops_per_chip": mf,
        "useful_flops_ratio": mf / flops if flops > 0 else -1.0,
        "arg_bytes_per_chip": arg_bytes,
        "dot_bytes_per_chip": dot_bytes,
        "wire_bytes_per_chip": 0.0,
    }
    terms["bottleneck"] = "compute" if compute_s >= memory_s else "memory"
    return terms
