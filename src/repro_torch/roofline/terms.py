"""Roofline terms of one step per H100: the port of
``repro/roofline/hlo.py``.

Hardware model: NVIDIA H100 SXM, from NVIDIA's data sheet (the card at its
700 W limit): 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32
outside them, 3.35 TB/s of HBM3; and between cards, 8 cards a node joined
by NVLink 4 at 450 GB/s a direction (900 GB/s both ways), and one 400 Gb/s
NDR InfiniBand port a card, 50 GB/s, between nodes. These are data-sheet
figures, not measurements.

    compute term    = dot FLOPs a chip / peak FLOP/s of the config's dtype
    memory term     = (argument bytes / chips + dot bytes a chip) / HBM
    collective term = sum over the collectives' groups of their wire bytes
                      a chip / the link of the group

A group whose ranks all sit in one node (ranks laid out row-major, 8 a
node, as ``launch/mesh.py`` lays them) is charged at NVLink's rate, any
other at InfiniBand's: on 16 x 16 both axes cross nodes. The dot FLOPs,
dot bytes and wire bytes come from ``roofline/trace.py``: every matmul and
collective one rank runs, each counted as often as it runs, which is what
the reference's trip-weighted per-partition HLO analysis counts.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12            # H100 SXM, non-tensor f32
BF16_OPS_PER_S = 989e12           # H100 SXM, dense bf16 tensor cores
SMS = 132                         # H100 SXM
BOOST_CLOCK_HZ = 1.98e9           # H100 SXM, data sheet's maximum boost
EX2_PER_CLOCK_SM = 16             # special-function unit results a clock

NVLINK_BYTES_PER_S = 450e9       # NVLink 4, a direction, a card
IB_BYTES_PER_S = 50e9            # one 400 Gb/s NDR port a card
CARDS_PER_NODE = 8               # an HGX H100 node

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


def link_bytes_per_s(ranks) -> float:
    """The rate a collective over ``ranks`` is charged at: NVLink inside
    one node, InfiniBand across nodes."""
    nodes = {r // CARDS_PER_NODE for r in ranks}
    return NVLINK_BYTES_PER_S if len(nodes) == 1 else IB_BYTES_PER_S


def collective_seconds(wire_by_group: dict) -> float:
    """Σ wire bytes / link rate over the groups (group ranks -> bytes)."""
    return sum(b / link_bytes_per_s(g) for g, b in wire_by_group.items())


def roofline_terms(cfg, shape, counts: dict, arg_bytes: float,
                   n_chips: int = 1) -> dict:
    """The reference's roofline terms (seconds, a chip of ``n_chips``),
    with its keys, the bottleneck of the three and the useful-FLOPs
    ratio. ``counts`` is ``trace.StepTrace.counts()`` of one rank:
    ``dot_flops``, ``dot_bytes`` and, on a mesh, ``collectives`` and
    ``wire_by_group``; ``arg_bytes`` the step's global arguments
    (parameters, optimizer moments, decode state, batch), each read or
    written once a step, a chip reading its share."""
    flops = counts["dot_flops"]
    dot_bytes = counts["dot_bytes"]
    wire = counts.get("collectives", {}).get("total_wire_bytes", 0.0)
    mf = model_flops(cfg, shape)
    arg_chip = arg_bytes / n_chips
    compute_s = flops / PEAK_OPS_PER_S[cfg.dtype]
    memory_s = (arg_chip + dot_bytes) / HBM_BYTES_PER_S
    collective_s = collective_seconds(counts.get("wire_by_group", {}))
    mf_chip = mf / n_chips
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "hlo_flops_per_chip": flops,
        "model_flops": mf,
        "model_flops_per_chip": mf_chip,
        "useful_flops_ratio": mf_chip / flops if flops > 0 else -1.0,
        "arg_bytes_per_chip": arg_chip,
        "dot_bytes_per_chip": dot_bytes,
        "wire_bytes_per_chip": wire,
    }
    terms["bottleneck"] = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1])[0]
    return terms
