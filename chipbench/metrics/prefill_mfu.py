"""The prefill window's share of the card's bfloat16 peak, in %: the
model FLOPs of every step outside the traced slice (the configuration's
``counts/<count>.py``: matmuls at every position, the logits at each
prompt's last and causal attention) over the window's time outside the
slice, on the host clock, at 989.4 TFLOP/s. The slice is left out
because the profiler slows the host that issues the steps."""

import importlib

from chipbench import peaks


def read(ctx):
    if not ctx or "prefill" not in ctx:
        return None
    pf = ctx["prefill"]
    if not pf["untraced_steps"] or pf["untraced_s"] <= 0:
        return None
    count = importlib.import_module(f"chipbench.counts.{pf['count']}")
    flops = sum(count.forward_flops(pf["config"], S, B)
                for B, S in pf["untraced_steps"])
    return 100.0 * flops / (pf["untraced_s"] * peaks.BF16_FLOP_PER_S)
