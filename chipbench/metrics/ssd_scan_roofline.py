"""The bfloat16 SSD-scan kernel's share of its roofline over the traced
prefill slice, in %: the sum of each launch's least time (its bytes at
the HBM bandwidth, or its products at the bf16 peak, whichever is larger;
``counts/<count>.py``'s ``ssd_launches``) over the sum of the launches'
device times. Nothing is read where the configuration's count has no SSD
launches, or where the slice's launches are not the ones it expects, one
a Mamba-2 layer of each traced step."""

import importlib

from chipbench import peaks
from chipbench.trace import kernel_time


def read(ctx):
    if not ctx or "prefill" not in ctx:
        return None
    pf = ctx["prefill"]
    count = importlib.import_module(f"chipbench.counts.{pf['count']}")
    if not hasattr(count, "ssd_launches"):
        return None
    launches = [op for B, S in pf["traced_steps"]
                for op in count.ssd_launches(pf["config"], S, B)]
    n, seconds = kernel_time(ctx["trace"], "ssd_scan_mma_kernel")
    if not n or n != len(launches):
        return None
    bound = sum(peaks.bound_s(ops, peaks.BF16_FLOP_PER_S, nbytes)
                for ops, nbytes in launches)
    return 100.0 * bound / seconds
