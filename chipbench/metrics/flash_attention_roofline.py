"""The bfloat16 flash-attention kernel's share of its roofline over the
traced prefill slice, in %: the sum of each launch's least time (its
causal operations at the bf16 peak, or its bytes at the HBM bandwidth,
whichever is larger; ``counts/<count>.py``) over the sum of the
launches' device times. Nothing is read where the slice's launches are
not the ones the count expects, one a layer of each traced step."""

import importlib

from chipbench import peaks
from chipbench.trace import kernel_time


def read(ctx):
    if not ctx or "prefill" not in ctx:
        return None
    pf = ctx["prefill"]
    count = importlib.import_module(f"chipbench.counts.{pf['count']}")
    launches = [op for B, S in pf["traced_steps"]
                for op in count.attention_launches(pf["config"], S, B)]
    n, seconds = kernel_time(ctx["trace"], "flash_attention_wgmma_kernel")
    if not n or n != len(launches):
        return None
    bound = sum(peaks.bound_s(ops, peaks.BF16_FLOP_PER_S, nbytes)
                for ops, nbytes in launches)
    return 100.0 * bound / seconds
