"""The fused placement kernel's share of its roofline, in %: the least
time a launch needs (``counts/fused_place.py`` at the H100's peaks)
over its mean device time in the traced slice. A launch's commits are
the traced batch's commits (the program's ``lp_completed`` plus
``hp_preempted``: each commit adds one to the first, and only a
preemption takes one off, counting it in the second) over the batch's
launches."""

from chipbench import peaks
from chipbench.counts import fused_place
from chipbench.trace import kernel_time


def read(ctx):
    if not ctx or "fleet" not in ctx:
        return None
    n, seconds = kernel_time(ctx["trace"], "fused_place_kernel")
    fl = ctx["fleet"]
    if not n or fl["committed_per_fused_launch"] is None:
        return None
    shape = (fl["replicas"], fl["devices"], fl["list_tracks"],
             fl["windows"], fl["committed_per_fused_launch"])
    bound = peaks.bound_s(fused_place.launch_ops(*shape),
                          peaks.FP32_FLOP_PER_S,
                          fused_place.launch_bytes(*shape))
    return 100.0 * bound / (seconds / n)
