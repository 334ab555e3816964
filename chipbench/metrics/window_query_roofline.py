"""The batched window-query kernel's share of its roofline, in %: the
least time a launch over the fleet's HP view (one device's HP list of
every replica) needs, over its mean device time in the traced slice."""

from chipbench import peaks
from chipbench.counts import window_query
from chipbench.trace import kernel_time


def read(ctx):
    if not ctx or "fleet" not in ctx:
        return None
    n, seconds = kernel_time(ctx["trace"], "window_query_kernel")
    if not n:
        return None
    fl = ctx["fleet"]
    rows, tw = fl["replicas"], fl["list_tracks"][0] * fl["windows"]
    bound = peaks.bound_s(window_query.launch_ops(rows, tw),
                          peaks.FP32_FLOP_PER_S,
                          window_query.launch_bytes(rows, tw))
    return 100.0 * bound / (seconds / n)
