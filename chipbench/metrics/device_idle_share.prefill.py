"""The card's idle share of the traced prefill slice, in %: one less the
union of its operations over the slice's wall time."""


def read(ctx):
    if not ctx or "prefill" not in ctx or not ctx["trace"]["device_ops"]:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
