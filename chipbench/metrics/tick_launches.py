"""Kernel launches a fleet tick: the device's kernels (not its copies or
fills) in the traced slice over the slice's ticks."""


def read(ctx):
    if not ctx or "ticks" not in ctx or not ctx["trace"]["launches"]:
        return None
    return ctx["trace"]["launches"] / ctx["ticks"]
