"""Device milliseconds a fleet tick: the union of the device's
operations in the traced slice over the slice's ticks."""


def read(ctx):
    if not ctx or "ticks" not in ctx or not ctx["trace"]["device_ops"]:
        return None
    return 1e3 * ctx["trace"]["busy_s"] / ctx["ticks"]
