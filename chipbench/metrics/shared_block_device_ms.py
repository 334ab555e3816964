"""Device milliseconds of the program's ``model/shared_block``
spans, one a hybrid call (its shared block and its linear),
per 16,384 prompt tokens of the traced prefill steps: their CUDA-event
times summed over the traced steps. Nothing is read where the program
kept no such spans, or where one has no device time."""

SPAN = "model/shared_block"
TOKENS = 16384


def read(ctx):
    if not ctx or "prefill" not in ctx or not ctx.get("spans"):
        return None
    ms = [r["device_ms"] for r in ctx["spans"] if r["name"] == SPAN]
    if not ms or any(t is None for t in ms):
        return None
    tokens = sum(B * S for B, S in ctx["prefill"]["traced_steps"])
    return sum(ms) * TOKENS / tokens
