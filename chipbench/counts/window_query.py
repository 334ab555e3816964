"""One launch of the batched window query (``kernels/window_query``):
the earliest feasible slot in each of ``rows`` lists of ``tw`` windows.

Each window's ``t1``, ``t2`` and ``valid`` are read once (9 bytes), the
batched form's three f32 parameters a row (``q1``, ``deadline``,
``dur``) once, and ``start`` and ``found`` written once (8 bytes a row);
about 6 f32 operations a window (max, add, min, compare, and, min).
"""


def launch_bytes(rows, tw):
    return rows * (9 * tw + 12 + 8)


def launch_ops(rows, tw):
    return 6 * rows * tw
