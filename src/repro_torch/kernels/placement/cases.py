"""Seeded inputs for the fused placement kernel: random rows, and
hand-built rows that each drive one corner of the selection and commit.

The same numpy arrays go to the JAX package and to this one in the tests,
and to the CUDA kernel and its plain version in ``chip_smoke.py``. Every
case is the tuple ``(t1, t2, valid, min_dur, q1, dl, src, do)`` of
``fused_place`` with Dev=4 (another count for random rows if asked), CFG=3
(hp, lp2, lp4), T=2, W=16.
"""

from __future__ import annotations

import numpy as np

DEV, CFG, T, W = 4, 3, 2, 16
HP, LP2, LP4 = 0, 1, 2
#: the fleet's per-config minimum durations (padded processing times)
MIN_DUR = np.array([0.98, 17.19924, 11.84322], np.float32)

#: what each row of ``adversarial_case`` exercises, in row order
ADVERSARIAL_ROWS = (
    "do_false",            # a feasible attempt masked off
    "equal_starts",        # three devices tie on start; the first wins
    "src_pref_wins",       # the source device starts 0.5 ms later, wins
    "src_pref_loses",      # the source device starts 2 ms later, loses
    "lp4_fallback",        # lp2 fits nowhere, lp4 does
    "equal_overlap",       # two tracks overlap the commit equally, over
    #                        three windows on one of them; track 0 is cut
    "straddle_no_slot",    # a straddle's right piece finds no free slot
    "overlap_sum_order",   # two tracks' overlaps tie when summed lane 0
    #                        to 15 in order, not when summed as a tree
)


def random_case(b: int, seed: int = 0, do_rate: float = 0.8,
                dev: int = DEV):
    """``b`` random rows of ``dev`` devices: windows sorted by start within
    each track."""
    rng = np.random.default_rng(seed)
    t1 = rng.uniform(0, 50, (b, dev, CFG, T, W)).astype(np.float32)
    t2 = (t1 + rng.uniform(0.1, 30, t1.shape)).astype(np.float32)
    valid = rng.random(t1.shape) < 0.6
    order = np.argsort(np.where(valid, t1, 1e9), axis=-1)
    t1 = np.take_along_axis(t1, order, -1)
    t2 = np.take_along_axis(t2, order, -1)
    valid = np.take_along_axis(valid, order, -1)
    md = rng.uniform(1, 8, (b, CFG)).astype(np.float32)
    q1 = rng.uniform(0, 40, (b, dev)).astype(np.float32)
    dl = (q1 + rng.uniform(5, 40, q1.shape)).astype(np.float32)
    src = rng.integers(0, dev, b).astype(np.int32)
    do = rng.random(b) < do_rate
    return t1, t2, valid, md, q1, dl, src, do


def adversarial_case():
    """One row per entry of ``ADVERSARIAL_ROWS``."""
    n = len(ADVERSARIAL_ROWS)
    t1 = np.full((n, DEV, CFG, T, W), 1e30, np.float32)
    t2 = np.full_like(t1, 1e30)
    valid = np.zeros(t1.shape, bool)
    md = np.tile(MIN_DUR, (n, 1))
    q1 = np.full((n, DEV), 5.0, np.float32)
    dl = np.full((n, DEV), 80.0, np.float32)
    src = np.zeros(n, np.int32)
    do = np.ones(n, bool)

    def win(r, d, c, t, w, a, b):
        t1[r, d, c, t, w], t2[r, d, c, t, w], valid[r, d, c, t, w] = a, b, True

    def open_device(r, d, a=10.0, b=100.0):
        for c in range(CFG):
            for t in range(T):
                win(r, d, c, t, 0, a, b)

    r = ADVERSARIAL_ROWS.index("do_false")
    open_device(r, 1)
    src[r], do[r] = 1, False

    r = ADVERSARIAL_ROWS.index("equal_starts")
    for d in range(3):
        open_device(r, d)
    src[r] = 3                              # the source device is full

    r = ADVERSARIAL_ROWS.index("src_pref_wins")
    open_device(r, 0, a=10.0)
    open_device(r, 2, a=10.0005)
    src[r] = 2

    r = ADVERSARIAL_ROWS.index("src_pref_loses")
    open_device(r, 0, a=10.0)
    open_device(r, 2, a=10.002)
    src[r] = 2

    r = ADVERSARIAL_ROWS.index("lp4_fallback")
    for c in range(CFG):                    # 15 s: too short for lp2
        win(r, 3, c, 0, 0, 10.0, 25.0)
    src[r] = 3

    r = ADVERSARIAL_ROWS.index("equal_overlap")
    # lp2 lands on [10, 27.19924); the hp list overlaps it by 6 s on both
    # tracks, in three windows on track 0 and two on track 1
    win(r, 0, LP2, 0, 0, 10.0, 100.0)
    win(r, 0, LP4, 0, 0, 10.0, 100.0)
    for w, (a, b) in enumerate([(10.0, 12.0), (13.0, 15.0), (16.0, 18.0)]):
        win(r, 0, HP, 0, w, a, b)
    for w, (a, b) in enumerate([(10.0, 13.0), (14.0, 17.0)]):
        win(r, 0, HP, 1, w, a, b)

    r = ADVERSARIAL_ROWS.index("straddle_no_slot")
    # lp2 lands on [50, 67.19924) inside [0, 200): both pieces survive,
    # and the other 15 slots of the track are full of short windows
    q1[r], dl[r] = 50.0, 120.0
    for c in range(CFG):
        win(r, 0, c, 0, 0, 0.0, 200.0)
        for w in range(1, W):
            win(r, 0, c, 0, w, 300.0 + 10 * w, 305.0 + 10 * w)

    r = ADVERSARIAL_ROWS.index("overlap_sum_order")
    # lp2 lands on [0, 17.19924); the hp list's track 0 overlaps it in
    # three windows whose f32 sum is 6.51 lane by lane, ((0 + x0) + x1) +
    # x2, but 6.5099998 as a butterfly adds them, (x0 + x2) + x1; track 1
    # overlaps it in one window of 6.51. In order the tracks tie and track
    # 0 is cut; in a tree track 1 would win and be cut instead.
    q1[r] = 0.0
    for c in (LP2, LP4):
        for t in range(T):
            win(r, 0, c, t, 0, 0.0, 100.0)
    for w, (a, b) in enumerate([(1.05, 4.96), (7.82, 9.63), (13.1, 13.89)]):
        win(r, 0, HP, 0, w, a, b)
    win(r, 0, HP, 1, 0, 0.0, 6.51)
    return t1, t2, valid, md, q1, dl, src, do


def with_adversarial_rows(case):
    """``case`` with its first rows replaced by the adversarial ones."""
    adv = adversarial_case()
    out = tuple(x.copy() for x in case)
    n = min(len(adv[0]), len(out[0]))
    for x, a in zip(out, adv):
        x[:n] = a[:n]
    return out
