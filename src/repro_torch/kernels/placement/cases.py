"""Seeded inputs for the placement kernels: random rows, and hand-built
rows that each drive one corner of the selection and commit.

The same numpy arrays go to the JAX package and to this one in the tests,
and to the CUDA kernels and their plain versions in ``chip_smoke.py``. A
``fused_place`` case is the tuple ``(t1, t2, valid, min_dur, q1, dl, src,
do)``; a ``fanout_commit`` case (an HP commit on one device, given apart)
the tuple ``(t1, t2, valid, min_dur, s, e, do)``. Both have Dev=4 (another
count for random rows if asked), CFG=3 (hp, lp2, lp4), T=2, W=16.
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


#: what each row of ``hp_adversarial_case`` exercises, in row order (an HP
#: commit trims one track of every list)
HP_ROWS = (
    "do_false",            # a commit masked off, over a stale slot
    "equal_overlap",       # two tracks of the hp list overlap the slot
    #                        equally, over two windows on one of them and
    #                        three on the other; track 0 is cut
    "straddle_no_slot",    # a straddle's right piece finds no free slot,
    #                        in every list
    "overlap_sum_order",   # two tracks' overlaps tie when summed lane 0
    #                        to 15 in order, not when summed as a tree
    "stale_invalid",       # slots left invalid (housekeeping invalidates
    #                        without resetting) come back as BIG
    "preempt_no_overlap",  # the slot overlaps no window, as a preemption's
    #                        may: nothing changes
)


def random_hp_case(b: int, seed: int = 0, do_rate: float = 0.8,
                   dev: int = DEV):
    """``b`` random rows of ``dev`` devices for ``fanout_commit``: the
    windows of ``random_case`` (invalid slots keep stale times), a slot
    ``[s, e)`` of 0.5 to 10 s starting anywhere in the windows' span."""
    t1, t2, valid, md, _, _, _, _ = random_case(b, seed, dev=dev)
    rng = np.random.default_rng(seed + 1000)
    s = rng.uniform(0, 60, b).astype(np.float32)
    e = (s + rng.uniform(0.5, 10, b)).astype(np.float32)
    do = rng.random(b) < do_rate
    return t1, t2, valid, md, s, e, do


def hp_adversarial_case(dev: int = 0):
    """One row per entry of ``HP_ROWS``, each committing on device ``dev``
    (the other devices hold windows the commit must leave alone)."""
    n = len(HP_ROWS)
    t1 = np.full((n, DEV, CFG, T, W), 1e30, np.float32)
    t2 = np.full_like(t1, 1e30)
    valid = np.zeros(t1.shape, bool)
    md = np.tile(MIN_DUR, (n, 1))
    s = np.full(n, 20.0, np.float32)
    e = (s + MIN_DUR[HP]).astype(np.float32)
    do = np.ones(n, bool)

    def win(r, c, t, w, a, b, d=dev):
        t1[r, d, c, t, w], t2[r, d, c, t, w], valid[r, d, c, t, w] = a, b, True

    def stale(r, c, t, w, a, b, d=dev):
        t1[r, d, c, t, w], t2[r, d, c, t, w] = a, b

    for r in range(n):                      # another device, untouched
        other = (dev + 1) % DEV
        for c in range(CFG):
            win(r, c, 0, 0, 0.0, 100.0, d=other)
        stale(r, HP, 1, 3, 40.0, 45.0, d=other)

    r = HP_ROWS.index("do_false")
    for c in range(CFG):
        win(r, c, 0, 0, 10.0, 100.0)
    stale(r, HP, 1, 2, 40.0, 45.0)
    do[r] = False

    r = HP_ROWS.index("equal_overlap")
    # [10, 16) overlaps track 0 by 2 + 2 + 0.5 and track 1 by 3 + 1.5
    s[r], e[r] = 10.0, 16.0
    for w, (a, b) in enumerate([(10.0, 12.0), (13.0, 15.0), (15.5, 17.0)]):
        win(r, HP, 0, w, a, b)
    for w, (a, b) in enumerate([(10.0, 13.0), (14.0, 15.5)]):
        win(r, HP, 1, w, a, b)
    for t in range(T):
        win(r, LP2, t, 0, 0.0, 100.0)
    win(r, LP4, 0, 0, 0.0, 100.0)

    r = HP_ROWS.index("straddle_no_slot")
    # [50, 50.98) inside [0, 200): both pieces survive, and the other 15
    # slots of the track are full of short windows
    s[r] = 50.0
    e[r] = np.float32(50.0) + MIN_DUR[HP]
    for c in range(CFG):
        win(r, c, 0, 0, 0.0, 200.0)
        for w in range(1, W):
            win(r, c, 0, w, 300.0 + 10 * w, 305.0 + 10 * w)

    r = HP_ROWS.index("overlap_sum_order")
    # the rows of adversarial_case's "overlap_sum_order": [0, 17.19924)
    # overlaps the hp list's track 0 in three windows whose f32 sum is
    # 6.51 lane by lane and 6.5099998 as a butterfly adds them, and track 1
    # in one window of 6.51; in order the tracks tie and track 0 is cut
    s[r] = 0.0
    e[r] = MIN_DUR[LP2]
    for w, (a, b) in enumerate([(1.05, 4.96), (7.82, 9.63), (13.1, 13.89)]):
        win(r, HP, 0, w, a, b)
    win(r, HP, 1, 0, 0.0, 6.51)

    r = HP_ROWS.index("stale_invalid")
    for c in range(CFG):
        win(r, c, 0, 0, 10.0, 100.0)
    for w in range(2, 5):
        stale(r, HP, 1, w, 30.0 + w, 31.0 + w)
    stale(r, LP4, 1, 0, 5.0, 6.0)

    r = HP_ROWS.index("preempt_no_overlap")
    # [10, 10.98) before every window of the device
    s[r] = 10.0
    e[r] = np.float32(10.0) + MIN_DUR[HP]
    for c in range(CFG):
        win(r, c, 0, 0, 30.0, 100.0)
    return t1, t2, valid, md, s, e, do


def with_hp_adversarial_rows(case, dev: int = 0):
    """An HP ``case`` with its first rows replaced by the adversarial ones
    of ``dev``."""
    adv = hp_adversarial_case(dev)
    out = tuple(x.copy() for x in case)
    n = min(len(adv[0]), len(out[0]))
    for x, a in zip(out, adv):
        x[:n] = a[:n]
    return out
