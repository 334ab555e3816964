"""A plain-torch model of the fused placement kernel's warp design, held to
the placement oracles on the CPU.

The CUDA kernel (``kernels/placement/csrc/placement.cu``) runs one warp a
replica, lane l = t*W + w over slot (t, w) of a config list. It cannot run
here (no card, no ``nvcc``); ``chip_smoke.py`` holds it to its plain version
on the H100. What can be checked here is the order of operations it
chooses, written out over an explicit lane axis of 32:

- the earliest feasible start of a list as a butterfly min over the xor
  steps 16, 8, 4, 2, 1 (``__shfl_xor_sync``);
- a track's overlap as a chain of 16 shuffled reads added lane 0 to 15 in
  order from 0.0 (``__shfl_sync``), both tracks side by side;
- ``first_free`` and ``first_both`` as ``__ffs`` of a ballot masked to the
  track's 16 bits, the spill pair read from lane ``first_both``;
- ``n_dropped`` as a popcount of the dropped ballot.

The model is held bit for bit to the port's ``fused_place_ref``, the JAX
package's oracle and its Pallas kernel in interpret mode. A second test
shows why the overlap chain is sequential: the same model with a butterfly
sum of the overlaps ranks the tracks of the ``overlap_sum_order`` row the
other way and trims the other track.
"""

import numpy as np
import pytest
import torch

from repro.kernels.placement.placement import fused_place as fused_place_pallas
from repro.kernels.placement.ref import fused_place_ref as fused_place_j
from repro_torch.core.tensor_state import BIG, OCC_TABLE
from repro_torch.kernels.placement import cases
from repro_torch.kernels.placement.ref import SRC_PREF, fused_place_ref

LANES = 32
LANE = torch.arange(LANES)
OUTPUTS = ("t1", "t2", "valid", "ok", "sel", "start", "dur", "use4",
           "n_dropped")


def shfl(x, src_lane):
    """``__shfl_sync``: each lane reads ``x`` of its lane ``src_lane``."""
    return torch.take_along_dim(x, src_lane.expand_as(x), dim=-1)


def shfl_xor(x, mask: int):
    return x[..., LANE ^ mask]


def ballot(pred):
    """``__ballot_sync``: bit l of the result is lane l's ``pred``."""
    return (pred.long() << LANE).sum(-1, keepdim=True)


def popc(bits):
    """``__popc``, of every element of ``bits``."""
    return ((bits[..., None] >> LANE) & 1).sum(-1)


def ffs(bits):
    """``__ffs``: one plus the lowest set bit, 0 when none is set."""
    return torch.where(bits == 0, 0, popc((bits & -bits) - 1) + 1)


def butterfly_min(x):
    for o in (16, 8, 4, 2, 1):
        x = torch.minimum(x, shfl_xor(x, o))
    return x


def warp_place(t1, t2, valid, min_dur, q1, dl, src, do, *,
               overlap: str = "chain", cfg_pref: int = 1,
               cfg_fallback: int = 2):
    """The kernel's function over ``[B, Dev, CFG, T, W]`` windows, lane by
    lane. ``overlap`` sums a track's overlaps as the kernel does
    ("chain") or as a butterfly would ("butterfly"). Returns the nine
    outputs of ``fused_place_ref`` (new window tensors) and the rank of
    each lane's track in each list of the committed device, [B, CFG, 32]
    (-1 for rows that did not commit)."""
    B, n_dev, n_cfg, T, W = t1.shape
    assert T * W == LANES
    lt1 = t1.reshape(B, n_dev, n_cfg, LANES)
    lt2 = t2.reshape(B, n_dev, n_cfg, LANES)
    lv = valid.reshape(B, n_dev, n_cfg, LANES)
    track = LANE // W                                        # t of a lane
    w_of = LANE % W
    rows = torch.arange(B)

    # -- 1 + 2: query, butterfly min, selection (uniform across the lanes)
    per_cfg = []
    for ci in (cfg_pref, cfg_fallback):
        dur = min_dur[:, ci]
        kmin = torch.zeros(B)
        best_sel = torch.zeros(B)
        found_sel = torch.zeros(B, dtype=torch.bool)
        sel = torch.zeros(B, dtype=torch.int32)
        for d in range(n_dev):
            startw = torch.maximum(lt1[:, d, ci], q1[:, d, None])
            feas = lv[:, d, ci] & (startw + dur[:, None]
                                   <= torch.minimum(lt2[:, d, ci],
                                                    dl[:, d, None]))
            best_l = butterfly_min(torch.where(feas, startw, BIG))
            assert (best_l == best_l[:, :1]).all()           # warp-uniform
            best = best_l[:, 0]
            found = best < BIG
            key = torch.where(found, best, BIG) - torch.where(
                src == d, torch.tensor(SRC_PREF, dtype=torch.float32), 0.0)
            take = (key < kmin) if d else torch.ones(B, dtype=torch.bool)
            kmin = torch.where(take, key, kmin)
            sel = torch.where(take, d, sel)
            found_sel = torch.where(take, found, found_sel)
            best_sel = torch.where(take, best, best_sel)
        per_cfg.append((found_sel, sel, best_sel, dur))
    (ok2, sel2, best2, dur2), (ok4, sel4, best4, dur4) = per_cfg
    use4 = ~ok2 & ok4
    ok = (ok2 | ok4) & do
    sel = torch.where(use4, sel4, sel2)
    start = 0.0 + torch.where(use4, best4, best2)
    dur = torch.where(use4, dur4, dur2)
    cfg_commit = torch.where(use4, cfg_fallback, cfg_pref)

    # -- 3: commit on device sel, every list; rows with ok false unwritten
    out_t1, out_t2, out_v = lt1.clone(), lt2.clone(), lv.clone()
    n_drop = torch.zeros(B, 1, dtype=torch.long)
    ranks = torch.full((B, n_cfg, LANES), -1)
    s, e = start[:, None], (start + dur)[:, None]
    track_bits = ((1 << W) - 1) << (track * W)
    occ_table = torch.as_tensor(OCC_TABLE)
    for li in range(n_cfg):
        a1 = lt1[rows, sel.long(), li]
        a2 = lt2[rows, sel.long(), li]
        v = lv[rows, sel.long(), li]
        md = min_dur[:, li, None]
        occ = occ_table[cfg_commit, li][:, None]
        hit = v & (a1 < e) & (s < a2)
        part = torch.where(hit, torch.minimum(a2, e) - torch.maximum(a1, s),
                           0.0)
        if overlap == "chain":
            ol = torch.zeros_like(part)
            for j in range(W):
                ol = ol + shfl(part, track * W + j)
        elif overlap == "butterfly":
            ol = part
            for o in (8, 4, 2, 1):                    # within a track
                ol = ol + shfl_xor(ol, o)
        else:
            raise ValueError(overlap)
        rank = torch.zeros(B, LANES, dtype=torch.long)
        for u in range(T):
            olu = shfl(ol, torch.tensor([u * W]))
            rank += (olu > ol) | ((olu == ol) & (u < track))
        active = (rank < occ) & (ol > 0.0)
        ov = hit & active
        left_t2 = torch.minimum(a2, s)
        right_t1 = torch.maximum(a1, e)
        left_ok = ov & (left_t2 - a1 >= md)
        right_ok = ov & (a2 - right_t1 >= md)
        both = left_ok & right_ok
        nv = torch.where(ov, left_ok | right_ok, v)
        nt1 = torch.where(nv, torch.where(ov & ~left_ok & right_ok,
                                          right_t1, a1), BIG)
        nt2 = torch.where(nv, torch.where(ov & left_ok, left_t2, a2), BIG)
        free_bits = ballot(~nv) & track_bits
        both_bits = ballot(both) & track_bits
        first_free = torch.where(free_bits != 0,
                                 ffs(free_bits) - 1 - track * W, W)
        first_both = torch.where(both_bits != 0,
                                 ffs(both_bits) - 1 - track * W, W)
        placed = (first_both < W) & (first_free < W)
        src_lane = track * W + torch.where(first_both < W, first_both, 0)
        sp_t1 = 0.0 + shfl(right_t1, src_lane)
        sp_t2 = 0.0 + shfl(a2, src_lane)
        dropped = both & ~(placed & (w_of == first_both))
        n_drop += popc(ballot(dropped))
        place = placed & (w_of == first_free)
        okl = ok[:, None]
        out_t1[rows, sel.long(), li] = torch.where(
            okl, torch.where(place, sp_t1, nt1), a1)
        out_t2[rows, sel.long(), li] = torch.where(
            okl, torch.where(place, sp_t2, nt2), a2)
        out_v[rows, sel.long(), li] = torch.where(okl, nv | place, v)
        ranks[:, li] = torch.where(okl, rank, -1)
    n_drop = torch.where(ok, n_drop[:, 0], 0).to(torch.int32)
    shape = t1.shape
    return ((out_t1.reshape(shape), out_t2.reshape(shape),
             out_v.reshape(shape), ok, sel, start, dur, use4, n_drop),
            ranks)


def _t(case):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in case]


def _same(ref, got) -> bool:
    return all(np.array_equal(np.asarray(r), g.numpy())
               and np.asarray(r).dtype == g.numpy().dtype
               for r, g in zip(ref, got))


def _assert_same(ref, got):
    for name, r, g in zip(OUTPUTS, ref, got):
        r = np.asarray(r)
        assert r.dtype == g.numpy().dtype, name
        np.testing.assert_array_equal(r, g.numpy(), err_msg=name)


def test_model_primitives_are_the_warp_intrinsics():
    x = torch.arange(LANES, dtype=torch.float32)[None].flip(-1)
    assert (butterfly_min(x) == 0.0).all()
    assert (shfl(x, torch.tensor([5])) == x[0, 5]).all()
    pred = torch.zeros(1, LANES, dtype=torch.bool)
    assert ffs(ballot(pred)).item() == 0
    pred[0, [3, 17, 31]] = True
    bits = ballot(pred)
    assert bits.item() == (1 << 3) | (1 << 17) | (1 << 31)
    assert ffs(bits).item() == 4 and popc(bits).item() == 3
    assert ffs(bits & (0xFFFF << 16)).item() == 18


@pytest.mark.parametrize("b", [1, 5, 13, 37])
def test_warp_model_matches_plain_jax_and_pallas(b):
    case = cases.random_case(b, seed=b)
    got, _ = warp_place(*_t(case))
    _assert_same(fused_place_ref(*_t(case)), got)
    _assert_same(fused_place_j(*case), got)
    _assert_same(fused_place_pallas(*case, interpret=True), got)


def test_warp_model_matches_at_six_devices():
    """6 devices a replica: the kernel's instantiation that reads the
    device count at run time."""
    case = cases.random_case(13, seed=6, dev=6)
    got, _ = warp_place(*_t(case))
    _assert_same(fused_place_ref(*_t(case)), got)
    _assert_same(fused_place_j(*case), got)


def test_warp_model_matches_on_adversarial_rows():
    case = cases.adversarial_case()
    got, _ = warp_place(*_t(case))
    _assert_same(fused_place_ref(*_t(case)), got)
    _assert_same(fused_place_j(*case), got)
    _assert_same(fused_place_pallas(*case, interpret=True), got)


def test_butterfly_overlap_sum_flips_a_ranking_the_chain_keeps():
    """Over seeded random rows and the hand-built ones, the sequential
    chain never differs from the plain version; a butterfly sum of the
    overlaps ranks the tracks otherwise, and trims other windows, on at
    least one row (the ``overlap_sum_order`` row, if no random one)."""
    rand = cases.random_case(512, seed=11, do_rate=1.0)
    adv = cases.adversarial_case()
    case = tuple(np.concatenate([r, a]) for r, a in zip(rand, adv))
    ref = fused_place_ref(*_t(case))
    chain, rank_chain = warp_place(*_t(case), overlap="chain")
    tree, rank_tree = warp_place(*_t(case), overlap="butterfly")
    _assert_same(ref, chain)
    flipped = (rank_chain != rank_tree).flatten(1).any(1)
    win_differs = ~(torch.eq(ref[0], tree[0]) & torch.eq(ref[1], tree[1])
                    & torch.eq(ref[2], tree[2])).flatten(1).all(1)
    assert (flipped & win_differs).any()
    row = len(rand[0]) + cases.ADVERSARIAL_ROWS.index("overlap_sum_order")
    assert flipped[row] and win_differs[row]
    assert not _same(ref, tree)
