"""The frozen kernel counts and the per-layer readers, on the CPU: the
counts give the bounds the port's chip smoke test records at its
shapes, so a roofline share above 100% can be traced to the count or to
the program; a reader with nothing to read reads nothing."""

import importlib.util
from pathlib import Path

import pytest
import torch

from chipbench import peaks
from chipbench.counts import fused_place, window_query
from chipbench.reference import fleet as ref
from chipbench.reference import scenarios

METRICS = Path(__file__).resolve().parent / "metrics"


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fused_place_bound_at_the_smoke_tests_case():
    """8.06 us at B 8192 (``chip_smoke.py``'s ``fleet-8192`` case, 27 MB),
    its commits counted by the port's plain version."""
    from repro_torch.kernels.placement import cases
    from repro_torch.kernels.placement.ref import fused_place_ref

    case = cases.with_adversarial_rows(cases.random_case(8192, seed=0))
    ok = fused_place_ref(*(torch.from_numpy(x.copy()) for x in case))[3]
    # the kernel's general input: every list holds T tracks of W windows
    B, dev, cfg, T, W = case[0].shape
    shape = (B, dev, (T,) * cfg, W, int(ok.sum()))
    nbytes = fused_place.launch_bytes(*shape)
    bound = peaks.bound_s(fused_place.launch_ops(*shape),
                          peaks.FP32_FLOP_PER_S, nbytes)
    assert round(nbytes / 1e6) == 27
    assert round(bound * 1e6, 2) == 8.06


def test_fused_place_counts_each_fleet_list_at_its_own_tracks():
    """The fleet's LP4 list holds one track, its HP and LP2 lists two:
    a replica's query reads 4 devices x 3 tracks x 16 windows, and a
    commit reads the 2 HP tracks and writes all 5."""
    tracks = [int(t) for t in ref.CFG_TRACKS]
    assert tracks == [2, 2, 1]
    per_replica = 4 * 3 * 16 * 9 + (3 * 4 + 2 * 4 * 4 + 4 + 1) + 18
    assert fused_place.launch_bytes(10, 4, tracks, 16, 0) == (
        10 * per_replica)
    assert fused_place.launch_bytes(10, 4, tracks, 16, 3) == (
        10 * per_replica + 3 * (2 + 5) * 16 * 9)
    assert fused_place.launch_ops(10, 4, tracks, 16, 3) == (
        10 * 4 * 3 * 16 * 5 + 3 * 5 * 16 * 14)


def test_commits_are_lp_completed_plus_hp_preempted(monkeypatch):
    """The count of ``fused_place`` commits that the roofline reads: on
    the frozen fleet, the ok rows of every call add up to the counters'
    lp_completed + hp_preempted, replica by replica."""
    values, bw = scenarios.paper_workload("weighted4", 64, 20, seed=3,
                                          congestion=0.75)
    commits = torch.zeros(64, dtype=torch.int64)
    plain = ref.fused_place

    def counted(*args):
        out = plain(*args)
        commits.add_(out[3].long())
        return out

    monkeypatch.setattr(ref, "fused_place", counted)
    _, stats = ref.run(values, bw, ref.Params(), device="cpu")
    assert int(stats["hp_preempted"].sum()) > 0
    assert torch.equal(commits, (stats["lp_completed"].long()
                                 + stats["hp_preempted"].long()))


def test_window_query_bound_at_the_fleets_hp_view():
    """0.75 us for the fleet's HP view at B 8192 (8192 rows of 2 x 16)."""
    bound = peaks.bound_s(window_query.launch_ops(8192, 32),
                          peaks.FP32_FLOP_PER_S,
                          window_query.launch_bytes(8192, 32))
    assert round(bound * 1e6, 2) == 0.75


def _context(fused_s=190e-6, n=21, wq_s=20e-6):
    trace = {"wall_s": 2.0, "busy_s": 1.5, "device_ops": 3000,
             "launches": 2900, "by_name": {
                 "fused_place_kernel<2, 16, 4>": {"count": n,
                                                  "seconds": n * fused_s},
                 "window_query_kernel<4>": {"count": 4, "seconds": 4 * wq_s},
                 "Memcpy DtoD": {"count": 100, "seconds": 0.01}}}
    return {"trace": trace, "ticks": 1,
            "fleet": {"replicas": 131072, "devices": 4,
                      "list_tracks": [2, 2, 1], "windows": 16,
                      "committed_per_fused_launch": 40000.0}}


def test_readers_at_a_known_slice():
    ctx = _context()
    b = fused_place.launch_bytes(131072, 4, [2, 2, 1], 16, 40000.0)
    assert _reader("fused_place_roofline").read(ctx) == pytest.approx(
        100 * b / peaks.HBM_BYTES_PER_S / 190e-6)
    b = window_query.launch_bytes(131072, 32)
    assert _reader("window_query_roofline").read(ctx) == pytest.approx(
        100 * b / peaks.HBM_BYTES_PER_S / 20e-6)
    assert _reader("tick_device_ms").read(ctx) == pytest.approx(1500.0)
    assert _reader("tick_launches").read(ctx) == 2900
    assert _reader("device_idle_share.fleet").read(ctx) == pytest.approx(25)


@pytest.mark.parametrize("name", sorted(p.stem for p in METRICS.glob("*.py")))
def test_a_reader_with_nothing_to_read_reads_nothing(name):
    reader = _reader(name)
    assert reader.read(None) is None
    assert reader.read({}) is None
    empty = _context()
    empty["trace"].update(by_name={}, device_ops=0, launches=0)
    assert reader.read(empty) is None
