"""The join of the program's spans with the traced slice, on hand-made
records and events: the launch-queue wait is left out of a tick's issue
time, an idle gap goes to the innermost span around it, the joins read
the spans and counters and give nothing without them, and the traced
driver hands them over."""

import pytest
from torch.autograd import DeviceType

from chipbench import harness, spans
from chipbench.test_chipbench_trace import _Event

US = 1_000
MS = 1_000_000


def _rec(name, start, end, parent=None, tick=None, device_ms=None):
    return {"name": name, "start_ns": start, "end_ns": end,
            "parent": parent, "trace": None if tick is None else [0, tick],
            "device": "cuda:0", "device_ms": device_ms}


def _ctx():
    """Two ticks (40 and 41) of a slice starting at tick 40, in a segment;
    tick 40 holds an HP span and a compaction, tick 41 an LP span."""
    recs = [
        _rec("fleet/segment", 0, 100 * MS),
        _rec("fleet/tick", 1 * MS, 11 * MS, 0, 40, 9.0),
        _rec("fleet/compaction", 2 * MS, 4 * MS, 1, None, 3.0),
        _rec("fleet/hp", 5 * MS, 9 * MS, 1, None, 4.0),
        _rec("fleet/tick", 20 * MS, 30 * MS, 0, 41, 7.0),
        _rec("fleet/lp", 21 * MS, 29 * MS, 4, None, 6.0),
    ]
    for r in recs[2:4]:
        r["trace"] = [0, 40]
    recs[5]["trace"] = [0, 41]
    calls = [[a * US, a * US + 5 * US] for a in range(1000, 11000, 100)]
    # one launch that waited 2 ms for room in the queue, inside tick 41
    calls.append([25 * MS, 27 * MS])
    calls.sort()
    merged = [[0, 4200 * US], [4800 * US, 22 * MS], [24 * MS, 50 * MS],
              [60 * MS, 61 * MS]]
    return {"spans": recs,
            "counters": {"fleet/fused_place": [[8, 2], [4, 4], [0, 0]]},
            "slice": {"first_tick": 40, "ticks": 2, "batch_ticks": 4},
            "fleet": {"replicas": 2},
            "trace": {"runtime_calls": calls, "device_intervals": merged,
                      "by_name": {}}}


def test_the_launch_queue_wait_is_left_out():
    ctx = _ctx()
    ticks = [r for r in ctx["spans"] if r["name"] == "fleet/tick"]
    got = spans.issue_ms(ticks, ctx["trace"]["runtime_calls"])
    # every call but the one that waited takes the median 5 us
    assert got == pytest.approx([10.0, 10.0 - (2.0 - 0.005)])
    assert spans.host_issue_ms_per_tick(ctx) == pytest.approx(
        (20.0 - 1.995) / 2)


def test_a_gap_goes_to_the_innermost_span():
    idle = spans.idle_by_span(_ctx())
    # 4.2-4.8 ms: inside tick 40, between its compaction and its HP span;
    # 22-24: inside tick 41's LP span; 50-60: in the segment alone
    assert idle == pytest.approx({"fleet/tick": 0.6e-3, "fleet/lp": 2e-3,
                                  "fleet/segment": 10e-3})
    ctx = _ctx()
    ctx["trace"]["device_intervals"] = [[0, 200 * MS], [300 * MS, 301 * MS]]
    assert spans.idle_by_span(ctx) == {spans.OUTSIDE: 0.1}


def test_phase_table_self_times():
    rows = {r[0]: r[1:] for r in spans.phase_table(_ctx())}
    count, dev, self_dev, host, self_host, idle = rows["fleet/tick"]
    assert count == 2
    assert dev == pytest.approx((9.0 + 7.0) / 2)
    assert self_dev == pytest.approx((9.0 - 3.0 - 4.0 + 7.0 - 6.0) / 2)
    assert host == pytest.approx(10.0)
    assert self_host == pytest.approx((10 - 2 - 4 + 10 - 8) / 2)
    assert idle == pytest.approx(0.6)
    assert rows["fleet/compaction"][:2] == (1, pytest.approx(1.5))
    assert "fleet/segment" not in rows


def test_the_joins_read_the_spans_and_counters():
    ctx = _ctx()
    assert spans.device_ms(ctx, "fleet/compaction") == (3.0, 1)
    assert spans.device_ms_per_tick(ctx, "fleet/hp") == 2.0
    assert spans.device_ms_per_tick(ctx, "fleet/lp") == 3.0
    assert spans.device_ms_per_tick(ctx, "fleet/requeue") is None
    share, per_slot = spans.active_shares(ctx)
    # 12 rows attempted of 2 replicas x 4 ticks x 3 slots
    assert share == pytest.approx(12 / 24)
    assert per_slot == pytest.approx([1.0, 0.5, 0.0])
    assert spans.committed(ctx) == 6


@pytest.mark.parametrize("join", [
    lambda c: spans.device_ms_per_tick(c, "fleet/hp"),
    spans.host_issue_ms_per_tick, spans.idle_by_span, spans.active_shares,
    spans.committed, spans.phase_table])
def test_the_joins_read_nothing_without_spans(join):
    """A program that keeps no spans or counters (the parent's)."""
    ctx = _ctx()
    ctx["spans"] = ctx["counters"] = None
    assert join(ctx) in (None, [])
    assert join(None) in (None, [])


def test_a_span_without_device_time_reads_nothing():
    ctx = _ctx()
    ctx["spans"][3]["device_ms"] = None
    assert spans.device_ms_per_tick(ctx, "fleet/hp") is None


def test_intervals_keep_runtime_calls_and_merged_device_time():
    gpu, cpu = DeviceType.CUDA, DeviceType.CPU
    got = spans.intervals([
        _Event(0, 100, "void k1<2>(int*)", gpu),
        _Event(50, 150, "void k1<2>(int*)", gpu),
        _Event(300, 400, "Memcpy DtoD (Device -> Device)", gpu),
        _Event(145, 330, "aten::add", cpu),
        _Event(340, 345, "cuLaunchKernel", cpu),
        _Event(160, 170, "cudaLaunchKernel", cpu),
        _Event(171, 171, "cudaEventRecord", cpu),
        _Event(100, 700, "fleet/tick", cpu),
    ])
    assert got == {"runtime_calls": [[160, 170], [340, 345]],
                   "device_intervals": [[0, 150], [300, 400]]}


def test_the_traced_driver_hands_over_spans_and_counters(tiny,
                                                        monkeypatch):
    """The tiny cell through ``fleet_sweep_spans``, traced on the CPU
    (the profiler's host events alone): the context gains the traced
    batch's spans, counters and slice, the host's joins read, and the
    counters' commits are the stats'; untraced, it is ``fleet_sweep``'s
    run."""
    import time

    import torch

    from chipbench.drivers import fleet_sweep_spans

    root, cell = tiny
    spec = harness.cell_spec(root, cell)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    kw = dict(seed=2**31 + 11, seconds=0.01, device="cpu",
              t_start=time.perf_counter())
    out = fleet_sweep_spans.run(spec["config"], spec["traffic"],
                                trace=True, **kw)
    ctx = out.context
    assert all(v <= limit for v, limit in out.checks.values())
    frames = spec["config"]["frames_per_replica"]
    assert ctx["slice"] == {"first_tick": 4, "ticks": 4,
                            "batch_ticks": frames}
    ticks = [r for r in ctx["spans"] if r["name"] == spans.TICK]
    assert sorted(r["trace"][1] for r in ticks) == list(range(frames))
    assert spans.host_issue_ms_per_tick(ctx) > 0
    assert 0 < spans.active_shares(ctx)[0] <= 1
    assert spans.device_ms_per_tick(ctx, "fleet/lp") is None  # no card
    assert ctx["trace"]["runtime_calls"] == []
    assert len(ctx["counters"][spans.COUNTER]) == 21
    plain = fleet_sweep_spans.run(spec["config"], spec["traffic"],
                                  trace=False, **kw)
    assert plain.context is None
    assert set(plain.e2e) == {"replica_frames_per_s", "setup_s"}
