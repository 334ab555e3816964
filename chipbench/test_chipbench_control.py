"""The check that decides ``correct``, shown to fail: a sound run on the
port's plain path comes out correct; the control (the reference in the
program's place, in bfloat16, the precision below the configuration's
float32) and each fault planted under the timed path come out not
correct. The harness's look for a card is skipped; the rest of a run is
driven as the benchmark drives it, at a tiny size on the CPU.

The cell runs on one chip, so the fault "the exchange between chips
left out" has no path to break here."""

import time

import pytest
import torch

from chipbench import harness


def _run(root, cell, program=None, seed=2**31 + 11):
    return harness.run_cell(root, cell, seed=seed, seconds=0.01,
                            trace=False, device="cpu",
                            t_start=time.perf_counter(), program=program)


def _checks(line):
    return {k: v["value"] for k, v in line["checks"].items()}


def test_a_sound_run_is_correct(tiny):
    line = _run(*tiny)
    assert line["correct"] is True
    assert set(_checks(line).values()) == {0}


def test_the_control_is_not_correct(tiny):
    line = _run(*tiny, program="control")
    assert line["correct"] is False
    checks = _checks(line)
    assert checks["counter_mismatches"] > 0 or checks["state_mismatches"] > 0


def _unchanged_step(monkeypatch):
    from repro_torch.fleet import engine

    monkeypatch.setattr(engine, "_frame_step",
                        lambda carry, *a, **k: (carry, None))


def _half_batch(monkeypatch):
    """The first half of the batch advanced, its results standing for
    the other half, so the reduction's means are those of the rest."""
    from repro_torch.fleet import engine
    from repro_torch.fleet.state import FleetState

    real = engine.fleet_run

    def half(fleet, values, bw, *, params):
        B = fleet.link_free.shape[0]
        h = B // 2
        sub = FleetState(fleet.sched._replace(**{
            f: getattr(fleet.sched, f)[:h] for f in (
                "win_t1", "win_t2", "win_valid", "min_dur")}),
            *(x[:h] for x in fleet[1:]))
        st, stats = real(sub, values[:, :h], bw[:, :h], params=params)
        twice = lambda x: torch.cat([x, x])
        st = FleetState(st.sched._replace(**{
            f: twice(getattr(st.sched, f)) for f in (
                "win_t1", "win_t2", "win_valid", "min_dur")}),
            *(twice(x) for x in st[1:]))
        return st, type(stats)(*(twice(x) for x in stats))

    monkeypatch.setattr(engine, "fleet_run", half)


def _altered_placement(monkeypatch):
    """Every committed LP start one f32 step late, where it is made."""
    from repro_torch.fleet import engine

    real = engine.fused_place_op

    def late(*a, **k):
        out = list(real(*a, **k))
        out[5] = torch.nextafter(out[5], torch.full_like(out[5], 1e30))
        return tuple(out)

    monkeypatch.setattr(engine, "fused_place_op", late)


def _altered_summary(monkeypatch):
    """One rate of every group summary altered in the reduction."""
    from repro_torch.fleet import metrics

    real = metrics.summarize

    def altered(*a, **k):
        out = real(*a, **k)
        out["hp_completion_rate"] = dict(out["hp_completion_rate"],
                                         mean=out["hp_completion_rate"]
                                         ["mean"] + 1e-4)
        return out

    monkeypatch.setattr(metrics, "summarize", altered)


@pytest.mark.parametrize("plant", [_unchanged_step, _half_batch,
                                   _altered_placement, _altered_summary],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(tiny, monkeypatch, plant):
    plant(monkeypatch)
    line = _run(*tiny)
    assert line["correct"] is False
    assert any(v > 0 for v in _checks(line).values())
