"""The port's sanitizers (``REPRO_SANITIZE=1``, ``analysis/sanitize.py``),
after the JAX package's ``tests/test_sanitize.py``:

- the sanitized placements and fleet run are bit-identical to the
  unsanitized ones (the checks only read the state);
- corrupted scheduler state trips a readable ``SanitizeError`` naming the
  violated invariant ("window order ...") instead of silently running;
- the B=1 fleet-vs-serial calibration still passes the committed baseline
  with every invariant armed.

The switch is read per call, so ``monkeypatch.setenv`` flips it inside one
process. Everything runs on the CPU, where the fleet takes the plain
placement path; the card's kernel path under the flag is checked by
``chip_smoke.py``.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitize
from repro_torch.analysis.sanitize import SanitizeError
from repro_torch.calib import CalibConfig, check_report, load_baseline
from repro_torch.calib import run_calibration
from repro_torch.calib.harness import PAPER_TRACES
from repro_torch.core.scheduler import RASScheduler
from repro_torch.core.tensor_state import (
    export_state, fanout_commit, hp_place, lp_place,
)
from repro_torch.fleet import (
    FleetParams, SweepConfig, fleet_run, make_fleet, make_workload, run_sweep,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO_ROOT, "results", "calib", "baseline.json")

B, F, DEV = 4, 6, 4
PARAMS = FleetParams(n_devices=DEV, segment_frames=3)


def _sched_state(seed=0):
    return export_state(RASScheduler(4, 20e6, seed=seed), device="cpu")


def _corrupt(st):
    """Give one valid window t1 > t2 — the signature of a racy write."""
    first = (0,) * st.win_t1.ndim
    t1, t2, valid = st.win_t1.clone(), st.win_t2.clone(), st.win_valid.clone()
    t1[first], t2[first], valid[first] = 9.0, 1.0, True
    return st._replace(win_t1=t1, win_t2=t2, win_valid=valid)


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _leaves(out):
    *head, state = out
    return [*head, *state]


def _fleet_leaves(out):
    state, stats = out
    return [*state.sched, *state[1:], *stats]


def test_enabled_reads_env(monkeypatch):
    monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
    assert not sanitize.enabled()
    monkeypatch.setenv(sanitize.ENV_VAR, "0")
    assert not sanitize.enabled()
    monkeypatch.setenv(sanitize.ENV_VAR, "")
    assert not sanitize.enabled()
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    assert sanitize.enabled()


def test_sanitize_error_is_a_runtime_error():
    assert issubclass(SanitizeError, RuntimeError)
    with pytest.raises(SanitizeError, match="broken: 3"):
        sanitize.check(torch.tensor(False), "broken: {n}", n=torch.tensor(3))
    sanitize.check(torch.tensor(True), "not formatted: {n}",
                   n=lambda: pytest.fail("payload read without a trip"))


# ---------------------------------------------------------------------------
# sanitized == unsanitized (bit-exact)
# ---------------------------------------------------------------------------

def _both(monkeypatch, fn):
    monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
    off = fn()
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    return off, fn()


@pytest.mark.parametrize("dev", range(4))
def test_hp_place_equivalent_under_sanitize(monkeypatch, dev):
    st = _sched_state()
    off, on = _both(monkeypatch, lambda: hp_place(st, dev, 1.0))
    assert bool(off[0])
    _assert_same(_leaves(off), _leaves(on))


@pytest.mark.parametrize("cfg_idx", [1, 2])
def test_lp_place_equivalent_under_sanitize(monkeypatch, cfg_idx):
    st = _sched_state(seed=2)
    off, on = _both(monkeypatch, lambda: lp_place(
        st, 0, 2.0, 60.0, cfg_idx=cfg_idx, n_tasks=3))
    assert bool(off[1].any())
    _assert_same(_leaves(off), _leaves(on))


@pytest.mark.parametrize("R", [4, 0])
def test_fleet_run_equivalent_under_sanitize(monkeypatch, R):
    wl = make_workload("uniform", B, F, DEV, seed=0)
    p = FleetParams(n_devices=DEV, segment_frames=3, requeue_slots=R)
    off, on = _both(monkeypatch, lambda: fleet_run(
        make_fleet(B, DEV, requeue_slots=R, device="cpu"), wl.values,
        wl.bw_scale, params=p))
    assert int(off[1].frames.sum()) > 0
    _assert_same(_fleet_leaves(off), _fleet_leaves(on))


def test_run_sweep_equivalent_under_sanitize(monkeypatch):
    cfg = SweepConfig(scenarios=("weighted2",), congestion_levels=(0.3,),
                      n_seeds=3, n_frames=5, batch_size=3)
    off, on = _both(monkeypatch, lambda: run_sweep(cfg, device="cpu"))
    assert off == on


def test_checks_leave_the_state_as_it_was(monkeypatch):
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    st = _sched_state()
    before = [x.clone() for x in st]
    sanitize.check_sched_state(st, "test")
    hp_place(st, 0, 1.0)
    lp_place(st, 0, 2.0, 60.0, n_tasks=2)
    _assert_same(st, before)


# ---------------------------------------------------------------------------
# corrupted state trips readably
# ---------------------------------------------------------------------------

def test_corrupted_window_order_trips_hp(monkeypatch):
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    bad = _corrupt(_sched_state())
    with pytest.raises(SanitizeError,
                       match=r"window order violated \(hp_place input\)"):
        hp_place(bad, 0, 1.0)


def test_corrupted_window_order_trips_lp(monkeypatch):
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    bad = _corrupt(_sched_state())
    with pytest.raises(SanitizeError,
                       match=r"window order violated \(lp_place input\)"):
        lp_place(bad, 0, 2.0, 60.0)


def test_corrupted_window_order_trips_fleet(monkeypatch):
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    fleet = make_fleet(B, DEV, device="cpu")
    fleet = fleet._replace(sched=_corrupt(fleet.sched))
    wl = make_workload("uniform", B, F, DEV, seed=0)
    with pytest.raises(SanitizeError, match="window order") as err:
        fleet_run(fleet, wl.values, wl.bw_scale, params=PARAMS)
    # the payload is the most negative t2 - t1, formatted into the text
    assert "fleet segment input" in str(err.value)
    assert str(err.value).endswith("min t2-t1 = -8.0")


def test_corrupted_window_is_not_checked_with_the_flag_off(monkeypatch):
    monkeypatch.delenv(sanitize.ENV_VAR, raising=False)
    hp_place(_corrupt(_sched_state()), 0, 1.0)


def test_clean_state_does_not_trip(monkeypatch):
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    found, start, _ = hp_place(_sched_state(), 0, 1.0)
    assert bool(found)


def test_fanout_commit_trips_on_a_corrupt_commit():
    st = _sched_state()
    args = [x[None] for x in (st.win_t1, st.win_t2, st.win_valid,
                              st.min_dur)]
    one = lambda v, dt: torch.tensor([v], dtype=dt)
    rest = (one(0, torch.int32), one(0, torch.int32),
            one(1.0, torch.float32), one(2.0, torch.float32),
            one(True, torch.bool))
    fanout_commit(*args, *rest, sanitize=True)   # a clean commit
    bad = _corrupt(st)
    args = [x[None] for x in (bad.win_t1, bad.win_t2, bad.win_valid,
                              bad.min_dur)]
    with pytest.raises(SanitizeError,
                       match=r"window order violated \(fanout_commit\)"):
        fanout_commit(*args, *rest, sanitize=True)


def test_sched_state_invariants_name_what_broke():
    st = _sched_state()
    with pytest.raises(SanitizeError, match="non-positive min_dur"):
        sanitize.check_sched_state(
            st._replace(min_dur=st.min_dur * 0.0), "test")
    used = st.link_used.clone()
    used[0] = st.link_cap[0] + 1
    with pytest.raises(SanitizeError, match="link capacity violated"):
        sanitize.check_sched_state(st._replace(link_used=used), "test")


def test_availability_checks():
    before = torch.tensor([10.0, 1e30])
    sanitize.check_no_avail_increase(before, before * (1 + 5e-6), "test")
    sanitize.check_avail_conserved(before, before, "test")
    with pytest.raises(SanitizeError, match=r"availability increased"):
        sanitize.check_no_avail_increase(
            before, torch.tensor([10.5, 1e30]), "test")
    with pytest.raises(SanitizeError, match=r"not conserved .*= 0.5"):
        sanitize.check_avail_conserved(
            before, torch.tensor([9.5, 1e30]), "test")


def test_total_availability_counts_valid_windows():
    t1 = torch.tensor([[0.0, 5.0], [1.0, 2.0]])
    t2 = torch.tensor([[3.0, 9.0], [4.0, 2.5]])
    valid = torch.tensor([[True, False], [True, True]])
    np.testing.assert_array_equal(
        sanitize.total_availability(t1, t2, valid, batch_axes=1).numpy(),
        [3.0, 3.5])
    assert float(sanitize.total_availability(t1, t2, valid)) == 6.5


@pytest.mark.parametrize("field,value,match", [
    ("vc_start", 50.0, "victim cache corrupt"),
    ("link_free", -1.0, "negative link_free"),
])
def test_fleet_tick_invariants(monkeypatch, field, value, match):
    """A fleet whose victim cache or link carries a corrupt entry that no
    tick overwrites trips the per-tick check."""
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    fleet = make_fleet(B, DEV, device="cpu")
    if field == "vc_start":
        fleet = fleet._replace(
            vc_start=torch.full_like(fleet.vc_start, value),
            vc_end=torch.full_like(fleet.vc_end, 1.0),
            vc_valid=torch.ones_like(fleet.vc_valid))
    else:
        fleet = fleet._replace(link_free=torch.full_like(fleet.link_free,
                                                         value))
    no_frames = np.full((1, B, DEV), -1, np.int8)
    with pytest.raises(SanitizeError, match=match):
        fleet_run(fleet, no_frames, np.ones((1, B), np.float32),
                  params=PARAMS)


# ---------------------------------------------------------------------------
# B=1 fleet-vs-serial equivalence with every invariant armed
# ---------------------------------------------------------------------------

def test_b1_calibration_holds_under_sanitize(monkeypatch):
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    cfg = CalibConfig(scenarios=(PAPER_TRACES[0],),
                      congestion_levels=(0.0,), n_seeds=1, n_frames=40)
    report = run_calibration(cfg, device="cpu")
    ok, failures = check_report(report, load_baseline(BASELINE))
    assert ok, failures
