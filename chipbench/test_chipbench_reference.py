"""The frozen references and the frozen generator against the port's
own, on the CPU: the benchmark's yardstick starts equal to the program
it will hold, bit for bit."""

import numpy as np
import pytest
import torch

from chipbench.reference import fleet as ref
from chipbench.reference import scenarios

PAPER_TRACES = ("uniform", "weighted1", "weighted2", "weighted3",
                "weighted4")


@pytest.mark.parametrize("congestion", [0.0, 0.6, 0.75])
@pytest.mark.parametrize("trace", PAPER_TRACES)
def test_generator_draws_what_the_port_draws(trace, congestion):
    from repro_torch.fleet import make_workload

    for seed in (0, 2**31 + 17):
        want = make_workload(trace, 33, 7, 4, seed=seed,
                             congestion=congestion)
        values, bw = scenarios.paper_workload(trace, 33, 7, 4, seed=seed,
                                              congestion=congestion)
        assert values.dtype == want.values.dtype == np.int8
        np.testing.assert_array_equal(values, want.values)
        np.testing.assert_array_equal(bw, want.bw_scale)


def test_pristine_state_is_make_fleets():
    from repro_torch.fleet import make_fleet

    fleet = make_fleet(3, device="cpu")
    st = ref.pristine(3, ref.Params(), "cpu")
    for f in ref.STATE_FIELDS:
        want = getattr(fleet.sched if f.startswith("win") else fleet, f)
        assert torch.equal(st[f], want), f
    assert torch.equal(st["min_dur"], fleet.sched.min_dur)


@pytest.mark.parametrize("trace", PAPER_TRACES)
def test_frozen_fleet_is_the_ports_plain_path(trace):
    """B 64 x 20 ticks at congestion 0.6: every counter and every leaf
    of the final state bit for bit, and the summary of the counters."""
    from repro_torch.fleet import FleetParams, fleet_run, make_fleet
    from repro_torch.fleet.metrics import summarize

    values, bw = scenarios.paper_workload(trace, 64, 20, seed=5,
                                          congestion=0.6)
    state, stats = fleet_run(make_fleet(64, device="cpu"), values, bw,
                             params=FleetParams())
    r_state, r_stats = ref.run(values, bw, ref.Params(), device="cpu")
    for f in ref.STATS_FIELDS:
        assert torch.equal(getattr(stats, f), r_stats[f]), f
    for f in ref.STATE_FIELDS:
        got = getattr(state.sched if f.startswith("win") else state, f)
        assert torch.equal(got, r_state[f]), f
    pending = state.rq_valid.sum(1)
    assert ref.summarize({f: v.numpy() for f, v in r_stats.items()}, 20,
                         pending.numpy()) == summarize(
        stats, 20, rq_pending=pending)
    # the run exercised preemption, the re-queue and the 4-core fallback
    assert int(stats.hp_preempted.sum()) > 0
    assert int(stats.lp_requeued.sum()) > 0
    assert int(stats.lp_four_core.sum()) > 0
