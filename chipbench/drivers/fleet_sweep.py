"""Closed-loop Monte-Carlo sweep through the port's batched fleet engine.

Set-up draws ``distinct_batches`` input batches from ``--seed`` with the
frozen paper-trace generator (``reference/scenarios.py``), each the
traffic's groups (trace × congestion) side by side, puts them on the
card and warms the window's path up with a short run at the full batch.
The window then runs whole batches back to back, each as the port's
``run_sweep`` runs one: a fresh ``make_fleet``, ``fleet_run`` over every
frame, and the per-group reduction ``summarize`` on the host. The
reduction of a batch runs on a thread of its own, once the batch's
counters have reached the host, while the next batch is issued, so the
card does not wait for the host between batches. Once ``--seconds``
have passed no batch is issued; the window closes when every batch
issued has run and been reduced, and counts them all.

The check, once the window has closed: the counters and the final state
(windows, link, re-queue buffer, victim cache) of rows sampled from the
seed in every group of every batch run, against the plain reference
(``reference/fleet.py``) run on the same inputs; every group summary
against the reference's reduction of the program's own counters; and
the LP-task conservation identity over every replica.

With ``--trace 1`` the profiler records one segment of one batch
(``trace_batch``, ``trace_segment``), bounded by synchronizes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.fleet import engine, metrics
from repro_torch.fleet import state as fleet_state
from repro_torch.obs.profile import PhaseTimer

from chipbench.reference import fleet as ref
from chipbench.reference import scenarios
from chipbench.trace import TraceSlice, kernel_time

#: the configuration's keys that the frozen reference fixes
_REFERENCE_CONSTANTS = {
    "frame_period_s": ref.FRAME_PERIOD,
    "device_cores": ref.DEVICE_CORES,
    "lp_pad_fraction": ref.LP_PAD_FRACTION,
    "transfer_bytes": ref.MAX_IMAGE_BYTES,
}


@dataclasses.dataclass
class Outcome:
    """What a run measured and checked; the harness prints it."""

    e2e: dict
    checks: dict            # name -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    context: dict | None = None   # what the per-layer readers read
    trace: dict | None = None


def _ref_params(config: dict) -> ref.Params:
    for key, want in _REFERENCE_CONSTANTS.items():
        if config[key] != want:
            raise ValueError(f"{key} = {config[key]} in the configuration, "
                             f"the reference fixes {want}")
    tasks = [(c["cores"], c["seconds"]) for c in (
        config["tasks"][k] for k in ("hp", "lp2", "lp4"))]
    if tuple(tasks) != ref.CONFIGS:
        raise ValueError(f"tasks {tasks} != the reference's {ref.CONFIGS}")
    return ref.Params(
        n_devices=config["devices"], nominal_bw_bps=config["nominal_bw_bps"],
        transfer_bytes=config["transfer_bytes"],
        hp_deadline=config["hp_deadline_s"],
        lp_deadline_factor=config["lp_deadline_factor"],
        requeue_slots=config["requeue_slots"],
        compact_every=config["compact_every"],
        max_windows=config["max_windows"])


def _inputs(traffic, config, seed):
    """``distinct_batches`` host batches of ``(values, bw_scale)``; the
    groups' draws run on a few threads (numpy releases the GIL)."""
    groups = traffic["groups"]
    per = traffic["replicas"] // len(groups)
    F, D = config["frames_per_replica"], config["devices"]

    def draw(kg):
        k, g = kg
        grp = groups[g]
        return scenarios.paper_workload(
            grp["trace"], per, F, D, seed=(seed << 16) + (k << 8) + g,
            congestion=grp["congestion"])

    jobs = [(k, g) for k in range(traffic["distinct_batches"])
            for g in range(len(groups))]
    with ThreadPoolExecutor(max_workers=4) as pool:
        parts = list(pool.map(draw, jobs))
    out = []
    for k in range(traffic["distinct_batches"]):
        mine = parts[k * len(groups):(k + 1) * len(groups)]
        out.append((np.concatenate([v for v, _ in mine], axis=1),
                    np.concatenate([b for _, b in mine], axis=1)))
    return out


class _SegmentTimer(PhaseTimer):
    """Counts the engine's ``fleet/segment`` spans; with ``slice_at``
    set, profiles segment ``slice_at`` of the batch: from the end of the
    one before it to its own end."""

    def __init__(self, slice_at=None):
        super().__init__()
        self.segments = 0
        self.slice_at = slice_at
        self.slice = TraceSlice() if slice_at is not None else None

    def add(self, name, seconds):
        super().add(name, seconds)
        if name != "fleet/segment":
            return
        if self.slice is not None:
            if self.segments == self.slice_at - 1:
                self.slice.start()
            elif self.segments == self.slice_at:
                self.slice.stop()
        self.segments += 1


class _HostCopies:
    """Copies of a batch's outputs to the host. On the card they are
    queued behind the batch into pinned memory, and ``wait()`` waits for
    them alone, so the thread that issues batches never waits."""

    def __init__(self, parts: dict, cuda: bool):
        self.host = {name: {k: v.to("cpu", non_blocking=cuda)
                            for k, v in d.items()}
                     for name, d in parts.items()}
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return self.host


def run(config: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device, t_start: float, program=None) -> Outcome:
    """One run of the cell. ``program`` None runs the port;
    ``"control"`` puts the reference in its place, in bfloat16."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    p_ref = _ref_params(config)
    params = engine.FleetParams(
        n_devices=config["devices"], nominal_bw_bps=config["nominal_bw_bps"],
        transfer_bytes=config["transfer_bytes"],
        hp_deadline=config["hp_deadline_s"],
        lp_deadline_factor=config["lp_deadline_factor"],
        placement_backend=config["placement_backend"],
        requeue_slots=config["requeue_slots"],
        compact_every=config["compact_every"],
        segment_frames=config["segment_frames"])
    B = traffic["replicas"]
    groups = traffic["groups"]
    per = B // len(groups)
    if per * len(groups) != B:
        raise ValueError("replicas must split evenly over the groups")
    F = config["frames_per_replica"]
    slices = [slice(g * per, (g + 1) * per) for g in range(len(groups))]

    def fresh_fleet():
        return fleet_state.make_fleet(
            B, config["devices"], config["nominal_bw_bps"],
            max_windows=config["max_windows"],
            requeue_slots=config["requeue_slots"], device=device)

    def program_batch(values, bw):
        st, stats = engine.fleet_run(fresh_fleet(), values, bw, params=params)
        leaves = {f: getattr(st.sched if f.startswith("win") else st, f)
                  for f in ref.STATE_FIELDS}
        return leaves, stats._asdict(), st.rq_valid.sum(1)

    def program_reduce(host, pending, n_frames):
        fs = metrics.FleetStats(**{f: host[f]
                                   for f in metrics.FleetStats._fields})
        return [metrics.summarize(
            metrics.FleetStats(*(x[sl] for x in fs)), n_frames,
            rq_pending=pending[sl]) for sl in slices]

    def control_batch(values, bw):
        st, stats = ref.run(values, bw, p_ref, device=device,
                            dtype=torch.bfloat16)
        stats = {k: v.float() if v.is_floating_point() else v
                 for k, v in stats.items()}
        return ({f: st[f] for f in ref.STATE_FIELDS}, stats,
                st["rq_valid"].sum(1))

    def control_reduce(host, pending, n_frames):
        return [ref.summarize({k: v[sl] for k, v in host.items()}, n_frames,
                              pending[sl]) for sl in slices]

    run_batch, reduce_batch = {
        None: (program_batch, program_reduce),
        "control": (control_batch, control_reduce)}[program]
    rng = np.random.default_rng([seed, 7])
    n_sample = min(traffic["sample_per_group"], per)
    # one thread reduces each batch once its copies are on the host
    reducer = ThreadPoolExecutor(max_workers=1)

    def issue(values, bw, n_frames, timer=None):
        """Issue one batch and its copies to the host, and hand its
        reduction to the reducer's thread, which waits for the copies:
        the card goes on to the next batch meanwhile."""
        rows = np.sort(np.concatenate([
            rng.choice(per, n_sample, replace=False) + sl.start
            for sl in slices]))
        idx = torch.from_numpy(rows)
        idx = idx.pin_memory().to(device, non_blocking=True) if cuda \
            else idx
        with timer or contextlib.nullcontext():
            leaves, stats, pending = run_batch(values, bw)
        sampled = {f: x.index_select(0, idx) for f, x in leaves.items()}
        del leaves
        copies = _HostCopies(
            {"stats": stats, "sampled": sampled, "pending": {"n": pending}},
            cuda)

        def reduce():
            got = copies.wait()
            host = {f: v.numpy() for f, v in got["stats"].items()}
            pend = got["pending"]["n"].numpy().astype(np.int64)
            sums = reduce_batch(host, pend, n_frames)
            return (rows, got["sampled"], {f: v[rows] for f, v in
                                           host.items()}, host, pend, sums)

        return reducer.submit(reduce)

    # -- set-up: inputs, on the card, and a warm-up at the full batch -------
    phases = {"imports": time.perf_counter() - t_start}
    host_inputs = _inputs(traffic, config, seed)
    phases["inputs"] = time.perf_counter() - t_start
    dev_inputs = [(torch.from_numpy(v).to(device), torch.from_numpy(b)
                   .to(device)) for v, b in host_inputs]
    phases["on_device"] = time.perf_counter() - t_start
    if program is None:
        # the window's path, copies and reduction included, over a few
        # frames: every shape of the window, and the pinned buffers
        warm = traffic["warmup_frames"]
        issue(dev_inputs[0][0][:warm], dev_inputs[0][1][:warm],
              warm).result()
    if cuda:
        torch.cuda.synchronize()
    phases["warmed"] = time.perf_counter() - t_start
    print("set-up s since start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    trace_batch = traffic["trace_batch"] if trace else None

    # -- the window: batches issued back to back; once the time is up,
    # nothing more is issued, and the clock is read when every batch
    # issued has run and been reduced ------------------------------------
    issued = []      # per batch run: (input index, reduction, timer)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = 0
    while True:
        k = i % len(dev_inputs)
        seg = _SegmentTimer(traffic["trace_segment"]
                            if i == trace_batch else None)
        issued.append((k, issue(*dev_inputs[k], F, timer=seg), seg))
        i += 1
        if time.perf_counter() - t0 >= seconds and (
                not trace or i > trace_batch):
            break
    done = [(k, fut.result(), seg) for k, fut, seg in issued]
    reducer.shutdown()
    window_s = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    kept = []        # per batch run: (input index, rows, leaves, stats)
    reductions = []  # per batch run: (host stats, pending, summaries)
    trace_summary, committed = None, None
    for j, (k, (rows, sampled, stats, host, pend, sums), seg) in \
            enumerate(done):
        kept.append((k, rows, sampled, stats))
        reductions.append((host, pend, sums))
        if j == trace_batch:
            trace_summary = seg.slice.summary
            # every commit of fused_place adds one to lp_completed, and
            # only a preemption takes one off, adding it to hp_preempted
            committed = int(host["lp_completed"].sum()
                            + host["hp_preempted"].sum())
    del done, issued

    # -- the check ----------------------------------------------------------
    checks, failed = _check(kept, reductions, host_inputs, p_ref, F,
                            slices, device)
    outcome = Outcome(
        e2e={"setup_s": setup_s,
             "replica_frames_per_s": B * F * i / window_s},
        checks=checks, attempted=B * i, failed=failed,
        memory_peak_bytes=int(memory_peak))
    if trace:
        if trace_summary is None:
            raise RuntimeError("the traced segment never ran")
        S = params.segment_frames or F
        ticks = min(S, F - S * traffic["trace_segment"])
        fused, _ = kernel_time(trace_summary, "fused_place_kernel")
        print(f"traced batch: {committed} fused_place commits over "
              f"{F * fused / ticks:g} launches", file=sys.stderr)
        outcome.trace = trace_summary
        outcome.context = {
            "trace": trace_summary,
            "ticks": ticks,
            "fleet": {
                "replicas": B,
                "devices": config["devices"],
                "list_tracks": [int(t) for t in ref.CFG_TRACKS],
                "windows": config["max_windows"],
                # the traced batch's commits over its launches (exact for
                # the batch; the slice's launches are its steady share)
                "committed_per_fused_launch": (
                    committed / (F * fused / ticks) if fused else None),
            },
        }
    return outcome


def _check(kept, reductions, host_inputs, p: ref.Params, F, slices,
           device):
    """Counters and state of the sampled rows against the reference,
    every summary against the reference's reduction of the program's
    counters, and the conservation identity over every replica."""
    # one reference run over the sampled rows of every input batch used
    union = {}
    for k, rows, _, _ in kept:
        union[k] = np.union1d(union.get(k, rows), rows)
    order = sorted(union)
    values = np.concatenate([host_inputs[k][0][:, union[k]] for k in order],
                            axis=1)
    bw = np.concatenate([host_inputs[k][1][:, union[k]] for k in order],
                        axis=1)
    r_state, r_stats = ref.run(values, bw, p, device=device)
    r_state = {f: x.cpu() for f, x in r_state.items()}
    r_stats = {f: x.cpu().numpy() for f, x in r_stats.items()}
    offset, at = 0, {}
    for k in order:
        at[k] = offset
        offset += len(union[k])

    counter_bad = state_bad = 0
    bad_rows = 0
    for k, rows, leaves, stats in kept:
        pos = at[k] + np.searchsorted(union[k], rows)
        row_bad = np.zeros(len(rows), bool)
        for f in ref.STATS_FIELDS:
            diff = stats[f] != r_stats[f][pos]
            counter_bad += int(diff.sum())
            row_bad |= diff
        tpos = torch.from_numpy(pos)
        for f in ref.STATE_FIELDS:
            diff = (leaves[f] != r_state[f].index_select(0, tpos)).reshape(
                len(rows), -1)
            state_bad += int(diff.sum())
            row_bad |= diff.any(1).numpy()
        bad_rows += int(row_bad.sum())

    summary_bad, resid_max, resid_rows = 0, 0, 0
    for host, pending, sums in reductions:
        for sl, got in zip(slices, sums):
            want = ref.summarize({f: v[sl] for f, v in host.items()}, F,
                                 pending[sl])
            keys = set(want) | set(got)
            summary_bad += sum(want.get(key) != got.get(key) for key in keys)
        res = np.abs(ref.residual(host, pending))
        resid_max = max(resid_max, int(res.max()))
        resid_rows += int((res != 0).sum())
    checks = {
        "counter_mismatches": (counter_bad, 0),
        "state_mismatches": (state_bad, 0),
        "summary_mismatches": (summary_bad, 0),
        "conservation_max_abs": (resid_max, 0),
    }
    return checks, bad_rows + resid_rows
