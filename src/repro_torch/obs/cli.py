"""``python -m repro_torch.obs`` — record, export, and summarise
observability artifacts.

Counterpart of ``python -m repro.obs``, with the same commands, arguments
and files, plus ``record --device`` (``cuda`` by default, ``cpu`` for the
plain path on the host), the device of the fleet engine.

    record   run an engine with capture on and persist the recording
             (fleet → telemetry .npz + summary .json; serial → event-log
             .jsonl + summary .json) under ``--out`` (results/obs/)
    export   turn a recording into a Chrome trace-event JSON that loads
             in ui.perfetto.dev / chrome://tracing (validated on write)
    summary  print a quick textual digest of a recording

Examples:

    PYTHONPATH=src python -m repro_torch.obs record --scenario weighted2 \\
        --batch 8 --frames 95 --congestion 0.3
    PYTHONPATH=src python -m repro_torch.obs record --engine serial \\
        --scenario weighted2 --frames 95
    PYTHONPATH=src python -m repro_torch.obs export \\
        --input results/obs/fleet_weighted2_b8_f95_s0.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from repro_torch.obs.events import EventLog
from repro_torch.obs.export import (
    fleet_trace_events,
    load_trace,
    sim_trace_events,
    validate_trace,
    write_chrome_trace,
)
from repro_torch.obs.telemetry import load_record

DEFAULT_OUT = os.path.join("results", "obs")


def _write_json(path: str, payload: dict) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def cmd_record(args: argparse.Namespace) -> int:
    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.engine}_{args.scenario}"
    if args.engine == "fleet":
        # engines imported lazily: the CLI must not drag the fleet engine
        # and its kernels into `--help` or serial-only invocations
        from repro_torch.fleet import (
            FleetParams, fleet_run, make_fleet, make_workload, summarize,
        )

        params = FleetParams(telemetry=True, telemetry_every=args.every)
        wl = make_workload(args.scenario, args.batch, args.frames,
                           seed=args.seed, congestion=args.congestion)
        fleet = make_fleet(args.batch, device=args.device)
        _out, stats, rec = fleet_run(fleet, wl.values, wl.bw_scale,
                                     params=params)
        base = os.path.join(
            args.out, f"{tag}_b{args.batch}_f{args.frames}_s{args.seed}"
        )
        rec.save(base + ".npz")
        pending = _out.rq_valid.sum(1).cpu().numpy()
        _write_json(base + "_summary.json",
                    summarize(stats, args.frames, rq_pending=pending))
        print(f"recorded {rec.ticks.size} ticks x {rec.n_replicas} replicas"
              f" -> {base}.npz")
        print(f"summary  -> {base}_summary.json")
    else:
        from repro_torch.sim.engine import ExperimentConfig, run_experiment

        log = EventLog()
        cfg = ExperimentConfig(
            trace=args.scenario, n_frames=args.frames, seed=args.seed,
            duty_cycle=args.congestion,
        )
        metrics = run_experiment(cfg, event_log=log)
        base = os.path.join(args.out, f"{tag}_f{args.frames}_s{args.seed}")
        log.to_jsonl(base + ".jsonl")
        _write_json(base + "_summary.json", metrics.summary())
        print(f"recorded {len(log)} events -> {base}.jsonl")
        print(f"summary  -> {base}_summary.json")
    return 0


def cmd_export(args: argparse.Namespace) -> int:
    replicas = None
    if args.replicas:
        replicas = [int(x) for x in args.replicas.split(",") if x != ""]
    if args.input.endswith(".npz"):
        rec = load_record(args.input)
        events = fleet_trace_events(rec, replicas=replicas)
    elif args.input.endswith(".jsonl"):
        events = sim_trace_events(EventLog.from_jsonl(args.input))
    else:
        print(f"unrecognised recording {args.input!r} "
              "(expected .npz telemetry or .jsonl event log)",
              file=sys.stderr)
        return 2
    out = args.out or os.path.splitext(args.input)[0] + ".trace.json"
    write_chrome_trace(out, events)
    errors = validate_trace(load_trace(out))
    if errors:
        print("trace INVALID:", file=sys.stderr)
        for e in errors:
            print(f"  {e}", file=sys.stderr)
        return 1
    print(f"{len(events)} trace events -> {out} "
          "(open in ui.perfetto.dev)")
    return 0


def cmd_summary(args: argparse.Namespace) -> int:
    if args.input.endswith(".npz"):
        rec = load_record(args.input)
        s = rec.series
        print(f"fleet telemetry: {rec.ticks.size} ticks "
              f"(every={rec.every} of {rec.n_frames} frames), "
              f"B={rec.n_replicas}, Dev={rec.n_devices}")
        for name, total in (
            ("hp_completed", s.hp_completed_d), ("hp_failed", s.hp_failed_d),
            ("hp_preempted", s.hp_preempted_d),
            ("lp_completed", s.lp_completed_d),
            ("missed_by_preemption", s.missed_by_preemption_d),
        ):
            print(f"  {name:<22} {int(total.sum())}")
        print(f"  mean rq_depth          {float(s.rq_depth.mean()):.3f} "
              f"(max {int(s.rq_depth.max())})")
        print(f"  mean bandwidth         "
              f"{float(s.bandwidth_bps.mean()) / 1e6:.2f} Mbps")
    elif args.input.endswith(".jsonl"):
        log = EventLog.from_jsonl(args.input)
        print(f"serial event log: {len(log)} events")
        for kind, n in sorted(log.counts().items()):
            print(f"  {kind:<16} {n}")
    elif args.input.endswith(".json"):
        obj = load_trace(args.input)
        errors = validate_trace(obj)
        print(f"chrome trace: {len(obj.get('traceEvents', []))} events, "
              f"{'VALID' if not errors else 'INVALID'}")
        for e in errors:
            print(f"  {e}")
        return 1 if errors else 0
    else:
        print(f"unrecognised input {args.input!r}", file=sys.stderr)
        return 2
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="record / export / summarise observability artifacts",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record", help="run an engine with capture on")
    rec.add_argument("--engine", choices=("fleet", "serial"),
                     default="fleet")
    rec.add_argument("--scenario", default="uniform",
                     help="fleet scenario / serial trace family")
    rec.add_argument("--batch", type=int, default=8,
                     help="fleet replicas (fleet engine only)")
    rec.add_argument("--frames", type=int, default=95)
    rec.add_argument("--congestion", type=float, default=0.0)
    rec.add_argument("--seed", type=int, default=0)
    rec.add_argument("--every", type=int, default=1,
                     help="telemetry stride in ticks (fleet engine only)")
    rec.add_argument("--out", default=DEFAULT_OUT)
    rec.add_argument("--device", default=None,
                     help="device of the fleet engine (default cuda, "
                          "which must be present; cpu for the plain path "
                          "on the host)")
    rec.set_defaults(fn=cmd_record)

    exp = sub.add_parser("export", help="recording -> Chrome trace JSON")
    exp.add_argument("--input", required=True,
                     help=".npz telemetry or .jsonl event log")
    exp.add_argument("--out", default=None,
                     help="output path (default: <input>.trace.json)")
    exp.add_argument("--replicas", default=None,
                     help="comma-separated replica indices (fleet)")
    exp.set_defaults(fn=cmd_export)

    summ = sub.add_parser("summary", help="digest of a recording/trace")
    summ.add_argument("--input", required=True)
    summ.set_defaults(fn=cmd_summary)

    args = ap.parse_args(argv)
    return args.fn(args)
