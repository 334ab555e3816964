#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path on the card and checks it, phase by phase,
printing one JSON line per phase; the first failure raises and the run
exits non-zero. It imports nothing of JAX or of the JAX package.

1. card: the GPU's name and power limit, as ``nvidia-smi`` reports them;
2. build: the CUDA kernels, from ``src/repro_torch/kernels/*/csrc``;
3. kernel: every kernel against its plain PyTorch version on the card, on
   seeded random rows plus hand-built corner rows, at B=8192 and at a
   ragged B=37 — every output must be bit-identical;
4. main path: ``run_sweep`` of 4 cells x 2048 seeds x 95 frames in one
   batch of 8192 replicas with ``FleetParams()`` defaults; the placement
   kernel must launch 21 times a tick, and no LP task may be lost;
5. plain path: the same batch through ``placement_backend="ref"`` must give
   bit-identical counters and final state, and the same cell summaries;
6. timing: each kernel's time per launch at the main path's shapes (CUDA
   events) beside its byte bound and the plain version's time, and where
   the main path's time goes (``torch.profiler``).

Then one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
B_MAIN = 8192
N_FRAMES = 95
LAUNCHES_PER_TICK = 21            # 1 re-queue + 4 devices x (1 + 4)
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12            # H100 SXM, non-tensor f32


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def max_abs_err(outs_a, outs_b) -> float:
    err = 0.0
    for a, b in zip(outs_a, outs_b):
        if a.dtype.is_floating_point:
            err = max(err, (a.double() - b.double()).abs().max().item())
        else:
            err = max(err, (a.long() - b.long()).abs().max().item())
    return err


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.carry import fleet_to_numpy
    from repro_torch.fleet import FleetParams, SweepConfig, fleet_run
    from repro_torch.fleet import make_fleet, run_sweep
    from repro_torch.fleet.metrics import FleetStats, stats_to_numpy, summarize
    from repro_torch.fleet.sweep import _build_population
    from repro_torch.kernels import _build
    from repro_torch.kernels.placement import cases, placement
    from repro_torch.kernels.placement.ref import fused_place_ref

    dev = torch.device("cuda")

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build(["placement"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs),
          "nvcc": {k: v.splitlines() for k, v in logs.items()}})

    # -- 3. kernel against its plain version ---------------------------------
    def on_card(case):
        return [torch.from_numpy(x.copy()).to(dev) for x in case]

    kernel_err = 0.0
    for b, seed in ((B_MAIN, 0), (37, 1)):
        case = cases.with_adversarial_rows(cases.random_case(b, seed=seed))
        ref = fused_place_ref(*on_card(case))
        ker = placement.fused_place(*on_card(case))
        torch.cuda.synchronize()
        same = [bit_equal(r, k) for r, k in zip(ref, ker)]
        kernel_err = max(kernel_err, max_abs_err(ref, ker))
        emit({"phase": "kernel", "kernel": "fused_place", "B": b,
              "outputs_bit_identical": same, "max_abs_err": kernel_err,
              "ok_rows": int(ref[3].sum()), "dropped": int(ref[8].sum()),
              "use4_rows": int((ref[3] & ref[7]).sum())})
        check(all(same), f"fused_place differs from its plain version "
                         f"at B={b}: {same}")

    # -- 4. the main path ----------------------------------------------------
    sweep = SweepConfig(scenarios=("uniform", "weighted2"),
                        congestion_levels=(0.0, 0.3), n_seeds=2048,
                        n_frames=N_FRAMES, batch_size=B_MAIN)
    params = sweep.fleet_params()
    warm_v, warm_bw = _build_population(
        SweepConfig(n_seeds=B_MAIN // 4, n_frames=2))[1:3]
    fleet_run(make_fleet(B_MAIN, device=dev), warm_v, warm_bw, params=params)
    torch.cuda.synchronize()

    placement.launches = 0
    t0 = time.perf_counter()
    summary = run_sweep(sweep, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = placement.launches
    cells = summary["_sweep"]["cells"]
    residual = {c: summary[c]["conservation_residual"]["max_abs"]
                for c in cells}
    emit({"phase": "main_path", "entry": "run_sweep", "replicas": B_MAIN,
          "frames": N_FRAMES, "seconds": wall,
          "ms_per_tick": 1e3 * wall / N_FRAMES,
          "replicas_per_s": B_MAIN / wall,
          "replica_frames_per_s": B_MAIN * N_FRAMES / wall,
          "fused_place_launches": launches,
          "frame_completion_rate": {
              c: summary[c]["frame_completion_rate"] for c in cells},
          "conservation_residual_max_abs": residual})
    check(launches == LAUNCHES_PER_TICK * N_FRAMES,
          f"fused_place launched {launches} times, not "
          f"{LAUNCHES_PER_TICK * N_FRAMES}")
    check(all(v == 0 for v in residual.values()),
          f"LP tasks lost or double-counted: {residual}")

    # -- 5. the plain path on the same batch ---------------------------------
    _, values, bw, owners = _build_population(sweep)
    runs = {}
    for backend in ("auto", "ref"):
        p = FleetParams(placement_backend=backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = fleet_run(make_fleet(B_MAIN, device=dev), values, bw,
                                 params=p)
        torch.cuda.synchronize()
        runs[backend] = (state, stats, time.perf_counter() - t0)
    (sk, tk, wall_k), (sr, tr, wall_r) = runs["auto"], runs["ref"]
    diff = [f for f, a, b in zip(FleetStats._fields, tk, tr)
            if not bit_equal(a, b)]
    diff += [f"sched.{f}" for f, a, b in zip(sk.sched._fields, sk.sched,
                                             sr.sched) if not bit_equal(a, b)]
    diff += [f for f, a, b in zip(sk._fields[1:], sk[1:], sr[1:])
             if not bit_equal(a, b)]
    stats_np = stats_to_numpy(tr)
    pending = fleet_to_numpy(sr).rq_valid.sum(1)
    same_summary = all(
        summarize(FleetStats(*(x[owners == ci] for x in stats_np)),
                  N_FRAMES, rq_pending=pending[owners == ci]) == summary[c]
        for ci, c in enumerate(cells))
    emit({"phase": "plain_path", "differing": diff,
          "summaries_equal_main_path": same_summary,
          "kernel_path_seconds": wall_k, "plain_path_seconds": wall_r})
    check(not diff, f"kernel and plain main paths differ in {diff}")
    check(same_summary, "plain-path summaries differ from run_sweep's")

    # -- 6. timing -----------------------------------------------------------
    case = cases.with_adversarial_rows(cases.random_case(B_MAIN, seed=0))
    pristine = on_card(case)
    work = [x.clone() for x in pristine]

    def reset():
        for w, p in zip(work[:3], pristine[:3]):
            w.copy_(p)

    def launch():
        reset()
        placement.fused_place(*work)

    for fn in (reset, launch):
        fn()
    torch.cuda.synchronize()
    times = {"copy": [], "both": []}
    for _ in range(2):            # in turns: copy, both, both, copy
        times["copy"].append(cuda_ms(reset, 50))
        times["both"].append(cuda_ms(launch, 50))
    kernel_ms = (sum(times["both"]) - sum(times["copy"])) / 2
    fused_place_ref(*pristine)
    plain_ms = cuda_ms(lambda: fused_place_ref(*pristine), 10)

    ref = fused_place_ref(*pristine)
    t1, t2, valid, md, q1, dl, src, do = case
    n_ok = int(ref[3].sum())
    B, n_dev, n_cfg, T, W = t1.shape
    win = 4 + 4 + 1                              # t1, t2, valid per window
    read = (B * 2 * n_dev * T * W * win          # lp2 + lp4 lists, queried
            + n_ok * T * W * win                 # hp list of the winner
            + B * (n_cfg * 4 + 2 * n_dev * 4 + 4 + 1))
    written = n_ok * n_cfg * T * W * win + B * (1 + 4 + 4 + 4 + 1 + 4)
    ops = B * 2 * n_dev * T * W * 5 + n_ok * n_cfg * T * W * 14
    bound_bytes_ms = 1e3 * (read + written) / HBM_BYTES_PER_S
    bound_ops_ms = 1e3 * ops / FP32_OPS_PER_S
    emit({"phase": "timing", "kernel": "fused_place", "B": B,
          "ms": kernel_ms, "copy_ms": times["copy"],
          "copy_plus_kernel_ms": times["both"], "plain_ms": plain_ms,
          "bytes": read + written, "ops": ops,
          "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_ops_ms})

    # where the main path's time goes: 5 ticks under the profiler
    from torch.profiler import ProfilerActivity, profile

    v5, bw5 = values[:5], bw[:5]
    fleet = make_fleet(B_MAIN, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fleet_run(fleet, v5, bw5, params=params)
        torch.cuda.synchronize()
        wall5 = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    device_us = sum(r[0] for r in rows)
    emit({"phase": "profile", "ticks": 5, "wall_ms": 1e3 * wall5,
          "device_busy_ms": device_us / 1e3 if rows else None,
          "device_busy_share": device_us / 1e6 / wall5 if rows else None,
          "top_device_ops": [
              {"name": k[:80], "ms": us / 1e3, "calls": n}
              for us, k, n in rows[:10]]})

    emit({"kernels": [{
        "name": "fused_place",
        "route": "cuda",
        "source": "src/repro_torch/kernels/placement/csrc/placement.cu",
        "replaces": "src/repro/kernels/placement/placement.py:74",
        "launches": launches,
        "matched": True,
        "max_abs_err": kernel_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                     else "operations"),
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
