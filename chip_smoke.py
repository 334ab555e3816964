#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path on the card and checks it, phase by phase,
printing one JSON line per phase; the first failure raises and the run
exits non-zero. It imports nothing of JAX or of the JAX package.

1. card: the GPU's name and power limit, as ``nvidia-smi`` reports them;
2. build: the CUDA kernels, from ``src/repro_torch/kernels/*/csrc``, one
   ``nvcc`` each, all started together;
3. kernel: every kernel against its plain PyTorch version on the card:
   ``fused_place`` on seeded random rows plus hand-built corner rows, at
   B=8192 and at a ragged B=37 — every output must be bit-identical;
   ``flash_attention`` on seeded N(0,1) inputs at the waste pipeline's
   shapes (S 173 and 233, bf16 and f32), a qwen2.5-3b and a gemma2-2b local
   and global layer, a ragged small case and a non-causal one — within
   2e-5 (f32) and 1.6e-2 (bf16, one ulp at |out| < 4);
4. fleet path: ``run_sweep`` of 4 cells x 2048 seeds x 95 frames in one
   batch of 8192 replicas with ``FleetParams()`` defaults; the placement
   kernel must launch 21 times a tick, and no LP task may be lost;
5. plain fleet path: the same batch through ``placement_backend="ref"``
   must give bit-identical counters and final state, and the same cell
   summaries;
6. serving path: ``serve`` of 40 frame periods of the full waste-pipeline
   config through the RAS scheduler and the WPS baseline; the attention
   kernel must launch once per layer of every forward pass; then one engine
   built twice from the same weights, on the kernel and on the plain
   attention, must give equal serving results and logits within 2e-2 (bf16)
   and 1e-4 (f32) of the largest logit;
7. timing: each kernel's time per launch at its shapes (CUDA events) beside
   its bound, the plain version's time and, for attention, the time of
   ``scaled_dot_product_attention`` (a yardstick the port never calls); and
   where each path's time goes (``torch.profiler``).

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
BF16_OPS_PER_S = 989e12           # H100 SXM, dense bf16 tensor cores
SERVE_PERIODS = 40
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
#: (name, B, H, K, S, hd, dtype, causal, window, softcap)
ATTN_CASES = [
    ("waste-stage1-bf16", 1, 8, 8, 173, 64, torch.bfloat16, True, 0, 0.0),
    ("waste-stage3-bf16", 1, 8, 8, 233, 64, torch.bfloat16, True, 0, 0.0),
    ("waste-stage1-f32", 1, 8, 8, 173, 64, torch.float32, True, 0, 0.0),
    ("waste-stage3-f32", 1, 8, 8, 233, 64, torch.float32, True, 0, 0.0),
    ("qwen2.5-3b", 1, 16, 2, 4096, 128, torch.bfloat16, True, 0, 0.0),
    ("gemma2-2b-local", 1, 8, 4, 8192, 256, torch.bfloat16, True, 4096, 50.0),
    ("gemma2-2b-global", 1, 8, 4, 8192, 256, torch.bfloat16, True, 0, 50.0),
    ("ragged-small", 2, 4, 2, 37, 32, torch.float32, True, 8, 20.0),
    ("bidirectional", 1, 4, 2, 300, 128, torch.float32, False, 0, 0.0),
]
MAIN_ATTN_CASE = "waste-stage3-bf16"   # the stage-3 forward's attention


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


def time_ms(fn, budget_ms: float = 100.0) -> float:
    """Mean ms per call of ``fn``, over as many calls as fit the budget."""
    fn()
    one = cuda_ms(fn, 1)
    return cuda_ms(fn, max(3, min(200, int(budget_ms / max(one, 1e-3)))))


def attn_inputs(i, case, dev):
    _, B, H, K, S, hd, dt, *_ = case
    g = torch.Generator().manual_seed(1000 + i)
    return [torch.randn(shape, generator=g).to(dev, dt)
            for shape in ((B, H, S, hd), (B, K, S, hd), (B, K, S, hd))]


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible: the score entries whose
    work the attention must do."""
    total = 0
    for q in range(S):
        hi = q + 1 if causal else S
        lo = max(0, q - window + 1) if window > 0 else 0
        total += hi - lo
    return total


def attn_bound(case):
    """(bound ms, bound_by, flops, bytes) of one attention call: QK^T and
    PV over the visible entries at the peak rate of the inputs' type, and
    q, k, v read once and o written once at the HBM rate."""
    _, B, H, K, S, hd, dt, causal, window, _ = case
    flops = 4 * hd * visible_pairs(S, causal, window) * B * H
    nbytes = (2 * B * H + 2 * B * K) * S * hd * (2 if dt == torch.bfloat16
                                                 else 4)
    rate = BF16_OPS_PER_S if dt == torch.bfloat16 else FP32_OPS_PER_S
    ops_ms, bytes_ms = 1e3 * flops / rate, 1e3 * nbytes / HBM_BYTES_PER_S
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def library_attention(q, k, v, causal, window, cap):
    """One ``scaled_dot_product_attention`` call computing the same
    function (k and v expanded to the query heads beforehand), or None
    where the soft-cap has no counterpart there."""
    if cap > 0:
        return None
    import torch.nn.functional as F

    group = q.shape[1] // k.shape[1]
    ke = k.repeat_interleave(group, dim=1)
    ve = v.repeat_interleave(group, dim=1)
    if window > 0:
        pos = torch.arange(q.shape[2], device=q.device)
        diff = pos[:, None] - pos[None, :]
        mask = diff < window
        if causal:
            mask &= diff >= 0
        return lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                      attn_mask=mask)
    return lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                  is_causal=causal)


def profile_device(fn, label):
    """Device busy share and the top device ops of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    device_us = sum(r[0] for r in rows)
    return {"phase": "profile", "of": label, "wall_ms": 1e3 * wall,
            "device_busy_ms": device_us / 1e3 if rows else None,
            "device_busy_share": device_us / 1e6 / wall if rows else None,
            "top_device_ops": [
                {"name": k[:80], "ms": us / 1e3, "calls": n}
                for us, k, n in rows[:10]]}


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
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dev = torch.device("cuda")
    # full-f32 matmuls in the plain versions (TF32 would round the inputs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    logs = _build.build(["placement", "flash_attention"])
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

    attn_err = {}
    for i, c in enumerate(ATTN_CASES):
        name, *_, dt, causal, window, cap = c
        q, k, v = attn_inputs(i, c, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        ker = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, **kw)
        err = max_abs_err([ref], [ker])
        attn_err[name] = err
        emit({"phase": "kernel", "kernel": "flash_attention", "case": name,
              "shape": list(q.shape), "kv_heads": k.shape[1],
              "dtype": str(dt), **kw, "max_abs_err": err,
              "max_abs_out": ref.float().abs().max().item(),
              "tolerance": ATTN_TOL[dt],
              "finite": bool(torch.isfinite(ker).all())})
        check(ker.dtype == dt and ker.shape == q.shape
              and bool(torch.isfinite(ker).all()),
              f"flash_attention gave a bad result in case {name}")
        check(err <= ATTN_TOL[dt], f"flash_attention differs from its plain "
                                   f"version in case {name}: {err}")
        del q, k, v, ker, ref
    torch.cuda.empty_cache()

    # -- 4. the fleet path --------------------------------------------------
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

    # -- 5. the plain fleet path on the same batch ---------------------------
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

    # -- 6. the serving path -----------------------------------------------
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.tasks import FRAME_PERIOD
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import Model
    from repro_torch.serving import engine
    from repro_torch.serving.engine import ServeResult, ServingEngine
    from repro_torch.sim.traces import generate_trace

    wcfg = get_config("waste-pipeline")
    serve_launches, serve_forwards = 0, 0
    for sched in ("ras", "wps"):
        torch.cuda.synchronize()
        fa.launches = placement.launches = engine.forwards = 0
        t0 = time.perf_counter()
        out = serve(arch="waste-pipeline", frames=SERVE_PERIODS,
                    scheduler=sched, trace="weighted2", seed=0,
                    device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch, n_fwd = fa.launches, engine.forwards
        serve_launches += n_launch
        serve_forwards += n_fwd
        emit({"phase": "serving_path", "entry": "serve", **out,
              "seconds": wall, "forward_passes": n_fwd,
              "flash_attention_launches": n_launch,
              "fused_place_launches": placement.launches})
        check(n_launch > 0 and n_launch == wcfg.n_layers * n_fwd,
              f"flash_attention launched {n_launch} times for {n_fwd} "
              f"forward passes of {wcfg.n_layers} layers")
        check(out["frames_submitted"] > 0
              and 0.0 <= out["completion_rate"] <= 1.0,
              f"serve({sched}) gave {out}")

    # one engine built twice from the same weights: kernel vs plain attention
    tr = generate_trace("weighted2", SERVE_PERIODS, 4, seed=0)
    frames = [(d, int(tr.entries[f, d]), f * FRAME_PERIOD)
              for f in range(SERVE_PERIODS) for d in range(4)
              if tr.entries[f, d] >= 0]
    weights = Model(wcfg, seed=0, device=dev).state_dict()
    results = {}
    for backend in ("kernel", "ref"):
        model = Model(wcfg, device=dev, attn_backend=backend)
        model.load_state_dict(weights)
        eng = ServingEngine(wcfg, scheduler="ras", seed=0, device=dev,
                            model=model)
        results[backend] = [eng.submit_frame(i, src, n, now=now)
                            for i, (src, n, now) in enumerate(frames)]
    fields = [f.name for f in dataclasses.fields(ServeResult)
              if f.name != "logits_checksum"]
    differing = sorted({f for a, b in zip(results["kernel"], results["ref"])
                        for f in fields if getattr(a, f) != getattr(b, f)})

    # the engine's stage-1 and stage-3 inputs, and a random stage-3 shape
    media = torch.zeros((1, wcfg.n_media_tokens, wcfg.d_model), device=dev)
    g = torch.Generator().manual_seed(7)
    batches = [{"tokens": torch.zeros((1, n), dtype=torch.int32, device=dev),
                "media": media} for n in (4, 64)]
    batches.append({
        "tokens": torch.randint(0, wcfg.vocab_size, (1, 64),
                                generator=g).to(dev),
        "media": torch.randn(media.shape, generator=g).to(dev)})
    rel_err = {}
    for label, cfg in (("bf16", wcfg),
                       ("f32", dataclasses.replace(wcfg, dtype="float32"))):
        logits = {}
        for backend in ("kernel", "ref"):
            model = Model(cfg, device=dev, attn_backend=backend)
            model.load_state_dict(
                {k: v.to(getattr(torch, cfg.dtype))
                 for k, v in weights.items()})
            with torch.inference_mode():
                logits[backend] = [model(b)[0].float() for b in batches]
        rel_err[label] = [(lk - lr).abs().max().item() / lr.abs().max().item()
                          for lk, lr in zip(logits["kernel"], logits["ref"])]
    emit({"phase": "serving_plain_attention", "frames": len(frames),
          "differing_fields": differing,
          "completion_rate": {b: sum(r.completed for r in rs) / len(rs)
                              for b, rs in results.items()},
          "logits_err_over_max": rel_err,
          "batches": ["stage1", "stage3", "random stage3-shaped"]})
    check(not differing, f"kernel and plain serving differ in {differing}")
    check(max(rel_err["bf16"]) <= 2e-2,
          f"bf16 logits differ: {rel_err['bf16']}")
    check(max(rel_err["f32"]) <= 1e-4, f"f32 logits differ: {rel_err['f32']}")

    # -- 7. timing -----------------------------------------------------------
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

    attn_rows = []
    for i, c in enumerate(ATTN_CASES):
        name, *_, causal, window, cap = c
        q, k, v = attn_inputs(i, c, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        ker_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        ref_ms = time_ms(lambda: attention_ref(q, k, v, **kw))
        lib = library_attention(q, k, v, causal, window, cap)
        lib_ms = time_ms(lib) if lib is not None else None
        bound_ms, bound_by, flops, nbytes = attn_bound(c)
        row = {"case": name, "ms": ker_ms, "plain_ms": ref_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               "tflops": flops / ker_ms / 1e9,
               "max_abs_err": attn_err[name]}
        attn_rows.append(row)
        emit({"phase": "timing", "kernel": "flash_attention", **row})
        del q, k, v, lib
    torch.cuda.empty_cache()
    main_attn = next(r for r in attn_rows if r["case"] == MAIN_ATTN_CASE)

    # where the fleet path's time goes: 5 ticks under the profiler
    v5, bw5 = values[:5], bw[:5]
    fleet = make_fleet(B_MAIN, device=dev)
    emit({**profile_device(lambda: fleet_run(fleet, v5, bw5, params=params),
                           "fleet_run"), "ticks": 5})

    # where a serving forward's time goes: one stage-3 forward
    model = Model(wcfg, seed=0, device=dev)

    def forward3():
        with torch.inference_mode():
            model(batches[1])

    for _ in range(3):
        forward3()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        forward3()
    torch.cuda.synchronize()
    emit({**profile_device(forward3, "stage-3 forward"),
          "host_ms_per_forward_unprofiled": 1e3 * (time.perf_counter() - t0)
          / 20})

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
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:100",
        "launches": serve_launches,
        "forward_passes": serve_forwards,
        "max_abs_err": max(attn_err.values()),
        "case": MAIN_ATTN_CASE,
        "ms": main_attn["ms"],
        "plain_ms": main_attn["plain_ms"],
        "bound_ms": main_attn["bound_ms"],
        "bound_by": main_attn["bound_by"],
        "library_ms": main_attn["library_ms"],
        "cases": [{k: r[k] for k in ("case", "ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}
                  for r in attn_rows],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
