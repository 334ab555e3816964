#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path on the card and checks it, phase by phase,
printing one JSON line per phase; the first failure raises and the run
exits non-zero. It imports nothing of JAX or of the JAX package.

1. card: the GPU's name and power limit, as ``nvidia-smi`` reports them;
2. build: the seven CUDA libraries, from ``src/repro_torch/kernels/*/csrc``
   and the analysis fixture's ``src/repro_torch/analysis/fixtures/csrc``,
   one ``nvcc`` each, all started together;
3. kernel: every kernel against its plain PyTorch version on the card:
   ``fused_place`` on seeded random rows plus hand-built corner rows, at
   B=8192 and at a ragged B=37, on one replica, on a ragged last block
   (B=1027), on a batch whose every row has do = false (which must
   leave the windows as they were) and on 6 devices a replica — every
   output must be bit-identical;
   ``flash_attention`` on seeded N(0,1) inputs at the waste pipeline's
   shapes (S 173 and 233, bf16 and f32), a qwen2.5-3b and a gemma2-2b local
   and global layer, a zamba2-7b layer (hd 112), a ragged small case and a
   non-causal one — within 2e-5 (f32) and 1.6e-2 (bf16, one ulp at
   |out| < 4), every bf16 case on the tensor-core (wgmma) kernel and every
   f32 case on the SIMT one; ``ssm_scan``, ``ssd_scan`` and ``flash_decode``
   (a split pass and a combine pass a call) at the layer
   shapes of falcon-mamba-7b and zamba2-7b and at ragged small shapes —
   scans in f32 within 1e-4 of the largest |y|, bf16 outputs within one
   bf16 ulp of the largest |y| (the 1.6e-2 of attention below 4);
   ``window_query`` and ``window_query_batched`` bit for bit at the
   reference query benchmark's 1024 devices, a ragged 300, 262,144
   devices, T 1 x W 15, B 8192 x Dev 4 (with ties on the ``<=``), the
   fleet's strided HP view at B 8192, a ragged B 3 x Dev 6 and a B 2048 x
   Dev 4 view offset by one element, each case on its route (the last two
   named on the scalar route, the rest on the vector one); then the
   window-query path, ``window_query_op`` on the 1024 devices, must launch
   the kernel once and equal the plain version on the host;
4. fleet path: ``run_sweep`` of 4 cells x 2048 seeds x 95 frames in one
   batch of 8192 replicas with ``FleetParams()`` defaults; a tick must
   launch the placement kernel 21 times and the window-query kernel 4 times
   (the HP query of each device, every one on the vector route), and no LP
   task may be lost;
5. plain fleet path: the same batch through ``placement_backend="ref"``,
   which launches neither kernel, must give bit-identical counters and
   final state, and the same cell summaries;
6. serving path: ``serve`` of 40 frame periods of the full waste-pipeline
   config through the RAS scheduler and the WPS baseline; the attention
   kernel must launch once per layer of every forward pass, on its wgmma
   route (the config is bf16); then one engine
   built twice from the same weights, on the kernel and on the plain
   attention, must give equal serving results and logits within 2e-2 (bf16)
   and 1e-4 (f32) of the largest logit;
7. hybrid path: the full zamba2-7b config (81 Mamba-2 blocks, 13 calls of
   the shared attention block, bf16, random weights from a seed): one
   ``Model.forward`` of 1 x 4096 tokens, which must launch ``ssd_scan`` 81
   times and ``flash_attention`` 13 times (all on its wgmma route), then 8
   ``decode_step``s at
   batch 4 against 32768-long caches filled from a seed, each launching
   ``flash_decode`` 13 times (13 split and 13 combine passes);
8. ssm path: the full falcon-mamba-7b config (64 Mamba-1 blocks): one
   forward of 1 x 4096 tokens with 64 ``ssm_scan`` launches, then 8 decode
   steps at batch 128;
9. kernel path vs plain path at model level, full width and cut depth
   (zamba2 13 blocks, falcon-mamba 4, S 512; 4 zamba2 decode steps against
   a 4096 cache): logits within 2e-2 of the largest logit (bf16);
10. timing: each kernel's time per launch at its shapes (CUDA events) beside
   its bound, the plain version's time and, where one PyTorch call computes
   the same function, that call's time (a yardstick the port never calls),
   with each attention, decode and scan case's TFLOP/s or GB/s and share of
   its bound (``ssm_scan``'s bound the largest of its bytes, f32
   instructions and exps, all three on its timing row), and ptxas's
   registers, spills and wgmma-serialization notes of the placement,
   attention, decode, scan and window-query kernels; ``fused_place``'s
   device time cold (L2 flushed by a 64 MB write, the time held to the HBM
   bound) and warm (windows in L2, as the fleet meets them), and a
   near-empty launch's device time;
   the window-query kernels' device time a launch cold (L2 flushed) and
   warm at every case, held to their byte bound, and the host's cost of
   one call of the fleet's HP query, split into the wrapper's parts; the
   racy fixture's device time a launch (the profiler's device events); and
   where each path's time goes (``torch.profiler``);
11. single controller: ``hp_place`` on each device and ``lp_place`` of 4
   tasks (lp2, lp4) from the same loaded scheduler on the card and on the
   host give the same outputs and state bit for bit; both timed;
12. launch-checker fixture: ``racy_sum`` on the card, whose two blocks
   write the same outputs: each output must be one of the two writers'
   values and the whole must differ from a correct reduction; the checker
   must flag its declared launch as a write race and find the production
   registry clean;
13. calibration: the serial DES (``run_experiment``, host Python) gives
   RAS, WPS and HYB frame-completion rates on weighted2 and weighted4 at
   congestion 0 and 0.3 (each run timed); then the committed grid of
   ``results/calib/baseline.json`` (5 paper traces x congestion 0 and 0.3
   x 3 seeds x 95 frames) through ``run_calibration`` on the card: every
   point launches the placement kernel 21 times and the window-query
   kernel 4 times a tick, the report must pass the committed bands and
   equal, key by key, the plain path's (``placement_backend="ref"``,
   which launches neither); each fleet point timed alone, one profiled;
14. sanitize: the fleet path's 8192 replicas for 10 ticks with
   ``REPRO_SANITIZE`` off, on, on, off must be bit-identical with the same
   launches (ms a tick each); one calibration point under the flag must
   pass the committed bands; a fleet with one corrupted window must raise
   ``SanitizeError`` naming the window order, and the run goes on;
15. telemetry: the fleet path's 8192 replicas for 95 ticks with
   ``telemetry`` off, on, on, off (ms a tick each), bit-identical to the
   main fleet run with 21 + 4 launches a tick; the record's 17 series
   equal bit for bit to the plain path's and to a stride-5 record's
   rows, the ``*_d`` series summing to the final counters, the ``.npz``
   round trip and the Chrome trace of replicas 0 and 8191 valid;
16. profile: a ``PhaseTimer`` counts one ``fleet/segment`` span a
   segment; with ``REPRO_PROFILE_DIR`` set a 5-tick run writes one
   ``torch.profiler`` trace naming ``fused_place_kernel`` and
   ``window_query_kernel``; under ``profile_device`` it still runs and
   writes nothing;
17. obs CLI: ``repro_torch.obs.cli.main`` records B 8 x 95 frames of
   weighted2 at 0.3 on the card (equal bit for bit to the host's) and
   the serial DES, exports and summarises both; the traces valid;
18. sharded: ``run_sweep(mesh_shards=1)`` of the fleet cell, in one
   batch and in batches of 3000 (a tail of owners -1), within 1e-5 of
   the unsharded sweep with residual 0 and 21 + 4 launches a tick;
   ``mesh_shards=2`` raises on one card; the per-cell reduction's time
   and the bytes a batch copies to the host.

Every phase line carries ``elapsed_s``, the seconds since the start. Then
one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
B_MAIN = 8192
N_FRAMES = 95
FUSED_PER_TICK = 21               # 1 re-queue + 4 devices x (1 + 4)
HP_QUERIES_PER_TICK = 4           # one window query a device
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12            # H100 SXM, non-tensor f32
BF16_OPS_PER_S = 989e12           # H100 SXM, dense bf16 tensor cores
#: f32 instructions a second: 67 TFLOP/s counts an FMA as two operations;
#: an FMA, a multiply or an add is one instruction
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
SMS = 132                         # H100 SXM
BOOST_CLOCK_HZ = 1.98e9           # H100 SXM, data sheet's maximum boost
EX2_PER_CLOCK_SM = 16             # special-function unit results a clock
SERVE_PERIODS = 40
L2_FLUSH_BYTES = 64 << 20         # written between cold launches (L2 50 MB)
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
    ("zamba2-7b", 1, 32, 32, 4096, 112, torch.bfloat16, True, 0, 0.0),
    ("ragged-small", 2, 4, 2, 37, 32, torch.float32, True, 8, 20.0),
    ("bidirectional", 1, 4, 2, 300, 128, torch.float32, False, 0, 0.0),
]
MAIN_ATTN_CASE = "waste-stage3-bf16"   # the stage-3 forward's attention
ROUTES = ("wgmma", "simt")             # flash_attention's kernels
KERNELS = ["placement", "flash_attention", "ssm_scan", "ssd_scan",
           "flash_decode", "window_query", "racy_sum"]
BENCH_QUERY = (30.0, 90.0, 17.2)  # q1, deadline, dur of the reference's
                                  # benchmarks/bench_query.py
WQ_SCALARS = (10.1, 80.3, 17.2)   # q1, deadline, dur that f32 rounds
RACY_N = 1 << 20                  # outputs of the racy fixture
SCAN_F32_TOL = 1e-4               # of the largest |y|
DECODE_F32_TOL = 3e-5             # of a decode output row's largest |y|
#: (name, B, S, d_inner, N, dtype): Mamba-1 selective scans
SSM_CASES = [
    ("falcon-mamba-7b", 1, 4096, 8192, 16, torch.bfloat16),
    ("ragged-small", 2, 77, 200, 16, torch.float32),
]
#: (name, B, S, H, P, N, dtype): Mamba-2 SSD scans
SSD_CASES = [
    ("zamba2-7b", 1, 4096, 112, 64, 64, torch.bfloat16),
    ("ragged-small", 2, 77, 3, 64, 64, torch.float32),
    ("ragged-small-bf16", 2, 77, 3, 64, 64, torch.bfloat16),
]
#: (name, B, H, K, S, hd, dtype, window, softcap): decode attention; pos
#: is near the end of the cache for zamba2, anywhere (0 included) else.
#: The f32 case at zamba2's shape resolves single keys (see decode_tol).
DECODE_CASES = [
    ("zamba2-7b", 4, 32, 32, 32768, 112, torch.bfloat16, 0, 0.0),
    ("zamba2-7b-f32", 4, 32, 32, 32768, 112, torch.float32, 0, 0.0),
    ("gqa-window-softcap", 3, 8, 2, 1000, 64, torch.float32, 100, 30.0),
    ("gqa-bf16-ragged", 2, 16, 2, 4097, 128, torch.bfloat16, 0, 0.0),
]
SEQ = 4096                        # prefill tokens of the model paths
DECODE_STEPS = 8
HYBRID_DECODE = (4, 32768)        # batch, cache length
SSM_DECODE_BATCH = 128
MODEL_TOL = 2e-2                  # kernel vs plain logits, of max |logit|
BASELINE = ROOT / "results" / "calib" / "baseline.json"
SERIAL_SCHEDULERS = ("ras", "wps", "hyb")
SERIAL_TRACES = ("weighted2", "weighted4")
SANITIZE_FRAMES = 10              # ticks of the sanitized B_MAIN fleet
OBS_DIR = ROOT / "build" / "chip_smoke_obs"   # git-ignored
TELEMETRY_STRIDE = 5              # the strided record's telemetry_every
SWEEP_TAIL_BATCH = 3000           # batches of the padded sharded sweep
CLI_BATCH = 8                     # replicas of the obs CLI's recording


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
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


def device_ms(fn, kernel: str, iters: int = 50) -> tuple[float, dict]:
    """Mean device milliseconds a launch of the kernel whose name contains
    ``kernel``, over ``iters`` calls of ``fn`` (the profiler's device
    events): the kernel's own time, where a loop of calls is bound by the
    host's cost a call. The profiler may miss the first launches after it
    starts (a run once saw 18 of 50 window-query launches right after two
    other profiled loops); the mean is over the events it recorded, at
    least half of them, and a loop where it recorded fewer is measured
    again, up to three times in all. Returns the mean and, for the run's
    output, the loops profiled, the events of each and the calls a loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        events.append(len(spans))
        if iters // 2 <= len(spans) <= iters:
            return sum(spans) / len(spans) / 1e3, {
                "loops": len(events), "events": events, "calls": iters}
    check(False, f"{len(spans)} device events of {kernel} in {iters} calls, "
                 f"in each of three profiled loops")


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


def ptxas_report(logs: dict, kernels) -> list:
    """Registers, stack and spills of each instantiation of the named
    kernels, from ``nvcc -Xptxas -v`` (``_build.build``'s logs), and whether
    ptxas noted that it serialized the kernel's wgmma instructions (its
    "Potential Performance Loss" notes C7510-C7519)."""
    import re

    args_re = re.compile(r"13__nv_bfloat16|f|Li(\d+)E|Lb([01])E")
    out = []
    for log in logs.values():
        serialized = set(re.findall(r"\(C751\d\)[^\n]*?'(\w+)'", log))
        parts = re.split(r"Compiling entry function '(\w+)'", log)
        for fn, body in zip(parts[1::2], parts[2::2]):
            base = next((k for k in kernels if k in fn), None)
            if base is None:
                continue
            tmpl = fn[fn.index(base) + len(base) + 1:].split("EEv")[0] + "E"
            args = [m.group(1) or {"f": "f32", "Lb0E": "false",
                                   "Lb1E": "true"}.get(m.group(0), "bf16")
                    for m in args_re.finditer(tmpl)]
            row = {"kernel": f"{base}<{','.join(args)}>"}
            regs = re.search(r"Used (\d+) registers", body)
            row["registers"] = int(regs.group(1)) if regs else None
            for n, what in re.findall(
                    r"(\d+) bytes (stack frame|spill stores|spill loads)",
                    body):
                row[what.replace(" ", "_")] = int(n)
            row["wgmma_serialized"] = fn in serialized
            out.append(row)
    return out


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a >= end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy


def profile_device(fn, label, track=()):
    """Device busy share and the top device kernels of one call of ``fn``,
    and the device time and launches of each kernel whose name contains one
    of ``track`` (``tracked``), wherever it ranks.

    Only the device's own events count (kernels, copies, memsets): a CPU
    op's self device time repeats the time of the kernels it launched, so
    summing both would count that time twice. Busy time is the union of
    the device events' intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    device_us = busy_us(spans)
    return {"phase": "profile", "of": label, "wall_ms": 1e3 * wall,
            "device_events": len(spans),
            "device_busy_ms": device_us / 1e3 if spans else None,
            "device_busy_share": device_us / 1e6 / wall if spans else None,
            "top_device_ops": [
                {"name": k[:80], "ms": us / 1e3, "calls": n}
                for us, k, n in rows[:10]],
            "tracked": {t: {"ms": sum(us for us, k, _ in rows if t in k) / 1e3,
                            "calls": sum(n for _, k, n in rows if t in k)}
                        for t in track}}


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (1.6e-2 in [2, 4))."""
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def scan_tol(ref, dtype) -> float:
    """Tolerance of a scan kernel's output against its plain version:
    SCAN_F32_TOL of the largest |ref| in f32, one bf16 ulp of it in bf16."""
    top = ref.float().abs().max().item()
    return SCAN_F32_TOL * top if dtype == torch.float32 else bf16_ulp(top)


def decode_tol(ref, dtype):
    """Tolerance of each decode-attention output row [B,H,1]: ATTN_TOL, cut
    to DECODE_F32_TOL of the row's largest |ref| in f32 and to one bf16 ulp
    of it in bf16. A row averages up to 32768 rows of v, so |out| is ~1e-2
    there and the fixed 1.6e-2 alone would pass a kernel that drops keys.
    In f32 the order of the kernel's sums (8 warps of 4096 keys each) moves
    a row by a few 1e-6 of its max, and one key of 32768 by ~1e-4 or more,
    so the rule sees a missed or extra key; check_new_kernels confirms
    that on each run's data."""
    top = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    if dtype == torch.float32:
        scaled = DECODE_F32_TOL * top
    else:
        scaled = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return scaled.clamp_max(ATTN_TOL[dtype])


def dt_bias(n: int, dev):
    """The models' dt biases: log(exp(linspace(1e-3, 1e-1, n)) - 1)."""
    return torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, n, device=dev)))


def ssm_inputs(i, case, dev):
    """Seeded u, dt, A, B, C of a Mamba-1 scan, drawn on the card as
    ``mamba1_forward`` shapes them: dt = softplus(N(0, 0.25) + dt_bias)."""
    _, B, S, di, N, dt = case
    g = torch.Generator(dev).manual_seed(2000 + i)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    import torch.nn.functional as F

    u = randn(B, S, di)
    dtv = F.softplus(0.5 * randn(B, S, di) + dt_bias(di, dev))
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).expand(di, N).contiguous()
    return (u.to(dt), dtv.to(dt), A, randn(B, S, N).to(dt),
            randn(B, S, N).to(dt))


def ssd_inputs(i, case, dev):
    """Seeded x, dt (f32), A (f32), B, C of a Mamba-2 scan, drawn on the
    card as ``mamba2_forward`` shapes them."""
    _, B, S, H, P, N, dt = case
    g = torch.Generator(dev).manual_seed(3000 + i)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    import torch.nn.functional as F

    x = randn(B, S, H, P)
    dtv = F.softplus(randn(B, S, H) + dt_bias(H, dev))
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    return (x.to(dt), dtv.contiguous(), A, randn(B, S, N).to(dt),
            randn(B, S, N).to(dt))


def decode_inputs(i, case, dev):
    """Seeded q [B,H,hd], caches [B,S,K,hd] and pos [B] int32."""
    name, B, H, K, S, hd, dt, *_ = case
    g = torch.Generator(dev).manual_seed(4000 + i)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dt)
    k = torch.randn((B, S, K, hd), generator=g, device=dev, dtype=dt)
    v = torch.randn((B, S, K, hd), generator=g, device=dev, dtype=dt)
    if name.startswith("zamba2-7b"):
        pos = S - 8 + torch.randint(0, 8, (B,), generator=g, device=dev)
    else:
        pos = torch.randint(0, S, (B,), generator=g, device=dev)
        pos[0] = 0
    return q, k, v, pos.to(torch.int32)


def ssm_terms(case) -> dict:
    """The three floors of one selective scan, in ms: its bytes (u, dt, B,
    C, A read and y written once) at the HBM rate; its f32 instructions (a
    state element a step: dt*A, du*B, the fmaf into h and the fmaf into
    y, as the kernel writes them -- and dt*u a channel step) at the CUDA
    cores' instruction rate; and its exps (one ex2 a state element a step)
    at EX2_PER_CLOCK_SM results a clock on each of SMS SMs at the boost
    clock. ``binds`` names the largest."""
    _, B, S, di, N, dt = case
    e = 2 if dt == torch.bfloat16 else 4
    nbytes = 3 * B * S * di * e + 2 * B * S * N * e + di * N * 4
    instructions = B * S * di * (4 * N + 1)
    exps = B * S * di * N
    terms = {
        "bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
        "instructions_ms": 1e3 * instructions / FP32_INSTR_PER_S,
        "exp_ms": 1e3 * exps / (EX2_PER_CLOCK_SM * SMS * BOOST_CLOCK_HZ)}
    return {**terms, "binds": max(terms, key=terms.get)[:-3],
            "bytes": nbytes, "instructions": instructions, "exps": exps}


def ssm_bound(case):
    """(bound ms, bound_by, ops, bytes) of one selective scan: the largest
    of ``ssm_terms``; the instructions and exps are operations."""
    t = ssm_terms(case)
    bound_ms = max(t["bytes_ms"], t["instructions_ms"], t["exp_ms"])
    return (bound_ms, "bytes" if t["binds"] == "bytes" else "operations",
            t["instructions"] + t["exps"], t["bytes"])


def ssd_bound(case):
    """(bound ms, bound_by, ops, bytes) of one SSD scan: x, dt, A, B, C read
    and y written once; the products of the chunked form at the kernel's
    64-row chunks (the causal half of C B^T and of W x, all of C h^T and of
    the state update) at the peak rate of the inputs' type."""
    _, B, S, H, P, N, dt = case
    e = 2 if dt == torch.bfloat16 else 4
    nbytes = 2 * B * S * H * P * e + B * S * H * 4 + H * 4 + 2 * B * S * N * e
    ops = 0
    for t0 in range(0, S, 64):
        q = min(64, S - t0)
        ops += 2 * (q * (q + 1) // 2) * (N + P) + 4 * q * P * N
    ops *= B * H
    rate = BF16_OPS_PER_S if dt == torch.bfloat16 else FP32_OPS_PER_S
    return _bound(ops, rate, nbytes)


def decode_bound(case, pos):
    """(bound ms, bound_by, ops, bytes) of one decode attention: the visible
    keys' rows of k and v read once (this run's pos and window), q read and
    the output written once; q.k and p.v over the visible keys at the
    inputs' peak rate."""
    _, B, H, K, S, hd, dt, window, _ = case
    e = 2 if dt == torch.bfloat16 else 4
    visible = 0
    for p in pos.tolist():
        lo = max(0, p - window + 1) if window > 0 else 0
        visible += min(p, S - 1) - lo + 1
    nbytes = 2 * visible * K * hd * e + 2 * B * H * hd * e + B * 4
    ops = 4 * hd * visible * (H // K) * K
    rate = BF16_OPS_PER_S if dt == torch.bfloat16 else FP32_OPS_PER_S
    return _bound(ops, rate, nbytes)


def _bound(ops, rate, nbytes):
    ops_ms, bytes_ms = 1e3 * ops / rate, 1e3 * nbytes / HBM_BYTES_PER_S
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops, nbytes)


def library_decode(q, k, v, pos):
    """One ``scaled_dot_product_attention`` call computing the same decode
    attention (no window, no softcap, one query head a kv head, so nothing
    is expanded): the caches transposed to [B,K,S,hd] beforehand, outside
    the timed call, and a boolean mask of the visible keys."""
    import torch.nn.functional as F

    B, H, hd = q.shape
    S = k.shape[1]
    if H != k.shape[2]:
        return None
    q4 = q[:, :, None, :]
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    idx = torch.arange(S, device=q.device)
    mask = (idx[None, :] <= pos[:, None].long())[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q4, kt, vt,
                                                  attn_mask=mask)


def fused_place_cases():
    """(name, case) of the ``fused_place`` checks: the fleet's B and a
    ragged one with the hand-built rows first, one replica, a ragged last
    block of 3 warps, a batch whose every row has do = false, and 6
    devices (the kernel built for a device count read at run time)."""
    from repro_torch.kernels.placement import cases

    adv = cases.with_adversarial_rows
    off = adv(cases.random_case(8 * 128 + 3, seed=4))
    off[7][:] = False
    return [("fleet-8192", adv(cases.random_case(B_MAIN, seed=0))),
            ("ragged-37", adv(cases.random_case(37, seed=1))),
            ("one-replica", cases.random_case(1, seed=2, do_rate=1.0)),
            ("ragged-1027", adv(cases.random_case(8 * 128 + 3, seed=3))),
            ("all-do-false-1027", off),
            ("six-devices-37", cases.random_case(37, seed=5, dev=6))]


def to_card(case, dev):
    """Fresh copies of a case's numpy arrays on ``dev``."""
    return [torch.from_numpy(x.copy()).to(dev) for x in case]


def check_fused_place(dev) -> float:
    """Phase 3 for ``fused_place``: every output bit for bit against the
    plain version at each of ``fused_place_cases``. Returns the largest
    absolute difference (0)."""
    from repro_torch.kernels.placement import placement
    from repro_torch.kernels.placement.ref import fused_place_ref

    err = 0.0
    for name, case in fused_place_cases():
        ref = fused_place_ref(*to_card(case, dev))
        ker = placement.fused_place(*to_card(case, dev))
        torch.cuda.synchronize()
        same = [bit_equal(r, k) for r, k in zip(ref, ker)]
        err = max(err, max_abs_err(ref, ker))
        emit({"phase": "kernel", "kernel": "fused_place", "case": name,
              "B": len(case[0]), "outputs_bit_identical": same,
              "max_abs_err": err, "ok_rows": int(ref[3].sum()),
              "dropped": int(ref[8].sum()),
              "use4_rows": int((ref[3] & ref[7]).sum())})
        check(all(same), f"fused_place differs from its plain version "
                         f"in case {name}: {same}")
        if name.startswith("all-do-false"):
            kept = [bit_equal(k, x) for k, x in
                    zip(ker[:3], to_card(case[:3], dev))]
            check(not ker[3].any() and all(kept),
                  f"fused_place committed a do = false row: {kept}")
    return err


def time_fused_place(dev, case=None) -> dict:
    """Phase 10 for ``fused_place`` at the fleet's B (or on ``case``): its
    device time a launch (the profiler's device events) cold, with a 64 MB
    write between the reset of the windows and the launch that evicts them
    from L2 (``ms``, the time held to the HBM bound), and warm, right after
    a reset by a copy that leaves them in L2 as the fleet's consecutive
    attempts do (``ms_warm``); the plain version's time; the bound; and one
    near-empty launch's device time (a one-element ``fill_``), the floor
    under any launch."""
    from repro_torch.kernels.placement import placement
    from repro_torch.kernels.placement.ref import fused_place_ref

    if case is None:
        case = fused_place_cases()[0][1]
    pristine = to_card(case, dev)
    work = [x.clone() for x in pristine]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)

    def reset():
        for w, p in zip(work[:3], pristine[:3]):
            w.copy_(p)

    def warm():
        reset()
        placement.fused_place(*work)

    def cold():
        reset()
        flush.zero_()
        placement.fused_place(*work)

    cold_ms, cold_seen = device_ms(cold, "fused_place_kernel")
    warm_ms, warm_seen = device_ms(warm, "fused_place_kernel")
    one = torch.zeros(1, device=dev)
    empty_ms, empty_seen = device_ms(lambda: one.fill_(1.0), "Fill")
    del flush
    fused_place_ref(*pristine)
    plain_ms = cuda_ms(lambda: fused_place_ref(*pristine), 10)

    ref = fused_place_ref(*pristine)
    t1 = case[0]
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
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    row = {"ms": cold_ms, "ms_warm": warm_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                        else "operations"),
           "library_ms": None}
    emit({"phase": "timing", "kernel": "fused_place", "B": B, **row,
          "device_events": {"cold": cold_seen, "warm": warm_seen},
          "bytes": read + written, "ops": ops,
          "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_ops_ms,
          "cold_share_of_bound": bound_ms / cold_ms,
          "warm_share_of_bound": bound_ms / warm_ms,
          "cold_gb_per_s": (read + written) / cold_ms / 1e6})
    emit({"phase": "timing", "kernel": "empty_launch",
          "what": "a one-element fill_, the device time of a near-empty "
                  "launch", "ms": empty_ms, "device_events": empty_seen})
    return row


def check_new_kernels(dev):
    """Phase 3, the three kernels of the SSM and hybrid paths (and the hd 112
    attention, in ``ATTN_CASES``) against their plain versions on the card.
    Returns the max abs error of each kernel and the decode cases' pos."""
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssm_scan import ssm_scan as ssm
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    errs = {"ssm_scan": 0.0, "ssd_scan": 0.0, "flash_decode": 0.0}
    runs = [("ssm_scan", SSM_CASES, ssm_inputs, ssm.ssm_scan, ssm_scan_ref),
            ("ssd_scan", SSD_CASES, ssd_inputs, ssd.ssd_scan, ssd_scan_ref)]
    for kernel, cases, inputs, ker_fn, ref_fn in runs:
        for i, c in enumerate(cases):
            xs = inputs(i, c, dev)
            ker = ker_fn(*xs)
            torch.cuda.synchronize()
            ref = ref_fn(*xs)
            err = max_abs_err([ref], [ker])
            tol = scan_tol(ref, c[-1])
            errs[kernel] = max(errs[kernel], err)
            emit({"phase": "kernel", "kernel": kernel, "case": c[0],
                  "shape": list(xs[0].shape), "dtype": str(c[-1]),
                  "max_abs_err": err,
                  "max_abs_out": ref.float().abs().max().item(),
                  "tolerance": tol,
                  "finite": bool(torch.isfinite(ker).all())})
            check(ker.dtype == c[-1] and ker.shape == xs[0].shape
                  and bool(torch.isfinite(ker).all()),
                  f"{kernel} gave a bad result in case {c[0]}")
            check(err <= tol, f"{kernel} differs from its plain version in "
                              f"case {c[0]}: {err} > {tol}")
            del xs, ker, ref
    decode_pos = {}
    for i, c in enumerate(DECODE_CASES):
        name, *_, dt, window, cap = c
        q, k, v, pos = decode_inputs(i, c, dev)
        ker = fd.flash_decode(q, k, v, pos, window=window, softcap=cap)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, pos, window=window, softcap=cap)
        err = max_abs_err([ref], [ker])
        tol = decode_tol(ref, dt)
        worst = ((ker.float() - ref.float()).abs() / tol).max().item()
        errs["flash_decode"] = max(errs["flash_decode"], err)
        decode_pos[name] = pos.cpu()
        row = {"phase": "kernel", "kernel": "flash_decode", "case": name,
               "q_shape": list(q.shape), "cache_shape": list(k.shape),
               "dtype": str(dt), "window": window, "softcap": cap,
               "pos": pos.tolist(), "max_abs_err": err,
               "max_abs_out": ref.float().abs().max().item(),
               "tolerance_rows": [tol.min().item(), tol.max().item()],
               "err_over_tolerance": worst,
               "finite": bool(torch.isfinite(ker).all())}
        if dt == torch.float32 and window == 0 and bool((pos > 0).all()):
            # the same rule must see the newest key dropped, in every row
            short = decode_attention_ref(q, k, v, pos - 1, softcap=cap)
            row["one_key_over_tolerance"] = (
                (short - ref).abs().amax(-1, keepdim=True) / tol).min().item()
            check(row["one_key_over_tolerance"] > 1.0,
                  f"flash_decode's tolerance in case {name} cannot see one "
                  f"key: {row['one_key_over_tolerance']}")
            del short
        emit(row)
        check(ker.dtype == dt and ker.shape == q.shape
              and bool(torch.isfinite(ker).all()),
              f"flash_decode gave a bad result in case {name}")
        check(worst <= 1.0, f"flash_decode differs from its plain version "
                            f"in case {name}: {err}, {worst} x its "
                            f"tolerance")
        del q, k, v, ker, ref
    torch.cuda.empty_cache()
    return errs, decode_pos


def counters() -> dict:
    """(wrapper module, counter name) of each kernel, by kernel name: the
    attribute counts its launches."""
    from repro_torch.analysis.fixtures import racy_kernel
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.kernels.placement import placement
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssm_scan import ssm_scan as ssm
    from repro_torch.kernels.window_query import window_query as wq

    return {"fused_place": (placement, "launches"),
            "flash_attention": (fa, "launches"),
            "flash_attention_wgmma": (fa, "launches_wgmma"),
            "flash_attention_simt": (fa, "launches_simt"),
            "flash_decode": (fd, "launches"),
            "flash_decode_split": (fd, "launches_split"),
            "flash_decode_combine": (fd, "launches_combine"),
            "ssd_scan": (ssd, "launches"),
            "ssm_scan": (ssm, "launches"),
            "window_query": (wq, "launches"),
            "window_query_batched": (wq, "launches_batched"),
            "window_query_vec": (wq, "launches_vec"),
            "window_query_scalar": (wq, "launches_scalar"),
            "racy_sum": (racy_kernel, "launches")}


def reset_counts():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in counters().items()}


def nonzero_counts() -> dict:
    return {k: v for k, v in counts().items() if v}


def timed(fn):
    """(result, host seconds) of ``fn`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def model_path(arch: str, dev, want_fwd: dict, want_step: dict,
               decode_batch: int, cache_len: int, seed: int) -> dict:
    """Phases 7 and 8: the full config of ``arch`` (bf16, random weights
    from ``seed``, drawn on the card): one forward of 1 x SEQ tokens, then
    DECODE_STEPS decode steps from a state of ``init_decode_state(
    decode_batch, cache_len)`` whose caches are filled from a seed and whose
    pos is ``cache_len - DECODE_STEPS``. Checks each kernel's launches
    against ``want_fwd`` (a forward) and ``want_step`` (a decode step), and
    the logits' shape and finiteness. Returns the counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    model, build_s = timed(lambda: Model(cfg, seed=seed, device=dev,
                                         init_device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(dev).manual_seed(seed + 100)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=g,
                           device=dev)
    batch = {"tokens": tokens}
    with torch.no_grad():
        model({"tokens": tokens[:, :cfg.ssm_chunk]})     # warm-up
        reset_counts()
        (logits, _), fwd_s = timed(lambda: model(batch))
    fwd_counts = counts()
    check(tuple(logits.shape) == (1, SEQ, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch}: bad forward logits {tuple(logits.shape)}")
    for name, n in want_fwd.items():
        check(fwd_counts[name] == n, f"{arch}: {name} launched "
                                     f"{fwd_counts[name]} times a forward, "
                                     f"not {n}")
    del logits

    def forward():
        with torch.no_grad():
            model(batch)

    fwd_profile = profile_device(forward, f"{arch} forward")

    state = model.init_decode_state(decode_batch, cache_len)
    for key in ("k", "v"):
        if key in state:
            state[key].normal_(generator=g)
    state["pos"].fill_(cache_len - DECODE_STEPS)
    tok = torch.randint(0, cfg.vocab_size, (decode_batch,), generator=g,
                        device=dev)
    reset_counts()
    step_s = []
    with torch.no_grad():
        for step in range(DECODE_STEPS - 1):
            (lg, state), s_ = timed(lambda: model.decode_step(state, tok))
            step_s.append(s_)
            check(tuple(lg.shape) == (decode_batch, cfg.vocab_size)
                  and bool(torch.isfinite(lg).all()),
                  f"{arch}: bad decode logits at step {step}")
            tok = lg.argmax(-1)
        step_profile = profile_device(
            lambda: model.decode_step(state, tok), f"{arch} decode step")
    step_counts = counts()
    check(int(state["pos"][0]) == cache_len,
          f"{arch}: pos {int(state['pos'][0])} after {DECODE_STEPS} steps")
    for name, n in want_step.items():
        check(step_counts[name] == n * DECODE_STEPS,
              f"{arch}: {name} launched {step_counts[name]} times in "
              f"{DECODE_STEPS} decode steps, not {n} a step")
    out = {"phase": f"{cfg.arch_type}_path", "arch": arch,
           "params": n_params, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "build_s": build_s, "forward_tokens": [1, SEQ],
           "forward_ms": 1e3 * fwd_s, "forward_launches": fwd_counts,
           "decode_batch": decode_batch, "decode_cache_len": cache_len,
           "decode_step_ms": [1e3 * x for x in step_s],
           "decode_launches": step_counts,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "reduced": [f"forward B 1 x S {SEQ} (source shape "
                       "PREFILL_32K: B 32 x S 32768), for the time limit",
                       f"decode batch {decode_batch} (source DECODE_32K: "
                       "batch 128)" if decode_batch != 128 else
                       "decode at DECODE_32K's batch 128"]}
    emit(out)
    emit({**fwd_profile, "of": f"{arch} forward, 1 x {SEQ}"})
    emit({**step_profile, "of": f"{arch} decode step, batch {decode_batch}"})
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"forward": fwd_counts, "decode": step_counts}


def model_plain_paths(dev):
    """Phase 9: each model built twice from one seed, on the kernels and on
    their plain versions, at full width and cut depth; logits within
    MODEL_TOL of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model

    rows = []
    for arch, n_layers in (("zamba2-7b", 13), ("falcon-mamba-7b", 4)):
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        g = torch.Generator(dev).manual_seed(11)
        tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=g,
                               device=dev)
        step_tokens = torch.randint(0, cfg.vocab_size, (4, 2), generator=g,
                                    device=dev)
        logits, secs = {}, {}
        for backend in ("auto", "ref"):
            model = Model(cfg, seed=7, device=dev, backend=backend,
                          init_device=dev)
            with torch.no_grad():
                (fwd, _), secs[backend] = timed(
                    lambda: model({"tokens": tokens}))
                out = [fwd.float()]
                if cfg.arch_type == "hybrid":
                    state = model.init_decode_state(2, 4096)
                    sg = torch.Generator(dev).manual_seed(12)
                    state["k"].normal_(generator=sg)
                    state["v"].normal_(generator=sg)
                    state["pos"].fill_(4096 - 4)
                    for tk in step_tokens:
                        lg, state = model.decode_step(state, tk)
                        out.append(lg.float())
                    del state
            logits[backend] = out
            del model
            gc.collect()
            torch.cuda.empty_cache()
        rel = [(a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(logits["auto"], logits["ref"])]
        row = {"phase": "model_plain_path", "arch": arch,
               "layers": n_layers, "tokens": [2, 512],
               "decode_steps": len(rel) - 1,
               "logits_err_over_max": rel, "tolerance": MODEL_TOL,
               "kernel_path_s": secs["auto"], "plain_path_s": secs["ref"]}
        emit(row)
        check(max(rel) <= MODEL_TOL,
              f"{arch}: kernel and plain logits differ: {rel}")
        rows.append(row)
    return rows


def time_new_kernels(dev, errs, decode_pos):
    """Phase 10 for the SSM and hybrid paths' kernels, at their main
    shapes: ms a launch, the plain version's ms, the bound and, for
    flash_decode, SDPA's ms."""
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssm_scan import ssm_scan as ssm
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    rows = {}
    for kernel, case, inputs, ker_fn, ref_fn, bound in (
            ("ssm_scan", SSM_CASES[0], ssm_inputs, ssm.ssm_scan,
             ssm_scan_ref, ssm_bound),
            ("ssd_scan", SSD_CASES[0], ssd_inputs, ssd.ssd_scan,
             ssd_scan_ref, ssd_bound)):
        xs = inputs(0, case, dev)
        bound_ms, bound_by, ops, nbytes = bound(case)
        ms = time_ms(lambda: ker_fn(*xs))
        rows[kernel] = {
            "case": case[0], "ms": ms,
            "plain_ms": time_ms(lambda: ref_fn(*xs), budget_ms=1.0),
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
            "share_of_bound": bound_ms / ms,
            "library_ms": None,
            "library_none_because": "no single PyTorch call computes a "
                                    "selective or SSD scan",
            "max_abs_err": errs[kernel]}
        if kernel == "ssm_scan":
            rows[kernel]["bound_terms"] = ssm_terms(case)
        emit({"phase": "timing", "kernel": kernel, **rows[kernel]})
        del xs
    for i, case in enumerate(DECODE_CASES):
        name, B, H, K, S, *_ = case
        q, k, v, pos = decode_inputs(i, case, dev)
        check(torch.equal(pos.cpu(), decode_pos[name]),
              "decode inputs are not reproducible")
        kw = dict(window=case[-2], softcap=case[-1])
        bound_ms, bound_by, ops, nbytes = decode_bound(case, pos)
        call = lambda: fd.flash_decode(q, k, v, pos, **kw)
        ms = time_ms(call)
        row = {"case": name, "ms": ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "ops": ops, "bytes": nbytes,
               "gb_per_s": nbytes / ms / 1e6, "share_of_bound": bound_ms / ms,
               "n_split": fd.n_split(B, K, S),
               "chunk": fd.chunk_size(B, K, S)}
        if i == 0:   # the main shape: its plain version and SDPA
            lib = library_decode(q, k, v, pos)
            row.update({
                "plain_ms": time_ms(lambda: decode_attention_ref(q, k, v,
                                                                 pos)),
                "library_ms": time_ms(lib) if lib is not None else None,
                "library_call": "scaled_dot_product_attention, boolean "
                                "mask, caches transposed to [B,K,S,hd] "
                                "outside the timed call, GQA not expanded "
                                "(G = 1)",
                "max_abs_err": errs["flash_decode"]})
            rows["flash_decode"] = row
            del lib
        emit({"phase": "timing", "kernel": "flash_decode", **row})
        del q, k, v
    # the two passes' device times at the main shape, from the profiler, last:
    # once it has run, every later launch costs the host more
    q, k, v, pos = decode_inputs(0, DECODE_CASES[0], dev)
    call = lambda: fd.flash_decode(q, k, v, pos)
    passes = {}
    for part in ("split", "combine"):
        ms, seen = device_ms(call, f"flash_decode_{part}_kernel")
        passes.update({f"{part}_ms": ms, f"{part}_device_events": seen})
    rows["flash_decode"].update(passes)
    emit({"phase": "timing", "kernel": "flash_decode",
          "case": DECODE_CASES[0][0], **passes})
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def loaded_ras(n_dev=4, n_tasks=24, seed=0):
    """A RASScheduler of the port loaded as the reference's
    ``benchmarks/bench_query.py`` loads one: 12 LP requests of 2 tasks."""
    import numpy as np

    from repro_torch.core.scheduler import RASScheduler
    from repro_torch.core.tasks import LPRequest, Priority, Task

    s = RASScheduler(n_dev, 20e6, seed=seed)
    rng = np.random.default_rng(seed)
    for i in range(n_tasks // 2):
        t = float(rng.uniform(0, 60))
        req = LPRequest(
            [Task(Priority.LOW, i % n_dev, t, t + 80.0, 0) for _ in range(2)],
            i % n_dev, t)
        s.schedule_lp(req, t)
    return s


def bench_query_lists(reps: int = 256):
    """The LP2 lists of ``loaded_ras()``'s 4 devices repeated ``reps``
    times, as the reference's query benchmark builds its 1024 devices:
    t1, t2 [4·reps, T, W] f32 (``inf`` in unused slots) and valid bool,
    numpy arrays on the host."""
    import numpy as np

    from repro_torch.core.tasks import LP2_CONFIG

    arrs = [d.list_for(LP2_CONFIG).to_arrays() for d in loaded_ras().devices]
    return [np.repeat(np.stack([a[k] for a in arrs]), reps, axis=0)
            for k in ("t1", "t2", "valid")]


def random_windows(lead, T, W, seed, dev):
    """Seeded windows: t1 in [0, 100), t2 = t1 + [1, 50), 70% valid."""
    g = torch.Generator().manual_seed(seed)
    shape = (*lead, T, W)
    t1 = torch.rand(shape, generator=g) * 100
    t2 = t1 + 1 + torch.rand(shape, generator=g) * 49
    valid = torch.rand(shape, generator=g) < 0.7
    return t1.to(dev), t2.to(dev), valid.to(dev)


def wq_cases(dev):
    """(case, entry, route, inputs) of every window-query case, on ``dev``:
    ``route`` is the kernel route the case must take."""
    bench = [torch.from_numpy(x).to(dev) for x in bench_query_lists()]
    out = [("bench_query-1024dev", "window_query", "vec",
            (*bench, *BENCH_QUERY))]
    for name, n, T, W, seed, route in (
            ("ragged-300dev", 300, 2, 16, 1, "vec"),
            ("large-262144dev", 262_144, 2, 16, 2, "vec"),
            ("t1xw15-4096dev", 4096, 1, 15, 7, "scalar")):
        out.append((name, "window_query", route,
                    (*random_windows((n,), T, W, seed, dev), *WQ_SCALARS)))
    g = torch.Generator().manual_seed(4)

    def rand(*shape, lo=0.0, span=1.0):
        return (lo + span * torch.rand(shape, generator=g)).to(dev)

    # per-row parameters, and a fifth of the windows ending exactly at
    # start + dur: the <= decides them
    t1, t2, valid = random_windows((B_MAIN, 4), 2, 16, 3, dev)
    q1 = rand(B_MAIN, 4, span=60.0)
    dl = q1 + rand(B_MAIN, 4, lo=10.0, span=70.0)
    dur = rand(B_MAIN, 4, lo=1.0, span=29.0)
    tie = rand(*t1.shape) < 0.2
    t2 = torch.where(tie, torch.maximum(t1, q1[..., None, None])
                     + dur[..., None, None], t2)
    out.append(("batched-8192x4", "window_query_batched", "vec",
                (t1, t2, valid | tie, q1, dl, dur)))
    # the fleet's HP query of device 1: [B,1,T,W] views of [B,4,3,2,16]
    # windows and a strided column of min_dur, read in place
    w1, w2, wv = random_windows((B_MAIN, 4, 3), 2, 16, 5, dev)
    now = rand(B_MAIN, span=100.0)
    min_dur = rand(B_MAIN, 3, lo=0.5, span=3.0)
    hp = slice(1, 2)
    out.append(("fleet-hp-view-8192", "window_query_batched", "vec",
                (w1[:, hp, 0], w2[:, hp, 0], wv[:, hp, 0], now[:, None],
                 (now + 3.0)[:, None], min_dur[:, :1])))
    out.append(("ragged-3x6", "window_query_batched", "vec",
                (*random_windows((3, 6), 2, 16, 6, dev),
                 *(torch.full((3, 6), v, device=dev) for v in WQ_SCALARS))))
    # windows one element into their storage: no row starts 16-byte aligned
    shape = (2048, 4, 2, 16)
    flat = random_windows((math.prod(shape) + 1,), 1, 1, 8, dev)
    q1 = rand(*shape[:2], span=60.0)
    out.append(("offset-by-one-2048x4", "window_query_batched", "scalar",
                (*(x.reshape(-1)[1:].view(shape) for x in flat), q1,
                 q1 + rand(*shape[:2], lo=10.0, span=70.0),
                 rand(*shape[:2], lo=1.0, span=29.0))))
    return out


def wq_bound(xs, batched: bool):
    """(bound ms, bound_by, ops, bytes) of one window query: each window's
    t1, t2 and valid read once (9 bytes), the batched form's 3 parameters
    a row, start and found written once (8 bytes a row); about 6
    operations a window (max, add, min, compare, and, min) at the f32
    rate."""
    rows, tw = xs[0].shape[:-2].numel(), xs[0].shape[-2:].numel()
    nbytes = rows * (9 * tw + (12 if batched else 0) + 8)
    return _bound(6 * rows * tw, FP32_OPS_PER_S, nbytes)


def wq_fns() -> dict:
    """(kernel wrapper, plain version) of each window-query entry."""
    from repro_torch.kernels.window_query import window_query as wq
    from repro_torch.kernels.window_query.ref import (
        window_query_batched_ref, window_query_ref,
    )

    return {"window_query": (wq.window_query, window_query_ref),
            "window_query_batched": (wq.window_query_batched,
                                     window_query_batched_ref)}


def time_wq_case(entry, xs, flush) -> dict:
    """The timing row of one window-query case: the kernel's device time a
    launch cold, after ``flush.zero_()`` (a 64 MB write that evicts L2),
    and warm; the wrapper's and the plain version's time a call in a loop
    of calls; the byte bound and the share of it cold and warm."""
    ker_fn, ref_fn = wq_fns()[entry]
    bound_ms, bound_by, ops, nbytes = wq_bound(xs, entry != "window_query")

    def cold():
        flush.zero_()
        ker_fn(*xs)

    cold_ms, cold_seen = device_ms(cold, "window_query_kernel")
    warm_ms, warm_seen = device_ms(lambda: ker_fn(*xs), "window_query_kernel")
    return {"ms": cold_ms, "ms_warm": warm_ms,
            "device_events": {"cold": cold_seen, "warm": warm_seen},
            "call_ms": time_ms(lambda: ker_fn(*xs)),
            "plain_ms": time_ms(lambda: ref_fn(*xs)),
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bytes": nbytes, "share_of_bound": bound_ms / cold_ms,
            "warm_share_of_bound": bound_ms / warm_ms,
            "gb_per_s": nbytes / cold_ms / 1e6, "library_ms": None}


def window_query_phase(dev):
    """Phase 3 for the window-query kernels: each against its plain version,
    bit for bit, at every case; then the window-query path through
    ``window_query_op``. Returns each case's row by kernel name, and the
    path's launch counts (in all and by route)."""
    from repro_torch.kernels.window_query import window_query as wq
    from repro_torch.kernels.window_query.ops import window_query_op
    from repro_torch.kernels.window_query.ref import window_query_ref

    fns = wq_fns()
    rows = {name: [] for name in fns}
    for case, entry, route, xs in wq_cases(dev):
        ker_fn, ref_fn = fns[entry]
        reset_counts()
        ker = ker_fn(*xs)
        torch.cuda.synchronize()
        n = counts()
        ref = ref_fn(*xs)
        same = [bit_equal(k, r) for k, r in zip(ker, ref)]
        routes = {r: n[f"window_query_{r}"] for r in wq.ROUTES}
        row = {"case": case, "route": route, "shape": list(xs[0].shape),
               "strided": not xs[0].is_contiguous(),
               "route_launches": routes, "outputs_bit_identical": same,
               "max_abs_err": max_abs_err(ref, ker),
               "found_rows": int(ref[0].sum()), "rows": ref[0].numel()}
        emit({"phase": "kernel", "kernel": entry, **row})
        check(all(same), f"{entry} differs from its plain version in case "
                         f"{case}: {same}")
        want = {r: int(r == route) for r in wq.ROUTES}
        check(routes == want, f"{entry} case {case} took the routes "
                              f"{routes}, not {want}")
        rows[entry].append(row)
        del ker, ref

    # the window-query path: the reference benchmark's §IV.B.2 query
    t1, t2, valid = bench_query_lists()
    on_card = [torch.from_numpy(x).to(dev) for x in (t1, t2, valid)]
    reset_counts()
    found, start = window_query_op(*on_card, *BENCH_QUERY)
    torch.cuda.synchronize()
    n = counts()
    host = window_query_ref(*map(torch.from_numpy, (t1, t2, valid)),
                            *BENCH_QUERY)
    same = [bit_equal(a.cpu(), b) for a, b in zip((found, start), host)]
    emit({"phase": "window_query_path", "entry": "window_query_op",
          "devices": t1.shape[0], "windows": list(t1.shape[1:]),
          "query": BENCH_QUERY, "launches": n["window_query"],
          "vec_launches": n["window_query_vec"],
          "found": int(found.sum()), "equal_to_host_plain_version": same})
    check(n["window_query"] == 1 == n["window_query_vec"],
          f"window_query_op launched the kernel {n['window_query']} times "
          f"({n['window_query_vec']} on the vector route), not once")
    check(all(same), "the window-query path differs from the plain version "
                     "on the host")
    return rows, {"all": n["window_query"],
                  **{r: n[f"window_query_{r}"] for r in wq.ROUTES}}


def time_window_query(dev, rows):
    """Phase 10 for the window-query kernels, at every case: the kernel's
    device time a launch (the profiler's device events) cold, each launch
    after a 64 MB write that evicts L2 (``ms``, the time held to the byte
    bound), and warm, its inputs left in L2 by the launch before
    (``ms_warm``: the fleet's HP view is in L2 after the tick's previous
    ``fused_place``); ``call_ms`` and ``plain_ms`` a call of the wrapper and
    of the plain version in a loop of calls (CUDA events; the host's cost a
    call bounds both at these sizes); and the host's cost of the fleet's HP
    query split into parts (``wq_host_split``). It runs after the main
    paths: once the profiler has run, every later launch costs the host
    more. Returns each kernel's kernels-line row, at its main case (whose
    route is ``main_case_route``: ``route`` of the line is the kernel's
    build route)."""
    done = {name: iter(r) for name, r in rows.items()}
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    for case, entry, route, xs in wq_cases(dev):
        row = next(done[entry])
        row.update(time_wq_case(entry, xs, flush))
        emit({"phase": "timing", "kernel": entry, **row})
        if case == "fleet-hp-view-8192":
            emit({"phase": "host_split", "kernel": entry, "case": case,
                  **wq_host_split(dev, xs)})
    del flush
    main = {"window_query": "bench_query-1024dev",
            "window_query_batched": "fleet-hp-view-8192"}
    keys = ("case", "route", "ms", "ms_warm", "call_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    out = {}
    for name, cases in rows.items():
        top = next(c for c in cases if c["case"] == main[name])
        out[name] = {
            **{k: top[k] for k in keys if k != "route"},
            "main_case_route": top["route"],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "library_none_because": "no single PyTorch call computes the "
                                    "masked min-reduce and its found flag",
            "cases": [{k: c[k] for k in (*keys, "share_of_bound")}
                      for c in cases]}
    return out


def host_us(fns: dict, iters: int = 1000, repeats: int = 5) -> dict:
    """Host microseconds a call of each of ``fns`` (by name): the least
    mean over ``repeats`` loops of ``iters`` calls, the functions' loops
    taken in turn so that each meets the same load (the host clock, no
    synchronisation inside a loop: launches of a few µs of device time a
    call never fill the queue; the least, since other work on a shared
    host only adds to a loop)."""
    best = dict.fromkeys(fns, math.inf)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(repeats):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best[name] = min(best[name], time.perf_counter() - t0)
            torch.cuda.synchronize()
    return {name: 1e6 * secs / iters for name, secs in best.items()}


def wq_host_split(dev, xs) -> dict:
    """The host's cost of one call of ``window_query_batched_op`` on the
    fleet's HP view ``xs``, as ``fleet/engine.py::_hp_query`` passes it, in
    µs a call, and of each part of it timed alone: the dispatcher's own
    share (the op less the wrapper), the wrapper's window and parameter
    checks, its two ``torch.empty``, the pointers and strides, the route,
    the stream (with the check of the current device), and the ctypes call
    (which launches the kernel); ``other`` is the wrapper less its parts."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.window_query import ops
    from repro_torch.kernels.window_query import window_query as wq

    t1, t2, valid, q1, dl, dur = xs
    B, Dev, T, W = t1.shape
    dev = t1.device               # the wrapper's device, with its index
    kern = "window_query_batched"
    lib = wq._lib()
    params = [ops._param(x, (B, Dev), dev) for x in (q1, dl, dur)]
    start = torch.empty((B, Dev), dtype=torch.float32, device=dev)
    found = torch.empty((B, Dev), dtype=torch.int32, device=dev)
    tensors = (t1, t2, valid, *params)

    def window_checks():
        wq._check_windows(kern, t1, t2, valid, 2)

    def param_checks():
        for name, x in zip(("q1", "deadline", "dur"), params):
            _build.check_strided(kern, name, x, torch.float32, (B, Dev), dev,
                                 inner=0)

    def outputs():
        torch.empty((B, Dev), dtype=torch.float32, device=dev)
        torch.empty((B, Dev), dtype=torch.int32, device=dev)

    def pointers_strides():
        return ([x.data_ptr() for x in tensors],
                [x.stride() for x in tensors])

    ptrs, strides = pointers_strides()

    def stream():
        dev.index == torch.cuda.current_device()
        return torch._C._cuda_getCurrentRawStream(dev.index)

    args = (*ptrs, start.data_ptr(), found.data_ptr(), B, Dev, T * W,
            *(s for st in strides for s in st[:2]), wq.BIG, 1,
            *wq.launch_grid(B * Dev, T * W), stream())
    parts = {"window_checks": window_checks, "param_checks": param_checks,
             "outputs": outputs, "pointers_strides": pointers_strides,
             "route": lambda: wq._route(t1.shape, ptrs, strides),
             "stream": stream,
             "ctypes_launch": lambda: lib.window_query_batched_launch(*args)}
    us = host_us({"op": lambda: ops.window_query_batched_op(*xs),
                  "wrapper": lambda: wq.window_query_batched(*tensors),
                  **parts})
    us["dispatcher"] = us["op"] - us["wrapper"]
    us["other"] = us["wrapper"] - sum(us[k] for k in parts)
    return {"us": us, "iters": 1000, "least_of_loops": 5}


def single_controller_phase(dev):
    """Phase 11: ``hp_place`` on every device and ``lp_place`` of 4 tasks
    (lp2 and lp4) from one loaded scheduler, on the card and on the host:
    every output and state leaf bit for bit; ms a call on each."""
    from repro_torch.core.tensor_state import (
        CFG_INDEX, export_state, hp_place, lp_place,
    )

    sched = loaded_ras()
    calls = [(hp_place, (d, 35.0), {"cfg_idx": 0}) for d in range(4)]
    calls += [(lp_place, (src, 30.0, 90.0),
               {"cfg_idx": CFG_INDEX[c], "n_tasks": 4})
              for c in ("lp2", "lp4") for src in (0, 3)]

    def leaves(out):
        *head, state = out
        return [*head, *state]

    outs, ms = {}, {}
    for where in ("cpu", dev):
        st = export_state(sched, device=where)
        outs[where] = [leaves(fn(st, *a, **kw)) for fn, a, kw in calls]
        for fn in (hp_place, lp_place):
            fn_calls = [c for c in calls if c[0] is fn]
            _, secs = timed(lambda: [fn(st, *a, **kw)
                                     for _ in range(5)
                                     for _, a, kw in fn_calls])
            ms[f"{fn.__name__}_{torch.device(where).type}"] = (
                1e3 * secs / (5 * len(fn_calls)))
    diff = [i for i, (a, b) in enumerate(zip(outs["cpu"], outs[dev]))
            if not all(bit_equal(x, y.cpu()) for x, y in zip(a, b))]
    placed = sum(int(o[1].sum()) for o in outs["cpu"][4:])
    emit({"phase": "single_controller", "calls": len(calls),
          "differing_calls": diff, "lp_tasks_placed": placed,
          "hp_found": sum(int(o[0]) for o in outs["cpu"][:4]),
          "ms_per_call": ms})
    check(not diff, f"hp_place/lp_place differ between card and host in "
                    f"calls {diff}")
    check(placed > 0, "lp_place placed nothing")


def fixture_phase(dev):
    """Phase 12: the launch checker's racy fixture on the card, the
    checker's verdicts, and the fixture's timing. Returns its kernels-line
    row."""
    from repro_torch.analysis import launch_check
    from repro_torch.analysis.fixtures import racy_kernel as rk

    n = RACY_N
    x = torch.arange(1, 2 * n + 1, dtype=torch.float32, device=dev)
    reset_counts()
    out = rk.racy_sum(x)
    torch.cuda.synchronize()
    launches = counts()["racy_sum"]
    w0, w1 = x[:n], x[n:] * 2.0          # block 0's and block 1's values
    from0, from1 = int((out == w0).sum()), int((out == w1).sum())
    # the distance of each output to the nearer writer's value
    err = torch.minimum((out - w0).abs(), (out - w1).abs()).max().item()
    differs = not torch.equal(out, rk.racy_sum_oracle(x))
    race = launch_check.check_geometry(rk.race_geometry(n)[0])
    report = launch_check.check_all()
    bound_ms, bound_by, ops, nbytes = _bound(2 * n, FP32_OPS_PER_S, 12 * n)
    ms, seen = device_ms(lambda: rk.racy_sum(x), "racy_sum_kernel")
    row = {"case": f"n{n}", "ms": ms, "device_events": seen,
           "call_ms": time_ms(lambda: rk.racy_sum(x)),
           "plain_ms": time_ms(lambda: rk.racy_sum_ref(x)),
           "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
           "bytes": nbytes, "library_ms": None,
           "library_none_because": "a racy fixture; no PyTorch call races",
           "max_abs_err": err,
           "max_abs_err_is": "each output's distance to the nearer of the "
                             "two writers' values: the result is undefined "
                             "by design"}
    emit({"phase": "fixture", "kernel": "racy_sum", "outputs": n,
          "launches": launches, "from_block_0": from0,
          "from_block_1": from1, "differs_from_oracle": differs,
          "race_flagged": [str(v) for v in race],
          "production_registry": {k: report[k] for k in
                                  ("ok", "n_kernels", "n_violations")},
          **row})
    check(launches == 1, f"racy_sum launched {launches} times, not once")
    check(from0 + from1 == n and err == 0.0,
          "racy_sum wrote a value that neither block computed")
    check(differs, "racy_sum's output equals a correct reduction")
    check([v.kind for v in race] == ["write-race"],
          f"the checker did not flag racy_sum's launch: {race}")
    check(report["ok"] and report["n_kernels"] >= 6,
          f"the production launch registry is not clean: "
          f"{report['violations']}")
    return row, launches


def fleet_launches(n_frames: int) -> dict:
    """The nonzero launch counters of a fleet run of ``n_frames`` ticks
    through the kernels: 21 placements and 4 HP queries a tick, every HP
    query on the vector route."""
    return {"fused_place": FUSED_PER_TICK * n_frames,
            "window_query_batched": HP_QUERIES_PER_TICK * n_frames,
            "window_query_vec": HP_QUERIES_PER_TICK * n_frames}


def flatten(d: dict, prefix: str = "") -> dict:
    """A nested dict's leaves keyed by their dotted paths."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def calibration_phase(dev):
    """Phase 13: the serial DES's RAS / WPS / HYB frame-completion rates
    (host Python, each run timed); then the committed calibration grid
    (``baseline.json``'s ``generated_from``) through ``run_calibration`` on
    the card: 21 placement and 4 HP-query launches a tick at every point,
    the report inside the committed bands and equal, key by key, to the
    plain path's (``placement_backend="ref"``, no launch). Each fleet point
    is timed alone and one is profiled. Returns the grid's report and its
    launch counts."""
    from repro_torch.calib import (
        CalibConfig, check_report, load_baseline, run_calibration,
    )
    from repro_torch.calib.gate import _cell_tolerances
    from repro_torch.calib.harness import _fleet_point, hash_cell
    from repro_torch.fleet import FleetParams
    from repro_torch.sim.engine import ExperimentConfig, run_experiment

    baseline = load_baseline(str(BASELINE))
    grid = baseline["generated_from"]
    cfg = CalibConfig(scenarios=tuple(grid["scenarios"]),
                      congestion_levels=tuple(grid["congestion_levels"]),
                      n_seeds=grid["n_seeds"], n_frames=grid["n_frames"],
                      n_devices=grid["n_devices"])
    seeds = tuple(range(cfg.base_seed, cfg.base_seed + cfg.n_seeds))

    rates, serial_s = {}, []
    for sched in SERIAL_SCHEDULERS:
        for trace in SERIAL_TRACES:
            for duty in cfg.congestion_levels:
                fc = []
                for seed in seeds:
                    t0 = time.perf_counter()
                    m = run_experiment(ExperimentConfig(
                        scheduler=sched, trace=trace, n_frames=cfg.n_frames,
                        n_devices=cfg.n_devices, duty_cycle=duty, seed=seed))
                    serial_s.append(time.perf_counter() - t0)
                    fc.append(m.frame_completion_rate)
                rates[f"{sched} {trace}@{duty:g}"] = sum(fc) / len(fc)
    serial_s.sort()
    emit({"phase": "calibration_serial", "entry": "run_experiment",
          "frames": cfg.n_frames, "seeds": list(seeds),
          "frame_completion_rate_mean_over_seeds": rates,
          "runs": len(serial_s), "host_s_per_run": {
              "min": serial_s[0], "median": serial_s[len(serial_s) // 2],
              "max": serial_s[-1]}})
    check(all(0.0 < r <= 1.0 for r in rates.values()),
          f"serial frame-completion rates out of range: {rates}")

    n_points = len(cfg.scenarios) * len(cfg.congestion_levels)
    want_point = fleet_launches(cfg.n_frames)
    torch.cuda.synchronize()
    reset_counts()
    report, wall = timed(lambda: run_calibration(cfg, device=dev))
    grid_counts = nonzero_counts()
    ok, failures = check_report(report, baseline)
    tightest = min(
        (tol - abs(point["delta"][m]), c, m)
        for c, point in report["cells"].items()
        for m, tol in _cell_tolerances(c, baseline).items()
        if m in point["delta"])

    point_ms, point_counts, point_differs = {}, {}, []
    for scen in cfg.scenarios:
        for cong in cfg.congestion_levels:
            cell = f"{scen}@{cong:g}"
            reset_counts()
            view, secs = timed(lambda: _fleet_point(
                scen, cong, cfg.n_frames, cfg.n_devices, seeds,
                cfg.fleet_params(), dev))
            point_ms[cell] = 1e3 * secs
            point_counts[cell] = nonzero_counts()
            if ({k: round(v, 4) for k, v in view.items()}
                    != report["cells"][cell]["fleet"]):
                point_differs.append(cell)
    busy = profile_device(lambda: _fleet_point(
        cfg.scenarios[0], cfg.congestion_levels[0], cfg.n_frames,
        cfg.n_devices, seeds, cfg.fleet_params(), dev),
        f"calibration fleet point {cfg.scenarios[0]}@"
        f"{cfg.congestion_levels[0]:g}")

    plain_cfg = dataclasses.replace(cfg, params=FleetParams(
        n_devices=cfg.n_devices, placement_backend="ref"))
    torch.cuda.synchronize()
    reset_counts()
    plain, plain_wall = timed(lambda: run_calibration(plain_cfg, device=dev))
    plain_counts = nonzero_counts()
    flat_k, flat_p = flatten(report), flatten(plain)
    differing = sorted(k for k in flat_k.keys() | flat_p.keys()
                       if flat_k.get(k) != flat_p.get(k))

    ms = sorted(point_ms.values())
    emit({"phase": "calibration", "entry": "run_calibration",
          "grid": report["_config"], "points": n_points,
          "replicas_a_point": len(seeds),
          "burst_seed_of": {s: hash_cell(s) for s in cfg.scenarios},
          "grid_seconds": wall, "plain_grid_seconds": plain_wall,
          "fleet_point_ms": point_ms,
          "fleet_point_ms_min_median_max": [ms[0], ms[len(ms) // 2], ms[-1]],
          "fleet_point_ms_per_tick_median": ms[len(ms) // 2] / cfg.n_frames,
          "fleet_point_device_busy_share": busy["device_busy_share"],
          "fleet_point_device_busy_ms": busy["device_busy_ms"],
          "fleet_point_profiled_wall_ms": busy["wall_ms"],
          "launches": grid_counts, "plain_launches": plain_counts,
          "gate_ok": ok, "gate_failures": failures,
          "tightest_margin": {
              "cell": tightest[1], "metric": tightest[2],
              "delta": report["cells"][tightest[1]]["delta"][tightest[2]],
              "band_minus_abs_delta": tightest[0]},
          "plain_report_differs": differing,
          "max_abs_delta": {c: p["max_abs_delta"]
                            for c, p in report["cells"].items()},
          "fleet_frame_completion_rate": {
              c: p["fleet"]["frame_completion_rate"]
              for c, p in report["cells"].items()},
          "serial_frame_completion_rate": {
              c: p["serial"]["frame_completion_rate"]
              for c, p in report["cells"].items()}})
    check(grid_counts == {k: n_points * v for k, v in want_point.items()},
          f"the calibration grid launched {grid_counts}, not {n_points} x "
          f"{want_point}")
    bad = {c: n for c, n in point_counts.items() if n != want_point}
    check(not bad, f"calibration points launched {bad}, not {want_point}")
    check(not point_differs, f"fleet points alone differ from the grid's "
                             f"report at {point_differs}")
    check(ok, f"the calibration fails the committed baseline: {failures}")
    check(plain_counts == {}, f"the plain calibration launched "
                              f"{plain_counts}")
    check(not differing, f"kernel and plain calibration reports differ in "
                         f"{differing}")
    return report, grid_counts


def fleet_leaves(state, stats) -> list:
    """Every state leaf and counter of a fleet run, in a fixed order."""
    return [*state.sched, *state[1:], *stats]


def fleet_leaf_names() -> list:
    from repro_torch.core.tensor_state import SchedState
    from repro_torch.fleet import FleetState, FleetStats

    return ([f"sched.{f}" for f in SchedState._fields]
            + list(FleetState._fields[1:]) + list(FleetStats._fields))


def differing_leaves(want, got) -> list:
    return [n for n, a, b in zip(fleet_leaf_names(), want, got)
            if not bit_equal(a, b)]


def differing_series(rec_a, rec_b, rows=None) -> list:
    """Series of two telemetry records that differ bit for bit (``rows``
    picks rows of ``rec_a``)."""
    out = []
    for name in rec_a.series._fields:
        a, b = getattr(rec_a.series, name), getattr(rec_b.series, name)
        a = a if rows is None else a[rows]
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != \
                b.tobytes():
            out.append(name)
    return out


def sanitize_phase(dev, values, bw, calib_report):
    """Phase 14: ``REPRO_SANITIZE=1`` on the card. The main fleet's B_MAIN
    replicas for ``SANITIZE_FRAMES`` ticks through the kernels, flag off,
    on, on, off: every run bit-identical to the first, with the same
    launches, each timed; one calibration point under the flag passes the
    committed bands (and equals the grid's cell); a fleet with one
    corrupted window raises ``SanitizeError`` naming the window order."""
    from repro_torch.analysis import sanitize
    from repro_torch.calib import (
        CalibConfig, check_report, load_baseline, run_calibration,
    )
    from repro_torch.fleet import FleetParams, fleet_run, make_fleet

    params = FleetParams()
    F = values.shape[0]
    saved = os.environ.get(sanitize.ENV_VAR)

    def set_flag(on: bool):
        if on:
            os.environ[sanitize.ENV_VAR] = "1"
        else:
            os.environ.pop(sanitize.ENV_VAR, None)

    runs = []
    try:
        for on in (False, True, True, False):
            set_flag(on)
            fleet = make_fleet(B_MAIN, device=dev)
            torch.cuda.synchronize()
            reset_counts()
            out, secs = timed(lambda: fleet_run(fleet, values, bw,
                                                params=params))
            runs.append((on, fleet_leaves(*out), nonzero_counts(), secs))
            del out, fleet

        set_flag(True)
        point_cfg = CalibConfig(scenarios=("uniform",),
                                congestion_levels=(0.0,),
                                n_seeds=calib_report["_config"]["n_seeds"],
                                n_frames=calib_report["_config"]["n_frames"])
        reset_counts()
        point = run_calibration(point_cfg, device=dev)
        point_counts = nonzero_counts()
        ok, failures = check_report(point, load_baseline(str(BASELINE)))

        fleet = make_fleet(B_MAIN, device=dev)
        first = (0,) * fleet.sched.win_t1.ndim
        fleet.sched.win_t1[first] = 9.0
        fleet.sched.win_t2[first] = 1.0
        fleet.sched.win_valid[first] = True
        tripped = None
        try:
            fleet_run(fleet, values[:2], bw[:2], params=params)
        except sanitize.SanitizeError as err:
            tripped = str(err)
        del fleet
    finally:
        if saved is None:
            os.environ.pop(sanitize.ENV_VAR, None)
        else:
            os.environ[sanitize.ENV_VAR] = saved

    differing = sorted({n for _, ls, _, _ in runs[1:]
                        for n in differing_leaves(runs[0][1], ls)})
    run_counts = [c for _, _, c, _ in runs]
    ms_tick = {"off": [1e3 * s / F for on, _, _, s in runs if not on],
               "on": [1e3 * s / F for on, _, _, s in runs if on]}
    cell = "uniform@0"
    emit({"phase": "sanitize", "replicas": B_MAIN, "frames": F,
          "order": ["off", "on", "on", "off"],
          "ms_per_tick": ms_tick, "launches": run_counts,
          "differing": differing,
          "calibration_point": cell, "calibration_gate_ok": ok,
          "calibration_gate_failures": failures,
          "calibration_point_launches": point_counts,
          "calibration_point_equals_grid":
              point["cells"].get(cell) == calib_report["cells"].get(cell),
          "corrupted_fleet_raised": tripped})
    want = fleet_launches(F)
    check(all(c == want for c in run_counts),
          f"fleet launches with and without the flag: {run_counts}, not "
          f"{want}")
    check(not differing, f"the sanitized fleet differs in {differing}")
    check(ok, f"the sanitized calibration point fails the committed "
              f"baseline: {failures}")
    check(point_counts == fleet_launches(point_cfg.n_frames),
          f"the sanitized calibration point launched {point_counts}")
    check(point["cells"].get(cell) == calib_report["cells"].get(cell),
          "the sanitized calibration point differs from the grid's")
    check(tripped is not None and "window order" in tripped,
          f"the corrupted fleet did not trip the window-order check: "
          f"{tripped}")


def telemetry_phase(dev, values, bw, main_leaves):
    """The fleet path's B_MAIN replicas for the 95 ticks with
    ``telemetry`` off, on, on, off through the kernels (ms a tick each):
    every run's state and stats bit-identical to the main fleet run,
    with its launches; the record equal bit for bit to the plain path's
    (``placement_backend="ref"``) and to a second run's; a stride-5
    record equal to the full one at ticks 0, 5, ..., 90; the ``*_d``
    series summing to the final counters; the ``.npz`` round trip; and
    the Chrome trace of replicas 0 and B_MAIN - 1 valid."""
    from repro_torch.fleet import FleetParams, fleet_run, make_fleet
    from repro_torch.obs import (
        fleet_trace_events, load_record, load_trace, validate_trace,
        write_chrome_trace,
    )

    F = values.shape[0]
    off, on = FleetParams(), FleetParams(telemetry=True)
    runs = []
    for p in (off, on, on, off):
        fleet = make_fleet(B_MAIN, device=dev)
        reset_counts()
        out, secs = timed(lambda: fleet_run(fleet, values, bw, params=p))
        runs.append((p.telemetry, out, nonzero_counts(), secs))
        del fleet
    differing = sorted({n for _, out, _, _ in runs
                        for n in differing_leaves(main_leaves,
                                                  fleet_leaves(*out[:2]))})
    rec = runs[1][1][2]
    rec_again = runs[2][1][2]
    state, stats = runs[1][1][:2]

    reset_counts()
    strided = fleet_run(make_fleet(B_MAIN, device=dev), values, bw,
                        params=FleetParams(telemetry=True,
                                           telemetry_every=TELEMETRY_STRIDE))
    strided_counts = nonzero_counts()
    reset_counts()
    plain, plain_secs = timed(lambda: fleet_run(
        make_fleet(B_MAIN, device=dev), values, bw,
        params=FleetParams(telemetry=True, placement_backend="ref")))
    plain_counts = nonzero_counts()

    stats_np = [x.cpu().numpy() for x in stats]
    names = list(type(stats)._fields)
    s = rec.series
    unreconciled = [
        f for f in ("hp_completed", "hp_failed", "hp_preempted",
                    "lp_spawned", "lp_completed", "lp_failed",
                    "lp_requeued", "missed_by_preemption")
        if not (getattr(s, f + "_d").sum(0) == stats_np[names.index(f)]
                ).all()]
    if not (s.preempt_dev.sum((0, 2)) == stats_np[names.index(
            "hp_preempted")]).all():
        unreconciled.append("preempt_dev")
    if not (s.hp_fail_dev.sum((0, 2)) == stats_np[names.index(
            "hp_failed")]).all():
        unreconciled.append("hp_fail_dev")

    OBS_DIR.mkdir(parents=True, exist_ok=True)
    npz = OBS_DIR / "fleet_telemetry.npz"
    rec.save(str(npz))
    back = load_record(str(npz))
    roundtrip = differing_series(rec, back) + [
        k for k in ("n_frames", "every", "frame_period", "nominal_bw_bps")
        if getattr(rec, k) != getattr(back, k)]
    trace = OBS_DIR / "fleet_telemetry.trace.json"
    events = fleet_trace_events(rec, replicas=[0, B_MAIN - 1])
    write_chrome_trace(str(trace), events)
    trace_errors = validate_trace(load_trace(str(trace)))

    record_bytes = sum(x.nbytes for x in s)
    ms_tick = {"off": [1e3 * t / F for tel, _, _, t in runs if not tel],
               "on": [1e3 * t / F for tel, _, _, t in runs if tel]}
    run_counts = [c for _, _, c, _ in runs]
    stride_rows = list(range(0, F, TELEMETRY_STRIDE))
    emit({"phase": "telemetry", "replicas": B_MAIN, "frames": F,
          "order": ["off", "on", "on", "off"], "ms_per_tick": ms_tick,
          "launches": run_counts, "differing_from_main_path": differing,
          "recorded_ticks": int(rec.ticks.size),
          "record_bytes": record_bytes,
          "record_differs_from_plain_path": differing_series(rec, plain[2]),
          "record_differs_between_runs": differing_series(rec, rec_again),
          "plain_path_seconds": plain_secs, "plain_path_launches":
              plain_counts,
          "strided_every": TELEMETRY_STRIDE,
          "strided_ticks": strided[2].ticks.tolist(),
          "strided_differs_from_full": differing_series(
              rec, strided[2], rows=stride_rows),
          "strided_launches": strided_counts,
          "series_not_reconciled": unreconciled,
          "npz_bytes": npz.stat().st_size, "npz_roundtrip_differs":
              roundtrip,
          "trace_events": len(events), "trace_errors": trace_errors[:5]})
    want = fleet_launches(F)
    total = {k: v * (len(runs) + 1) for k, v in want.items()}
    check(all(c == want for c in run_counts) and strided_counts == want,
          f"fleet launches with and without telemetry: {run_counts}, "
          f"strided {strided_counts}, not {want}")
    check(plain_counts == {}, f"the plain path launched {plain_counts}")
    check(not differing, f"telemetry changed the fleet's results in "
                         f"{differing}")
    check(rec.ticks.tolist() == list(range(F))
          and rec.n_replicas == B_MAIN, "the record's ticks or replicas")
    for label, diff in (
            ("the plain path's", differing_series(rec, plain[2])),
            ("a second run's", differing_series(rec, rec_again)),
            ("the strided run's", differing_series(rec, strided[2],
                                                   rows=stride_rows))):
        check(not diff, f"the record differs from {label} in {diff}")
    check(strided[2].ticks.tolist() == stride_rows, "strided ticks")
    check(not unreconciled, f"series that do not sum to the final "
                            f"counters: {unreconciled}")
    check(not roundtrip, f"the .npz round trip changed {roundtrip}")
    check(not trace_errors, f"invalid fleet trace: {trace_errors[:5]}")
    return total


def profile_phase(dev, values, bw):
    """``obs/profile.py`` on the card: a PhaseTimer around the fleet path
    counts one ``fleet/segment`` span a segment (and, with telemetry,
    one host transfer); with ``REPRO_PROFILE_DIR`` set a 5-tick run
    writes one ``torch.profiler`` trace naming both fleet kernels; under
    ``profile_device``'s own profiler the hook passes through and the run
    still works."""
    from repro_torch.fleet import FleetParams, fleet_run, make_fleet
    from repro_torch.obs import PhaseTimer, profile

    F = values.shape[0]
    params = FleetParams()
    n_seg = -(-F // params.segment_frames)
    spans = {}
    for tel in (False, True):
        fleet = make_fleet(B_MAIN, device=dev)
        with PhaseTimer() as timer:
            fleet_run(fleet, values, bw,
                      params=dataclasses.replace(params, telemetry=tel))
            torch.cuda.synchronize()
        spans["on" if tel else "off"] = timer.summary()
        del fleet

    trace_dir = OBS_DIR / "torch_trace"
    if trace_dir.exists():
        for old in trace_dir.glob("*.json"):
            old.unlink()
    saved = os.environ.get(profile.ENV_VAR)
    os.environ[profile.ENV_VAR] = str(trace_dir)
    try:
        reset_counts()
        fleet_run(make_fleet(B_MAIN, device=dev), values[:5], bw[:5],
                  params=params)
        torch.cuda.synchronize()
        traced_counts = nonzero_counts()
        files = sorted(trace_dir.glob("*.pt.trace.json"))
        names = set()
        if files:
            with open(files[0]) as f:
                names = {e.get("name", "") for e in json.load(f).get(
                    "traceEvents", []) if e.get("cat") == "kernel"}
        fleet = make_fleet(B_MAIN, device=dev)
        reset_counts()
        prof = profile_device(
            lambda: fleet_run(fleet, values[:5], bw[:5], params=params),
            "fleet_run under REPRO_PROFILE_DIR",
            track=("fused_place_kernel", "window_query_kernel"))
        nested_counts = nonzero_counts()
        files_after = sorted(trace_dir.glob("*.pt.trace.json"))
    finally:
        if saved is None:
            os.environ.pop(profile.ENV_VAR, None)
        else:
            os.environ[profile.ENV_VAR] = saved
    kernels = {k: any(k in n for n in names)
               for k in ("fused_place_kernel", "window_query_kernel")}
    emit({"phase": "profile", "replicas": B_MAIN, "frames": F,
          "spans_off": spans["off"], "spans_on": spans["on"],
          "segments": n_seg, "trace_files": [f.name for f in files],
          "trace_bytes": files[0].stat().st_size if files else None,
          "trace_kernels_named": kernels,
          "trace_distinct_kernels": len(names),
          "traced_launches": traced_counts,
          "under_profile_device": {
              "launches": nested_counts, "new_trace_files":
                  len(files_after) - len(files),
              "tracked": prof["tracked"],
              "device_busy_share": prof["device_busy_share"]}})
    for label, sp in spans.items():
        check(sp.get("fleet/segment", {}).get("count") == n_seg,
              f"telemetry {label}: {sp.get('fleet/segment')} segment spans, "
              f"not {n_seg}")
    check(spans["on"].get("fleet/telemetry_host_transfer", {}).get(
        "count") == 1 and "fleet/telemetry_host_transfer" not in
        spans["off"], "the telemetry host-transfer span")
    check(len(files) == 1, f"REPRO_PROFILE_DIR wrote {len(files)} traces")
    check(all(kernels.values()), f"the trace does not name {kernels}")
    check(traced_counts == fleet_launches(5),
          f"the traced run launched {traced_counts}")
    check(nested_counts == fleet_launches(5) and files_after == files,
          f"under profile_device: {nested_counts}, "
          f"{len(files_after) - len(files)} new traces")
    check(prof["tracked"]["fused_place_kernel"]["calls"]
          == FUSED_PER_TICK * 5, f"profile_device saw {prof['tracked']}")
    return {k: traced_counts.get(k, 0) + nested_counts.get(k, 0)
            for k in set(traced_counts) | set(nested_counts)}


def obs_cli_phase(dev):
    """``python -m repro_torch.obs`` through ``main``: ``record`` of B 8
    replicas x 95 frames of weighted2 at congestion 0.3 on the card (21 +
    4 launches a tick) and on the host (the records equal bit for bit),
    ``export`` and ``summary``; then the serial DES's recording, exported
    and summarised. Both traces valid; each ``record`` timed."""
    import contextlib
    import io

    from repro_torch.obs import cli, load_record, load_trace, validate_trace

    out = {}
    record = ["record", "--scenario", "weighted2", "--frames",
              str(N_FRAMES), "--congestion", "0.3"]
    fleet_args = ["--batch", str(CLI_BATCH)]
    base = f"weighted2_b{CLI_BATCH}_f{N_FRAMES}_s0"
    steps = {}
    launches = None
    for engine, device, args in (("fleet", "cuda", fleet_args),
                                 ("fleet", "cpu", fleet_args),
                                 ("serial", None, [])):
        d = OBS_DIR / f"cli_{engine}_{device}"
        argv = record + ["--engine", engine, "--out", str(d)] + args
        if device:
            argv += ["--device", device]
        text = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(text):
            rc, secs = timed(lambda: cli.main(argv))
        rcs = [rc]
        counts_ = nonzero_counts()
        if (engine, device) == ("fleet", "cuda"):
            launches = counts_
        rec = next(str(p) for p in sorted(d.iterdir())
                   if p.suffix in (".npz", ".jsonl"))
        trace = os.path.splitext(rec)[0] + ".trace.json"
        with contextlib.redirect_stdout(text):
            rcs += [cli.main(["export", "--input", rec]),
                    cli.main(["summary", "--input", rec]),
                    cli.main(["summary", "--input", trace])]
        steps[f"{engine}_{device}" if device else engine] = {
            "rcs": rcs, "record_seconds": secs, "launches": counts_,
            "recording": Path(rec).name,
            "trace_errors": validate_trace(load_trace(trace))[:5],
            "output": text.getvalue().splitlines()}
        out[engine, device] = rec
    card = load_record(out["fleet", "cuda"])
    host = load_record(out["fleet", "cpu"])
    card_vs_host = differing_series(card, host)
    emit({"phase": "obs_cli", "steps": steps,
          "recording": f"fleet_{base}", "ticks": int(card.ticks.size),
          "card_record_differs_from_host": card_vs_host})
    for name, step in steps.items():
        check(step["rcs"] == [0, 0, 0, 0], f"obs CLI {name}: {step['rcs']}")
        check(not step["trace_errors"], f"obs CLI {name}: invalid trace")
    check(launches == fleet_launches(N_FRAMES),
          f"the card's recording launched {launches}")
    check(steps["fleet_cpu"]["launches"] == {}
          and steps["serial"]["launches"] == {},
          "a host recording launched a kernel")
    check(card.ticks.size == N_FRAMES and card.n_replicas == CLI_BATCH,
          "the card's recording")
    check(not card_vs_host, f"card and host recordings differ in "
                            f"{card_vs_host}")
    return launches


def sharded_phase(dev, summary, sweep, stats, state, owners):
    """The sharded sweep on the card: ``run_sweep(mesh_shards=1)`` of the
    fleet cell equals the unsharded sweep (cell means within 1e-5,
    replicas exact, residual 0), also in batches of SWEEP_TAIL_BATCH
    (the last batch's tail has owners -1); ``mesh_shards=2`` raises on
    one card; 21 + 4 launches a tick; and the per-cell reduction of one
    batch on the card: its time and the bytes it copies to the host."""
    from repro_torch.fleet import (
        SweepConfig, cell_moments, merge_cell_moments, run_sweep,
        summarize_cells,
    )

    F = sweep.n_frames
    cells = summary["_sweep"]["cells"]
    results, run_counts, secs = {}, {}, {}
    for bs in (sweep.batch_size, SWEEP_TAIL_BATCH):
        cfg = dataclasses.replace(sweep, mesh_shards=1, batch_size=bs)
        reset_counts()
        results[bs], secs[bs] = timed(lambda: run_sweep(cfg, device=dev))
        run_counts[bs] = nonzero_counts()
    worst = {}
    for bs, out in results.items():
        worst[bs] = 0.0
        for c in cells:
            for key, val in summary[c].items():
                if isinstance(val, dict) and "mean" in val:
                    worst[bs] = max(worst[bs], abs(out[c][key]["mean"]
                                                   - val["mean"]))
    replicas_equal = {bs: all(out[c]["replicas"] == summary[c]["replicas"]
                              for c in cells)
                      for bs, out in results.items()}
    residual = {bs: max(out[c]["conservation_residual"]["max_abs"]
                        for c in cells) for bs, out in results.items()}
    n_batches = {bs: -(-B_MAIN // bs) for bs in results}
    tail_pad = n_batches[SWEEP_TAIL_BATCH] * SWEEP_TAIL_BATCH - B_MAIN

    owner = torch.as_tensor(owners, device=dev)
    cell_moments(stats, state.rq_valid, owner, n_cells=len(cells),
                 n_frames=F)
    torch.cuda.synchronize()
    moments, reduce_s = timed(lambda: cell_moments(
        stats, state.rq_valid, owner, n_cells=len(cells), n_frames=F))
    host_bytes = sum(x.numel() * x.element_size() for x in moments)
    batch_cells = summarize_cells(merge_cell_moments(None, moments))

    two = "not run: more than one card"
    if torch.cuda.device_count() < 2:
        try:
            run_sweep(dataclasses.replace(sweep, mesh_shards=2, n_seeds=1),
                      device=dev)
            two = None
        except ValueError as err:
            two = str(err)
    emit({"phase": "sharded", "replicas": B_MAIN, "frames": F,
          "batch_sizes": list(results), "batches": n_batches,
          "tail_owners_minus_1": tail_pad,
          "seconds": secs, "launches": run_counts,
          "max_abs_mean_diff_from_unsharded": worst,
          "replicas_equal": replicas_equal, "residual_max_abs": residual,
          "mesh": results[sweep.batch_size]["_sweep"]["mesh"],
          "reduction_ms": 1e3 * reduce_s,
          "host_bytes_per_batch": host_bytes,
          # what the unsharded sweep copies a batch: counters, pending
          "host_bytes_per_batch_unsharded": sum(
              x.numel() * x.element_size() for x in stats) + B_MAIN * 8,
          "batch_frame_completion_rate": {
              c: batch_cells[i]["frame_completion_rate"]
              for i, c in enumerate(cells)},
          "mesh_shards_2_on_one_card": two})
    for bs in results:
        want = {k: v * n_batches[bs] for k, v in fleet_launches(F).items()}
        check(run_counts[bs] == want,
              f"the sharded sweep in batches of {bs} launched "
              f"{run_counts[bs]}, not {want}")
        check(worst[bs] <= 1e-5 and replicas_equal[bs]
              and residual[bs] == 0,
              f"the sharded sweep in batches of {bs} differs from the "
              f"unsharded one: {worst[bs]}, {replicas_equal[bs]}, "
              f"residual {residual[bs]}")
    check(tail_pad > 0, "the padded sweep has no owner -1 tail")
    check(torch.cuda.device_count() > 1 or (two and "device" in two),
          f"mesh_shards=2 on one card: {two}")
    return {k: sum(c.get(k, 0) for c in run_counts.values())
            for k in fleet_launches(F)}


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
    from repro_torch.kernels.placement import placement
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
    logs = _build.build(KERNELS)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs),
          "nvcc": {k: v.splitlines() for k, v in logs.items()}})
    # a library taken from an earlier build has no log to report
    ptxas = ptxas_report(logs, ("fused_place_kernel",
                                "flash_attention_wgmma_kernel",
                                "flash_decode_split_kernel",
                                "flash_decode_combine_kernel",
                                "ssm_scan_kernel", "ssd_scan_mma_kernel",
                                "ssd_scan_simt_kernel",
                                "window_query_kernel"))
    emit({"phase": "ptxas",
          "of": "the placement, attention, decode, scan and window-query "
                "kernels",
          "from_cache": sorted({"placement", "flash_attention",
                                "flash_decode", "ssm_scan", "ssd_scan",
                                "window_query"} - set(logs)),
          "kernels": ptxas})
    serialized = [r["kernel"] for r in ptxas if r["wgmma_serialized"]]
    check(not serialized, f"ptxas serialized the wgmmas of {serialized}")
    spilled = [r["kernel"] for r in ptxas if r["kernel"].startswith(
        ("fused_place", "window_query")) and (r.get("spill_stores")
                                              or r.get("spill_loads"))]
    check(not spilled, f"ptxas spilled registers of {spilled}")

    # -- 3. kernel against its plain version ---------------------------------
    kernel_err = check_fused_place(dev)

    attn_err = {}
    for i, c in enumerate(ATTN_CASES):
        name, *_, dt, causal, window, cap = c
        q, k, v = attn_inputs(i, c, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        reset_counts()
        ker = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        routes = {r: counts()[f"flash_attention_{r}"] for r in ROUTES}
        ref = attention_ref(q, k, v, **kw)
        err = max_abs_err([ref], [ker])
        attn_err[name] = err
        emit({"phase": "kernel", "kernel": "flash_attention", "case": name,
              "shape": list(q.shape), "kv_heads": k.shape[1],
              "dtype": str(dt), **kw, "route_launches": routes,
              "max_abs_err": err,
              "max_abs_out": ref.float().abs().max().item(),
              "tolerance": ATTN_TOL[dt],
              "finite": bool(torch.isfinite(ker).all())})
        check(ker.dtype == dt and ker.shape == q.shape
              and bool(torch.isfinite(ker).all()),
              f"flash_attention gave a bad result in case {name}")
        check(err <= ATTN_TOL[dt], f"flash_attention differs from its plain "
                                   f"version in case {name}: {err}")
        want = {r: int(r == fa.route(dt)) for r in ROUTES}
        check(routes == want, f"flash_attention case {name} ({dt}) took "
                              f"the routes {routes}, not {want}")
        del q, k, v, ker, ref
    torch.cuda.empty_cache()
    new_err, decode_pos = check_new_kernels(dev)
    wq_rows, wq_path = window_query_phase(dev)

    # -- 4. the fleet path --------------------------------------------------
    sweep = SweepConfig(scenarios=("uniform", "weighted2"),
                        congestion_levels=(0.0, 0.3), n_seeds=2048,
                        n_frames=N_FRAMES, batch_size=B_MAIN)
    params = sweep.fleet_params()
    warm_v, warm_bw = _build_population(
        SweepConfig(n_seeds=B_MAIN // 4, n_frames=2))[1:3]
    fleet_run(make_fleet(B_MAIN, device=dev), warm_v, warm_bw, params=params)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    summary = run_sweep(sweep, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fleet_counts = counts()
    launches = fleet_counts["fused_place"]
    hp_queries = fleet_counts["window_query_batched"]
    hp_vec = fleet_counts["window_query_vec"]
    cells = summary["_sweep"]["cells"]
    residual = {c: summary[c]["conservation_residual"]["max_abs"]
                for c in cells}
    emit({"phase": "main_path", "entry": "run_sweep", "replicas": B_MAIN,
          "frames": N_FRAMES, "seconds": wall,
          "ms_per_tick": 1e3 * wall / N_FRAMES,
          "replicas_per_s": B_MAIN / wall,
          "replica_frames_per_s": B_MAIN * N_FRAMES / wall,
          "fused_place_launches": launches,
          "window_query_batched_launches": hp_queries,
          "window_query_vec_launches": hp_vec,
          "frame_completion_rate": {
              c: summary[c]["frame_completion_rate"] for c in cells},
          "conservation_residual_max_abs": residual})
    check(launches == FUSED_PER_TICK * N_FRAMES,
          f"fused_place launched {launches} times, not "
          f"{FUSED_PER_TICK * N_FRAMES}")
    check(hp_queries == HP_QUERIES_PER_TICK * N_FRAMES,
          f"window_query_batched launched {hp_queries} times, not "
          f"{HP_QUERIES_PER_TICK * N_FRAMES}")
    check(hp_vec == hp_queries and fleet_counts["window_query_scalar"] == 0,
          f"{hp_queries - hp_vec} of the fleet's HP queries missed the "
          f"vector route")
    check(all(v == 0 for v in residual.values()),
          f"LP tasks lost or double-counted: {residual}")

    # -- 5. the plain fleet path on the same batch ---------------------------
    _, values, bw, owners = _build_population(sweep)
    runs, run_counts = {}, {}
    for backend in ("auto", "ref"):
        p = FleetParams(placement_backend=backend)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, stats = fleet_run(make_fleet(B_MAIN, device=dev), values, bw,
                                 params=p)
        torch.cuda.synchronize()
        runs[backend] = (state, stats, time.perf_counter() - t0)
        run_counts[backend] = nonzero_counts()
    (sk, tk, wall_k), (sr, tr, wall_r) = runs["auto"], runs["ref"]
    diff = [f for f, a, b in zip(FleetStats._fields, tk, tr)
            if not bit_equal(a, b)]
    diff += [f"sched.{f}" for f, a, b in zip(sk.sched._fields, sk.sched,
                                             sr.sched) if not bit_equal(a, b)]
    diff += [f for f, a, b in zip(sk._fields[1:], sk[1:], sr[1:])
             if not bit_equal(a, b)]
    main_leaves = fleet_leaves(sk, tk)
    stats_np = stats_to_numpy(tr)
    pending = fleet_to_numpy(sr).rq_valid.sum(1)
    same_summary = all(
        summarize(FleetStats(*(x[owners == ci] for x in stats_np)),
                  N_FRAMES, rq_pending=pending[owners == ci]) == summary[c]
        for ci, c in enumerate(cells))
    emit({"phase": "plain_path", "differing": diff,
          "summaries_equal_main_path": same_summary,
          "launches": run_counts,
          "kernel_path_seconds": wall_k, "plain_path_seconds": wall_r})
    check(run_counts["ref"] == {}
          and run_counts["auto"] == fleet_launches(N_FRAMES),
          f"fleet launches by backend: {run_counts}")
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
        reset_counts()
        engine.forwards = 0
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
              "flash_attention_wgmma_launches": fa.launches_wgmma,
              "fused_place_launches": placement.launches})
        check(n_launch > 0 and n_launch == wcfg.n_layers * n_fwd,
              f"flash_attention launched {n_launch} times for {n_fwd} "
              f"forward passes of {wcfg.n_layers} layers")
        check(fa.launches_wgmma == n_launch,
              f"{n_launch - fa.launches_wgmma} of the serving path's "
              f"attention launches missed the wgmma route")
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
        model = Model(wcfg, device=dev, backend=backend)
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
            model = Model(cfg, device=dev, backend=backend)
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

    # -- 7. the hybrid path: full zamba2-7b ----------------------------------
    launches_by_path = {"serving": {"forwards": {
        "flash_attention": serve_launches}}}
    zcfg = get_config("zamba2-7b")
    n_attn = zcfg.n_layers // zcfg.shared_attn_every
    launches_by_path["zamba2-7b"] = model_path(
        "zamba2-7b", dev,
        want_fwd={"ssd_scan": zcfg.n_layers, "flash_attention": n_attn,
                  "flash_attention_wgmma": n_attn,
                  "flash_attention_simt": 0, "ssm_scan": 0,
                  "flash_decode": 0},
        want_step={"flash_decode": n_attn, "flash_decode_split": n_attn,
                   "flash_decode_combine": n_attn, "ssd_scan": 0,
                   "flash_attention": 0},
        decode_batch=HYBRID_DECODE[0], cache_len=HYBRID_DECODE[1], seed=0)

    # -- 8. the ssm path: full falcon-mamba-7b -------------------------------
    fcfg = get_config("falcon-mamba-7b")
    launches_by_path["falcon-mamba-7b"] = model_path(
        "falcon-mamba-7b", dev,
        want_fwd={"ssm_scan": fcfg.n_layers, "ssd_scan": 0,
                  "flash_attention": 0},
        want_step={"ssm_scan": 0, "flash_decode": 0,
                   "flash_decode_split": 0, "flash_decode_combine": 0},
        decode_batch=SSM_DECODE_BATCH, cache_len=HYBRID_DECODE[1], seed=1)

    # -- 9. kernel path vs plain path at model level --------------------------
    model_plain_paths(dev)

    # -- 10. timing -----------------------------------------------------------
    place_row = time_fused_place(dev)

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
        row = {"case": name, "route": fa.route(c[6]), "ms": ker_ms,
               "plain_ms": ref_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "tflops": flops / ker_ms / 1e9,
               "share_of_bound": bound_ms / ker_ms,
               "max_abs_err": attn_err[name]}
        attn_rows.append(row)
        emit({"phase": "timing", "kernel": "flash_attention", **row})
        del q, k, v, lib
    torch.cuda.empty_cache()
    main_attn = next(r for r in attn_rows if r["case"] == MAIN_ATTN_CASE)

    # where the fleet path's time goes: 5 ticks under the profiler
    v5, bw5 = values[:5], bw[:5]
    fleet = make_fleet(B_MAIN, device=dev)
    prof = profile_device(lambda: fleet_run(fleet, v5, bw5, params=params),
                          "fleet_run", track=("window_query_kernel",))
    place_ms = [r["ms"] for r in prof["top_device_ops"]
                if "fused_place_kernel" in r["name"]]
    emit({**prof, "ticks": 5, "fused_place_device_ms_per_tick":
          place_ms[0] / 5 if place_ms else None,
          "window_query_device_ms_per_tick":
              prof["tracked"]["window_query_kernel"]["ms"] / 5,
          "window_query_launches": prof["tracked"]["window_query_kernel"][
              "calls"]})

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

    new_rows = time_new_kernels(dev, new_err, decode_pos)
    wq_rows = time_window_query(dev, wq_rows)

    # -- 11. single controller; 12. the launch checker's fixture -------------
    single_controller_phase(dev)
    racy_row, racy_launches = fixture_phase(dev)

    # -- 13. the calibration; 14. the sanitizers -----------------------------
    calib_report, calib_counts = calibration_phase(dev)
    sanitize_phase(dev, values[:SANITIZE_FRAMES], bw[:SANITIZE_FRAMES],
                   calib_report)

    # -- 15. telemetry; 16. profile; 17. the obs CLI; 18. the sharded sweep
    obs_counts = {
        "fleet telemetry": telemetry_phase(dev, values, bw, main_leaves),
        "fleet profile": profile_phase(dev, values, bw),
        "obs CLI record": obs_cli_phase(dev),
        "sharded run_sweep": sharded_phase(dev, summary, sweep, tk, sk,
                                           owners),
    }

    def fleet_counts_by_path(name):
        """A fleet kernel's launches on each fleet path but the main one."""
        per = {"calibration run_calibration": calib_counts.get(name, 0)}
        per.update((path, c.get(name, 0)) for path, c in obs_counts.items())
        return per

    def path_launches(name):
        """The kernel's launches on each main path that ran it (forward and
        decode counted apart), and their sum."""
        per = {f"{path} {part}": n[name]
               for path, parts in launches_by_path.items()
               for part, n in parts.items() if n.get(name)}
        return sum(per.values()), per

    def new_entry(name, source, replaces):
        total, per = path_launches(name)
        row = new_rows[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": total,
                "launches_by_path": per, "matched": True,
                "max_abs_err": row["max_abs_err"], "case": row["case"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    def wq_entry(name, total, per, by_route, replaces):
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/window_query/csrc/"
                          "window_query.cu",
                "replaces": replaces, "launches": total,
                "launches_by_path": per, "launches_by_route": by_route,
                "matched": True, **wq_rows[name]}

    attn_total, attn_per = path_launches("flash_attention")
    emit({"kernels": [{
        "name": "fused_place",
        "route": "cuda",
        "source": "src/repro_torch/kernels/placement/csrc/placement.cu",
        "replaces": "src/repro/kernels/placement/placement.py:74",
        "launches": launches + sum(
            fleet_counts_by_path("fused_place").values()),
        "launches_by_path": {"fleet run_sweep": launches,
                             **fleet_counts_by_path("fused_place")},
        "matched": True,
        "max_abs_err": kernel_err,
        "case": "fleet-8192",
        **place_row,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_wgmma.cu",
        "sources_by_dtype": {
            "bfloat16": "src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention_wgmma.cu",
            "float32": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu"},
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:100",
        "launches": attn_total,
        "launches_by_path": attn_per,
        "forward_passes": serve_forwards,
        "matched": True,
        "max_abs_err": max(attn_err.values()),
        "case": MAIN_ATTN_CASE,
        "ms": main_attn["ms"],
        "plain_ms": main_attn["plain_ms"],
        "bound_ms": main_attn["bound_ms"],
        "bound_by": main_attn["bound_by"],
        "library_ms": main_attn["library_ms"],
        "cases": [{k: r[k] for k in ("case", "route", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "share_of_bound")}
                  for r in attn_rows],
    }, new_entry("ssd_scan",
                 "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/ssd_scan.py:74"),
        new_entry("ssm_scan",
                  "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                  "src/repro/kernels/ssm_scan/ssm_scan.py:61"),
        {**new_entry("flash_decode",
                     "src/repro_torch/kernels/flash_decode/csrc/"
                     "flash_decode.cu",
                     "src/repro/kernels/flash_decode/flash_decode.py:80"),
         "launches_split": path_launches("flash_decode_split")[0],
         "launches_combine": path_launches("flash_decode_combine")[0],
         **{k: new_rows["flash_decode"][k]
            for k in ("split_ms", "combine_ms")},
         "launch_parameters": {k: new_rows["flash_decode"][k]
                               for k in ("n_split", "chunk")}},
        wq_entry("window_query_batched",
                 hp_queries + sum(fleet_counts_by_path(
                     "window_query_batched").values()),
                 {"fleet run_sweep": hp_queries,
                  **fleet_counts_by_path("window_query_batched")},
                 {"vec": hp_vec + sum(fleet_counts_by_path(
                     "window_query_vec").values()),
                  "scalar": fleet_counts["window_query_scalar"] + sum(
                      fleet_counts_by_path("window_query_scalar").values())},
                 "src/repro/kernels/window_query/window_query.py:115"),
        wq_entry("window_query", wq_path["all"],
                 {"window_query_op, bench_query's 1024 devices":
                  wq_path["all"]},
                 {r: wq_path[r] for r in ("vec", "scalar")},
                 "src/repro/kernels/window_query/window_query.py:47"),
        {"name": "racy_sum", "route": "cuda",
         "source": "src/repro_torch/analysis/fixtures/csrc/racy_sum.cu",
         "replaces": "src/repro/analysis/fixtures/racy_kernel.py:31",
         "launches": racy_launches,
         "launches_by_path": {"launch-checker fixture": racy_launches},
         "matched": True, **racy_row}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
