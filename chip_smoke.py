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
   output must be bit-identical; ``fanout_commit`` (the fleet's HP
   commit) the same way on seeded random rows plus the hand-built HP
   rows, at B=8192 (on devices 0 and 3), at the benchmark's B=524,288,
   at B=37, 1, 1027, an all-do-false 1027 and 6 devices: every output
   and window bit-identical to ``tensor_state.fanout_commit``, the
   windows updated in place, do = false rows byte-identical, the
   counter's rows committed ``do.sum()`` and rows changed the plain
   version's;
   ``flash_attention`` on seeded N(0,1) inputs at the waste pipeline's
   shapes (S 173 and 233, bf16 and f32), a qwen2.5-3b and a gemma2-2b local
   and global layer, a zamba2-7b layer (hd 112), zamba2-7b-instruct's
   layer at its prefill cell's longest step (4 x 4096, hd 224, scale
   112^-0.5) and a ragged f32 case at hd 224, a moonshot-v1-16b-a3b
   layer, a ragged small case and a non-causal one — within 2e-5 (f32)
   and 1.6e-2 (bf16, one ulp at |out| < 4), every bf16 case on the tensor-core (wgmma) kernel and every
   f32 case on the SIMT one; ``ssm_scan``, ``ssd_scan`` and ``flash_decode``
   (a split pass and a combine pass a call) at the layer
   shapes of falcon-mamba-7b and zamba2-7b (``ssd_scan`` also with B and C
   in zamba2-7b-instruct's 2 state groups at its prefill cell's longest
   and shortest steps, 4 x 4096 and 64 x 256, and in 3 groups at a ragged
   f32 shape; decode also moonshot-v1-16b-a3b
   at batch 4 against a 4096 cache) and at ragged small shapes —
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
   launch the placement kernel 21 times, the window-query kernel 4 times
   (the HP query of each device, every one on the vector route) and the
   fan-out commit kernel 4 times (each device's HP commit), and no LP task
   may be lost;
5. plain fleet path: the same batch through ``placement_backend="ref"``,
   which launches none of the three kernels, must give bit-identical
   counters and final state, and the same cell summaries; then both
   routes again (``"kernel"`` and ``"ref"``) under device-timed timers:
   state, stats and the ``fleet/hp_commit`` counters identical, the
   counted commits the stats' ``hp_completed``;
6. serving path: ``serve`` of 40 frame periods of the full waste-pipeline
   config through the RAS scheduler and the WPS baseline; the attention
   kernel must launch once per layer of every forward pass, on its wgmma
   route (the config is bf16); then one engine
   built twice from the same weights, on the kernel and on the plain
   attention, must give equal serving results and logits within 2e-2 (bf16)
   and 1e-4 (f32) of the largest logit; then ``serve`` of deepseek-v2-236b,
   kimi-k2-1t-a32b, moonshot-v1-16b-a3b and seamless-m4t-medium, reduced as
   ``serve`` reduces them (f32), through RAS: ``flash_attention`` once per
   causal self-attention layer of every forward (none for deepseek's MLA;
   seamless's encoder and cross-attention, over an empty memory, none),
   and each engine built twice, on the kernel and on the plain attention,
   with equal results;
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
9. MoE path: the full moonshot-v1-16b-a3b config (48 layers, 28.4 B
   parameters, bf16, drawn on the card): one forward of 1 x 4096 tokens
   with 48 ``flash_attention`` launches, all wgmma, and a finite aux loss;
   8 decode steps at batch 4 against 4096-long caches, 48 ``flash_decode``
   calls a step; peak memory against the card's;
10. MLA path: deepseek-v2-236b at full width cut to 2 layers (1 dense + 1
   MoE of 160 experts): the same forward and 8 decode steps at batch 4
   against a 32768-long latent cache, with no attention-kernel launch
   (MLA is plain torch, as in the reference);
11. encoder-decoder path: the full seamless-m4t-medium (12 + 12 layers):
   a forward of 1 x 4096 tokens over 1024 media frames with 12
   ``flash_attention`` launches (the decoder; the encoder and
   cross-attention launch none), then 8 decode steps at batch 4 against
   32768-long caches and an 8192-frame memory, 12 ``flash_decode`` a step;
12. kernel path vs plain path at model level, full width and cut depth
   (zamba2 13 blocks, falcon-mamba 4, seamless 4 + 4, S 512; 4 zamba2 and
   seamless decode steps against a 4096 cache): logits within 2e-2 of the
   largest logit (bf16); moonshot at 3 layers in f32: every MoE layer
   routes every token alike on both paths, logits within 1e-4 of the
   largest;
13. timing: each kernel's time per launch at its shapes (CUDA events) beside
   its bound, the plain version's time and, where one PyTorch call computes
   the same function, that call's time (a yardstick the port never calls),
   with each attention, decode and scan case's TFLOP/s or GB/s and share of
   its bound (every ``ssd_scan`` case at a model's shape timed;
   ``ssm_scan``'s bound the largest of its bytes, f32 instructions and
   exps, all three on its timing row), and ptxas's registers, spills and
   wgmma-serialization notes of the placement, attention, decode, scan
   and window-query kernels; ``fused_place``'s device time cold (L2
   flushed by a 64 MB write, the time held to the HBM bound) and warm
   (windows in L2, as the fleet meets them), and a near-empty launch's
   device time; ``fanout_commit``'s cold and warm at
   B=524,288 with every row committing, beside its byte bound;
   the window-query kernels' device time a launch cold (L2 flushed) and
   warm at every case, held to their byte bound, and the host's cost of
   one call of the fleet's HP query, split into the wrapper's parts; the
   racy fixture's device time a launch (the profiler's device events); and
   where each path's time goes (``torch.profiler``);
14. single controller: ``hp_place`` on each device and ``lp_place`` of 4
   tasks (lp2, lp4) from the same loaded scheduler on the card and on the
   host give the same outputs and state bit for bit; both timed;
15. launch-checker fixture: ``racy_sum`` on the card, whose two blocks
   write the same outputs: each output must be one of the two writers'
   values and the whole must differ from a correct reduction; the checker
   must flag its declared launch as a write race and find the production
   registry clean;
16. calibration: the serial DES (``run_experiment``, host Python) gives
   RAS, WPS and HYB frame-completion rates on weighted2 and weighted4 at
   congestion 0 and 0.3 (each run timed); then the committed grid of
   ``results/calib/baseline.json`` (5 paper traces x congestion 0 and 0.3
   x 3 seeds x 95 frames) through ``run_calibration`` on the card: every
   point launches the placement kernel 21 times and the window-query and
   fan-out commit kernels 4 times each a tick, the report must pass the committed bands and
   equal, key by key, the plain path's (``placement_backend="ref"``,
   which launches neither); each fleet point timed alone, one profiled;
17. sanitize: the fleet path's 8192 replicas for 10 ticks with
   ``REPRO_SANITIZE`` off, on, on, off must be bit-identical with the same
   launches (ms a tick each); one calibration point under the flag must
   pass the committed bands; a fleet with one corrupted window must raise
   ``SanitizeError`` naming the window order, and the run goes on;
18. telemetry: the fleet path's 8192 replicas for 95 ticks with
   ``telemetry`` off, on, on, off (ms a tick each), bit-identical to the
   main fleet run with 21 + 4 + 4 launches a tick; the record's 17 series
   equal bit for bit to the plain path's and to a stride-5 record's
   rows, the ``*_d`` series summing to the final counters, the ``.npz``
   round trip and the Chrome trace of replicas 0 and 8191 valid;
19. profile: a ``PhaseTimer`` counts one ``fleet/segment`` span a
   segment and the tick's phase spans, with telemetry off and on; a
   device-timed one gives each tick's device time and ``fused_place``'s
   counters, whose commits are the stats' ``lp_completed +
   hp_preempted``, and ``fanout_commit``'s, whose commits are the stats'
   ``hp_completed``, at the same launches; with ``REPRO_PROFILE_DIR`` set
   a 5-tick run writes one ``torch.profiler`` trace naming
   ``fused_place_kernel``, ``fanout_commit_kernel`` and
   ``window_query_kernel``; under
   ``profile_device`` it still runs and writes nothing;
20. obs CLI: ``repro_torch.obs.cli.main`` records B 8 x 95 frames of
   weighted2 at 0.3 on the card (equal bit for bit to the host's) and
   the serial DES, exports and summarises both; the traces valid;
21. sharded: ``run_sweep(mesh_shards=1)`` of the fleet cell, in one
   batch and in batches of 3000 (a tail of owners -1), within 1e-5 of
   the unsharded sweep with residual 0 and 21 + 4 + 4 launches a tick;
   ``mesh_shards=2`` raises on one card; the per-cell reduction's time
   and the bytes a batch copies to the host;
22. train: ``launch.train.train`` of the full qwen2.5-3b (36 layers, 3.1 B
   parameters, bf16, drawn on the card), 5 steps of 1 x 4096 tokens:
   every loss and grad norm finite, ``flash_attention`` 72 launches a
   step (36 in the forward, 36 in the remat recomputation), all wgmma;
   zamba2-7b cut to 13 blocks (1 x 4096; ``ssd_scan`` 25 a step: 12 x 2
   for the two rematted groups and 1 for the tail; ``flash_attention``
   4) and falcon-mamba-7b cut to 2 layers (1 x 1024; ``ssm_scan`` 4), 3
   steps each; each leg's ms a step (two more steps timed, one
   profiled), tokens/s and peak memory against the card's; then, in f32
   at full width and cut depth (qwen2.5-3b 2 layers, zamba2 one group,
   falcon-mamba 2 layers, S 512), ``Model.loss`` and every gradient leaf
   on the kernels (attention on the SIMT route) against the plain
   versions: the loss within 1e-5 relative, each leaf within 1e-3 of its
   max |plain|, and one AdamW step from equal gradients leaving both
   models' weights equal bit for bit; a bf16 checkpoint of the full-width
   qwen2.5-3b cut to 2 layers saved under the git-ignored build/ and
   restored bit for bit; and each differentiated kernel route's backward
   (the plain version recomputed, no launch) timed at its leg's shape;
23. dryrun: ``launch.dryrun.dry_run_one`` traces, on ``meta`` and for one
   card (``mesh="1xH100"``), the full
   qwen2.5-3b's training step at 1 x 4096 and the full zamba2-7b's
   prefill at 1 x 4096; the same steps (``launch.dryrun.build``) then
   run on the card: the record's argument bytes must equal the card's
   parameter, moment, batch and state bytes; on the plain route
   (``backend="ref"``, no launch; zamba2's at 1 x 1024, traced there
   too, since its SSD steps through the oracle one token at a time) the
   traced peak must lie within 10% of ``max_memory_allocated`` (reset
   after the build, less what earlier phases left allocated); on the
   kernel route
   (72 ``flash_attention`` a qwen step; 81 ``ssd_scan`` and 13
   ``flash_attention`` a zamba2 prefill) the median of 3 timed steps must
   take no less than the record's bound, ``max(compute_s, memory_s)``;
   each step's share of the bound and both routes' peaks printed.

24. mesh: the production mesh's route on a 1 x 1 mesh (a world-size-1
   NCCL group, a ``TCPStore`` on localhost): every parameter, moment and
   input a DTensor placed by ``launch/sharding.py``, every kernel reached
   through ``local_map``. The full qwen2.5-3b's loss and gradients at
   1 x 4096 on the mesh route and on phase 22's route (no mesh): equal,
   bit for bit, or else within phase 22's tolerances with the leaves that
   differ printed; 72 ``flash_attention`` each; both routes' ms a step
   (``train_step``, AdamW included; 3 steps after an untimed one), peak
   memory, the device's busy share of one step and where one step's host
   time goes (cProfile, by package). zamba2-7b at 13 blocks (1 x 4096:
   13 ``ssd_scan``, 2 ``flash_attention``) and falcon-mamba-7b at 2
   layers (1 x 1024: 2 ``ssm_scan``) prefill on both routes, 3 calls
   timed after an untimed one: logits equal, launches equal. zamba2-7b
   at 13 blocks decodes 8 steps of batch 4 from the end of a 4096 cache
   on both routes: logits and state equal, 2 ``flash_decode`` (2 split,
   2 combine launches) a step. ``decode_attention_op`` of a cache placed
   on its sequence (each rank's split pass, the partials gathered, one
   combine) equals the plain call, bit for bit. A DTensor refuses every
   kernel wrapper; ``make_production_mesh()`` refuses one card. After
   phase 25 the group is torn down and the qwen2.5-3b and granite-8b
   ``TRAIN_4K`` records on 16 x 16 (analytic, a fake 256-rank group) are
   printed.

25. sequence-sharded q: the attention kernels at a query offset, q's rows
   [s0, s0 + Sq) against all Sk keys. (a) Both routes against the plain
   version at the same offset, within 2e-5 / 1.6e-2: the last rank's share
   on 16 x 16 of gemma2-2b (local, window 4096, and global layers,
   softcap 50) and llava-next-34b at TRAIN_4K and PREFILL_32K, one in
   f32, and small ragged shares off the block (the plain version a batch
   row and a kv-head group at a time where its scores would pass 4 GiB);
   (b) sixteen ranks emulated on one card at S 4096 (batch 1): the shares'
   outputs put together bit-equal to the same route's kernel on the whole
   sequence, and S 4000 (shares of 250 rows, off the block) within the
   tolerance; (e) ``attention_op`` of a q DTensor placed on its sequence
   on the 1 x 1 mesh equal bit for bit to the plain tensors' kernel call;
   (c) with the hint set by hand to ``model`` on the 1 x 1 mesh, the full
   gemma2-2b's loss and every gradient leaf (1 x 4096, remat) and
   llava-next-34b at full width cut to 4 layers' prefill logits (1 x
   4096) bit-equal to the no-mesh route, with 26 + 26 and 4
   ``flash_attention`` launches, all wgmma; (d) each rank share's kernel
   time beside its bound from the visible pairs at its offset, the plain
   version's time and SDPA with ``causal_lower_right`` where no softcap
   rules it out. Every line names the card and its power limit.

Every phase line carries ``elapsed_s``, the seconds since the start. Then
one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.roofline.terms import (  # noqa: E402  (the H100 peaks)
    BF16_OPS_PER_S,
    BOOST_CLOCK_HZ,
    EX2_PER_CLOCK_SM,
    FP32_OPS_PER_S,
    HBM_BYTES_PER_S,
    SMS,
)

B_MAIN = 8192
N_FRAMES = 95
FUSED_PER_TICK = 21               # 1 re-queue + 4 devices x (1 + 4)
HP_QUERIES_PER_TICK = 4           # one window query a device
HP_COMMITS_PER_TICK = 4           # one fan-out commit a device
HP_COMMIT_B = 524288              # the benchmark's fleet batch
#: f32 instructions a second: 67 TFLOP/s counts an FMA as two operations;
#: an FMA, a multiply or an add is one instruction
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
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
    ("zamba2-7b-instruct", 4, 32, 32, 4096, 224, torch.bfloat16, True, 0,
     0.0),
    ("ragged-hd224-f32", 2, 4, 2, 77, 224, torch.float32, True, 0, 0.0),
    ("moonshot-v1-16b-a3b", 1, 16, 16, 4096, 128, torch.bfloat16, True, 0,
     0.0),
    ("ragged-small", 2, 4, 2, 37, 32, torch.float32, True, 8, 20.0),
    ("bidirectional", 1, 4, 2, 300, 128, torch.float32, False, 0, 0.0),
]
#: the scores' scale by case, hd ** -0.5 where absent: Zamba2's
#: (hd / 2)^-0.5 at hd 224
ATTN_SCALE = {"zamba2-7b-instruct": 112 ** -0.5,
              "ragged-hd224-f32": 112 ** -0.5}
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
#: (name, B, S, H, G, P, N, dtype): Mamba-2 SSD scans; G 0 is B and C
#: [B,S,N], G >= 1 [B,S,G,N] with head h reading group h // (H // G)
SSD_CASES = [
    ("zamba2-7b", 1, 4096, 112, 0, 64, 64, torch.bfloat16),
    ("ragged-small", 2, 77, 3, 0, 64, 64, torch.float32),
    ("ragged-small-bf16", 2, 77, 3, 0, 64, 64, torch.bfloat16),
    ("zamba2-7b-instruct-4x4096", 4, 4096, 112, 2, 64, 64, torch.bfloat16),
    ("zamba2-7b-instruct-64x256", 64, 256, 112, 2, 64, 64, torch.bfloat16),
    ("ragged-small-g3", 2, 77, 6, 3, 64, 64, torch.float32),
]
#: SSD cases timed (the first is the kernels line's main case)
SSD_TIMED = ("zamba2-7b", "zamba2-7b-instruct-4x4096",
             "zamba2-7b-instruct-64x256")
#: (name, B, H, K, S, hd, dtype, window, softcap): decode attention; pos
#: is near the end of the cache for zamba2 and moonshot (as their decode
#: paths put it), anywhere (0 included) else. The f32 case at zamba2's
#: shape resolves single keys (see decode_tol).
DECODE_CASES = [
    ("zamba2-7b", 4, 32, 32, 32768, 112, torch.bfloat16, 0, 0.0),
    ("zamba2-7b-f32", 4, 32, 32, 32768, 112, torch.float32, 0, 0.0),
    ("gqa-window-softcap", 3, 8, 2, 1000, 64, torch.float32, 100, 30.0),
    ("gqa-bf16-ragged", 2, 16, 2, 4097, 128, torch.bfloat16, 0, 0.0),
    ("moonshot-v1-16b-a3b", 4, 16, 16, 4096, 128, torch.bfloat16, 0, 0.0),
]
#: decode cases timed beside their plain version and SDPA (the first is
#: the kernels line's main case)
DECODE_TIMED = ("zamba2-7b", "moonshot-v1-16b-a3b")
SEQ = 4096                        # prefill tokens of the model paths
DECODE_STEPS = 8
HYBRID_DECODE = (4, 32768)        # batch, cache length
SSM_DECODE_BATCH = 128
MOE_DECODE = (4, 4096)            # moonshot's batch, cache length (6.4 GB)
MLA_LAYERS = 2                    # deepseek-v2 cut: 1 dense + 1 MoE layer
MEDIA_FRAMES = 1024               # seamless's encoder frames a forward
MODEL_TOL = 2e-2                  # kernel vs plain logits, of max |logit|
MOE_F32_TOL = 1e-4                # the same for the f32 MoE model
NEW_SERVE_ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b",
                   "moonshot-v1-16b-a3b", "seamless-m4t-medium")
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


@functools.cache
def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == b.dtype and a.dtype in _BITS:
        a, b = a.view(_BITS[a.dtype]), b.view(_BITS[b.dtype])
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


def visible_pairs(Sq: int, causal: bool, window: int, Sk: int | None = None,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the masks leave visible, query row i at position
    ``q_offset + i`` against keys 0 .. Sk - 1 (Sk = Sq by default): the
    score entries whose work the attention must do."""
    Sk = Sq if Sk is None else Sk
    total = 0
    for q in range(q_offset, q_offset + Sq):
        hi = q + 1 if causal else Sk
        lo = max(0, q - window + 1) if window > 0 else 0
        total += hi - lo
    return total


def attn_bound(B, H, K, Sq, hd, dt, causal, window, Sk=None, q_offset=0):
    """(bound ms, bound_by, flops, bytes) of one attention call of q
    [B,H,Sq,hd] at ``q_offset`` against k and v [B,K,Sk,hd]: QK^T and PV
    over the visible entries at the peak rate of the inputs' type, and q,
    k, v read once and o written once at the HBM rate."""
    Sk = Sq if Sk is None else Sk
    flops = 4 * hd * visible_pairs(Sq, causal, window, Sk, q_offset) * B * H
    nbytes = (2 * B * H * Sq + 2 * B * K * Sk) * hd * (
        2 if dt == torch.bfloat16 else 4)
    rate = BF16_OPS_PER_S if dt == torch.bfloat16 else FP32_OPS_PER_S
    ops_ms, bytes_ms = 1e3 * flops / rate, 1e3 * nbytes / HBM_BYTES_PER_S
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def library_attention(q, k, v, causal, window, cap, q_offset=0, scale=None):
    """One ``scaled_dot_product_attention`` call computing the same
    function (k and v expanded to the query heads beforehand, the scores
    scaled by ``scale``, hd ** -0.5 where None), q row i at
    position ``q_offset + i``, or None where the soft-cap has no
    counterpart there. A causal share that ends at the last key takes
    ``causal_lower_right``; a window, or a share that ends before it, a
    boolean mask."""
    if cap > 0:
        return None
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    Sq, Sk = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    ke = k.repeat_interleave(group, dim=1)
    ve = v.repeat_interleave(group, dim=1)
    if window == 0 and (not causal or (q_offset == 0 and Sq == Sk)):
        return lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                      is_causal=causal,
                                                      scale=scale)
    if window == 0 and q_offset + Sq == Sk:
        mask = causal_lower_right(Sq, Sk)
    else:
        diff = (q_offset + torch.arange(Sq, device=q.device)[:, None]
                - torch.arange(Sk, device=q.device)[None, :])
        mask = diff < window if window > 0 else diff >= 0
        if causal:
            mask &= diff >= 0
    return lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask,
                                                  scale=scale)


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
    _, B, S, H, G, P, N, dt = case
    rows = (B, S, G, N) if G else (B, S, N)
    g = torch.Generator(dev).manual_seed(3000 + i)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    import torch.nn.functional as F

    x = randn(B, S, H, P)
    dtv = F.softplus(randn(B, S, H) + dt_bias(H, dev))
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    return (x.to(dt), dtv.contiguous(), A, randn(*rows).to(dt),
            randn(*rows).to(dt))


def decode_inputs(i, case, dev):
    """Seeded q [B,H,hd], caches [B,S,K,hd] and pos [B] int32."""
    name, B, H, K, S, hd, dt, *_ = case
    g = torch.Generator(dev).manual_seed(4000 + i)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dt)
    k = torch.randn((B, S, K, hd), generator=g, device=dev, dtype=dt)
    v = torch.randn((B, S, K, hd), generator=g, device=dev, dtype=dt)
    if name.startswith(("zamba2-7b", "moonshot")):
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
    _, B, S, H, G, P, N, dt = case
    e = 2 if dt == torch.bfloat16 else 4
    nbytes = (2 * B * S * H * P * e + B * S * H * 4 + H * 4
              + 2 * B * S * max(G, 1) * N * e)
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
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        ker = placement.fused_place(*to_card(case, dev), counts=counts)
        torch.cuda.synchronize()
        same = [bit_equal(r, k) for r, k in zip(ref, ker)]
        want_counts = [int(case[7].sum()), int(ref[3].sum())]
        err = max(err, max_abs_err(ref, ker))
        emit({"phase": "kernel", "kernel": "fused_place", "case": name,
              "B": len(case[0]), "outputs_bit_identical": same,
              "max_abs_err": err, "ok_rows": int(ref[3].sum()),
              "dropped": int(ref[8].sum()),
              "use4_rows": int((ref[3] & ref[7]).sum()),
              "counts": counts.tolist(), "counts_want": want_counts})
        check(all(same), f"fused_place differs from its plain version "
                         f"in case {name}: {same}")
        check(counts.tolist() == want_counts,
              f"fused_place counted {counts.tolist()} rows attempted and "
              f"committed in case {name}, not {want_counts}")
        if name.startswith("all-do-false"):
            kept = [bit_equal(k, x) for k, x in
                    zip(ker[:3], to_card(case[:3], dev))]
            check(not ker[3].any() and all(kept),
                  f"fused_place committed a do = false row: {kept}")
    return err


def time_fused_place(dev, case=None) -> dict:
    """Phase 13 for ``fused_place`` at the fleet's B (or on ``case``): its
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


def big_hp_case(B: int, seed: int, dev: int = 0, do_rate: float = 0.8):
    """A ``fanout_commit`` case of ``B`` rows made cheaply at any size: the
    windows of ``random_hp_case(B_MAIN)`` tiled to B rows, a slot and a
    ``do`` drawn for every row, the hand-built HP rows of device ``dev``
    first."""
    import numpy as np

    from repro_torch.kernels.placement import cases

    small = cases.random_hp_case(B_MAIN, seed=seed)
    reps = -(-B // B_MAIN)
    t1, t2, valid, md = (np.concatenate([x] * reps)[:B] for x in small[:4])
    rng = np.random.default_rng(seed + 2000)
    s = rng.uniform(0, 60, B).astype(np.float32)
    e = (s + rng.uniform(0.5, 10, B)).astype(np.float32)
    do = rng.random(B) < do_rate
    return cases.with_hp_adversarial_rows((t1, t2, valid, md, s, e, do), dev)


def fanout_commit_cases():
    """(name, case, device committed on) of the ``fanout_commit`` checks:
    the fleet's B and the benchmark's B 524,288 with the hand-built HP rows
    first, a ragged batch, one replica, a ragged last block of 3 warps, a
    batch whose every row has do = false, and 6 devices."""
    from repro_torch.kernels.placement import cases

    adv = cases.with_hp_adversarial_rows
    off = adv(cases.random_hp_case(8 * 128 + 3, seed=14), 2)
    off[6][:] = False
    return [("fleet-8192", adv(cases.random_hp_case(B_MAIN, seed=10), 0), 0),
            ("fleet-8192-dev3", adv(cases.random_hp_case(B_MAIN, seed=11),
                                    3), 3),
            ("bench-524288", big_hp_case(HP_COMMIT_B, seed=17, dev=1), 1),
            ("ragged-37", adv(cases.random_hp_case(37, seed=12), 1), 1),
            ("one-replica", cases.random_hp_case(1, seed=13, do_rate=1.0),
             2),
            ("ragged-1027", adv(cases.random_hp_case(8 * 128 + 3, seed=15),
                                2), 2),
            ("all-do-false-1027", off, 2),
            ("six-devices-37", cases.random_hp_case(37, seed=16, dev=6), 5)]


def plain_fanout_commit(xs, d):
    """The plain version's first four outputs on a case's card tensors,
    committing on device ``d`` for an HP task."""
    from repro_torch.core.tensor_state import fanout_commit
    from repro_torch.kernels.placement.cases import HP

    full = lambda x: torch.full(xs[4].shape, x, dtype=torch.int32,
                                device=xs[4].device)
    return fanout_commit(*xs[:4], full(d), full(HP), *xs[4:])[:4]


def changed_slots(before, after):
    """Per row, whether any window entry's bits changed, and how many t1,
    t2 and valid entries changed in all."""
    rows = torch.zeros(before[0].shape[0], dtype=torch.bool,
                       device=before[0].device)
    n = []
    for a, b in zip(before[:3], after[:3]):
        diff = ~torch.eq(a.view(torch.int32) if a.is_floating_point() else a,
                         b.view(torch.int32) if b.is_floating_point() else b)
        rows |= diff.flatten(1).any(1)
        n.append(int(diff.sum()))
    return rows, n


def check_fanout_commit(dev) -> float:
    """Phase 3 for ``fanout_commit``: every output and every window bit for
    bit against the plain version at each of ``fanout_commit_cases``; the
    windows of do = false rows byte-identical to the input; the counter's
    rows committed equal to ``do.sum()`` and its rows changed to the
    plain version's. Returns the largest absolute difference (0)."""
    from repro_torch.kernels.placement import placement
    from repro_torch.kernels.placement.cases import HP

    err = 0.0
    for name, case, d in fanout_commit_cases():
        xs = to_card(case, dev)
        ref = plain_fanout_commit(xs, d)
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        mine = to_card(case, dev)
        ker = placement.fanout_commit(*mine[:4], d, HP, *mine[4:],
                                      counts=counts)
        torch.cuda.synchronize()
        same = [bit_equal(r, k) for r, k in zip(ref, ker)]
        in_place = all(k.data_ptr() == m.data_ptr()
                       for k, m in zip(ker[:3], mine[:3]))
        off = ~xs[6]
        kept = [bit_equal(k[off], x[off]) for k, x in zip(ker[:3], xs[:3])]
        changed, n_changed = changed_slots(xs, ref)
        want_counts = [int(xs[6].sum()), int(changed.sum())]
        err = max(err, max_abs_err(ref, ker))
        emit({"phase": "kernel", "kernel": "fanout_commit", "case": name,
              "B": len(case[4]), "device": d,
              "outputs_bit_identical": same, "in_place": in_place,
              "do_false_rows_kept": kept, "max_abs_err": err,
              "dropped": int(ref[3].sum()),
              "entries_changed_t1_t2_valid": n_changed,
              "counts": counts.tolist(), "counts_want": want_counts})
        check(all(same), f"fanout_commit differs from its plain version "
                         f"in case {name}: {same}")
        check(in_place, f"fanout_commit returned new windows in {name}")
        check(all(kept), f"fanout_commit wrote a do = false row in case "
                         f"{name}: {kept}")
        check(counts.tolist() == want_counts,
              f"fanout_commit counted {counts.tolist()} rows committed and "
              f"changed in case {name}, not {want_counts}")
        del xs, ref, mine, ker
    torch.cuda.empty_cache()
    return err


def time_fanout_commit(dev, case=None, d: int = 1) -> dict:
    """Phase 13 for ``fanout_commit`` at the benchmark's B 524,288 (or on
    ``case``, committing on device ``d``), every row committing: its device
    time a launch cold (L2 flushed by a 64 MB write after the windows'
    reset) and warm (right after the reset), the plain version's time and
    the byte bound. A committing row reads its device's three lists and
    its slot, ``min_dur`` and ``do``, and writes back the entries the
    commit changed; every row reads ``do`` and writes ``n_dropped``.
    ``bound_ms`` counts the entries that changed, ``bound_all_written_ms``
    all 864 bytes of every committing row."""
    from repro_torch.kernels.placement import placement
    from repro_torch.kernels.placement.cases import HP

    if case is None:
        case = big_hp_case(HP_COMMIT_B, seed=18, dev=d, do_rate=1.0)
    pristine = to_card(case, dev)
    work = [x.clone() for x in pristine]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)

    def reset():
        for w, p in zip(work[:3], pristine[:3]):
            w.copy_(p)

    def warm():
        reset()
        placement.fanout_commit(*work[:4], d, HP, *work[4:])

    def cold():
        reset()
        flush.zero_()
        placement.fanout_commit(*work[:4], d, HP, *work[4:])

    cold_ms, cold_seen = device_ms(cold, "fanout_commit_kernel")
    warm_ms, warm_seen = device_ms(warm, "fanout_commit_kernel")
    del flush
    plain_ms = cuda_ms(lambda: plain_fanout_commit(pristine, d), 3)
    ref = plain_fanout_commit(pristine, d)
    _, (n1, n2, nv) = changed_slots(pristine, ref)
    B, n_dev, n_cfg, T, W = case[0].shape
    n_do = int(case[6].sum())
    lists = n_cfg * T * W * (4 + 4 + 1)          # the device's 3 lists
    read = n_do * (lists + n_cfg * 4 + 4 + 4) + B * 1
    written = n1 * 4 + n2 * 4 + nv + B * 4
    bound_ms = 1e3 * (read + written) / HBM_BYTES_PER_S
    all_ms = 1e3 * (read + n_do * lists + B * 4) / HBM_BYTES_PER_S
    row = {"ms": cold_ms, "ms_warm": warm_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    emit({"phase": "timing", "kernel": "fanout_commit", "B": B,
          "committing_rows": n_do, **row,
          "device_events": {"cold": cold_seen, "warm": warm_seen},
          "bytes": read + written, "entries_changed_t1_t2_valid":
              [n1, n2, nv], "bound_all_written_ms": all_ms,
          "cold_share_of_bound": bound_ms / cold_ms,
          "warm_share_of_bound": bound_ms / warm_ms,
          "cold_gb_per_s": (read + written) / cold_ms / 1e6,
          "plain_over_kernel": plain_ms / cold_ms})
    del pristine, work, ref
    torch.cuda.empty_cache()
    return row


def hp_commit_phase(dev, values, bw) -> dict:
    """Phase 5b: the B 8,192 fleet through ``placement_backend="kernel"``
    and ``"ref"``, each under a device-timed timer: state and stats
    bit-identical, the HP commit counters equal, their rows committed the
    stats' ``hp_completed``; the kernel route launches ``fanout_commit``
    4 times a tick, the plain one nothing."""
    from repro_torch.fleet import FleetParams, fleet_run, make_fleet
    from repro_torch.obs import PhaseTimer

    F = values.shape[0]
    runs = {}
    for backend in ("kernel", "ref"):
        reset_counts()
        with PhaseTimer(device_time=True) as timer:
            t0 = time.perf_counter()
            state, stats = fleet_run(
                make_fleet(B_MAIN, device=dev), values, bw,
                params=FleetParams(placement_backend=backend))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[backend] = (fleet_leaves(state, stats),
                         timer.counters()["fleet/hp_commit"],
                         nonzero_counts(), int(stats.hp_completed.sum()),
                         wall, timer.phases()["fleet/hp"]["device_ms"])
    (lk, ck, nk, hk, wk, dk), (lr, cr, nr, hr, wr, dr) = (
        runs["kernel"], runs["ref"])
    diff = differing_leaves(lr, lk)
    committed = sum(c for c, _ in ck)
    emit({"phase": "hp_commit_fleet", "replicas": B_MAIN, "frames": F,
          "differing": diff, "hp_commit_counters": {"kernel": ck,
                                                    "ref": cr},
          "hp_completed": hk, "launches": {"kernel": nk, "ref": nr},
          "seconds": {"kernel": wk, "ref": wr},
          "hp_span_device_ms": {"kernel": dk, "ref": dr}})
    check(not diff, f"kernel and plain fleet runs differ in {diff}")
    check(ck == cr, f"HP commit counters differ: {ck} / {cr}")
    check(committed == hk == hr,
          f"the HP commits counted {committed}, the stats {hk} / {hr}")
    check(nk == fleet_launches(F) and nr == {},
          f"fleet launches by backend: {nk} / {nr}")
    return nk


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
            "fanout_commit": (placement, "launches_fanout_commit"),
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
               decode_batch: int, cache_len: int, seed: int, *,
               cfg=None, phase: str | None = None,
               reduced: tuple = ()) -> dict:
    """Phases 7 to 11: the config of ``arch`` (full unless ``cfg`` cuts it;
    bf16, random weights from ``seed``, drawn on the card): one forward of
    1 x SEQ tokens (the encoder-decoder's over MEDIA_FRAMES frames), then
    DECODE_STEPS decode steps from a state of ``init_decode_state(
    decode_batch, cache_len)`` whose caches (and memory) are filled from a
    seed and whose pos is ``cache_len - DECODE_STEPS``. Checks each
    kernel's launches against ``want_fwd`` (a forward) and ``want_step`` (a
    decode step), the logits' shape and finiteness, the aux loss's
    finiteness and the peak memory against the card's. Returns the
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model

    cfg = cfg or get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    model, build_s = timed(lambda: Model(cfg, seed=seed, device=dev,
                                         init_device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(dev).manual_seed(seed + 100)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=g,
                           device=dev)
    batch = {"tokens": tokens}
    if cfg.is_encoder_decoder:
        batch["media"] = torch.randn((1, MEDIA_FRAMES, cfg.d_model),
                                     generator=g, device=dev)
    with torch.no_grad():
        model({k: v[:, :cfg.ssm_chunk] for k, v in batch.items()})  # warm
        reset_counts()
        (logits, aux), fwd_s = timed(lambda: model(batch))
    fwd_counts = counts()
    check(tuple(logits.shape) == (1, SEQ, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch}: bad forward logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(aux)) and (float(aux) > 0) == cfg.uses_moe,
          f"{arch}: aux loss {float(aux)}")
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
    for key in ("k", "v", "ckv", "memory"):
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
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(dev).total_memory
    out = {"phase": phase or f"{cfg.arch_type}_path", "arch": arch,
           "params": n_params, "layers": cfg.n_layers,
           "encoder_layers": cfg.n_encoder_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "build_s": build_s, "forward_tokens": [1, SEQ],
           "forward_media_frames": batch["media"].shape[1]
           if "media" in batch else 0,
           "forward_ms": 1e3 * fwd_s, "forward_aux": float(aux),
           "forward_launches": fwd_counts,
           "decode_batch": decode_batch, "decode_cache_len": cache_len,
           "decode_state_gb": sum(v.numel() * v.element_size()
                                  for v in state.values()) / 1e9,
           "decode_step_ms": [1e3 * x for x in step_s],
           "decode_launches": step_counts,
           "max_memory_allocated_gb": peak / 1e9,
           "device_memory_gb": card / 1e9,
           "reduced": [f"forward B 1 x S {SEQ} (source shape "
                       "PREFILL_32K: B 32 x S 32768), for the time limit",
                       f"decode batch {decode_batch} (source DECODE_32K: "
                       "batch 128)" if decode_batch != 128 else
                       "decode at DECODE_32K's batch 128", *reduced]}
    emit(out)
    emit({**fwd_profile, "of": f"{arch} forward, 1 x {SEQ}"})
    emit({**step_profile, "of": f"{arch} decode step, batch {decode_batch}"})
    check(peak < card, f"{arch}: peak memory {peak} of the card's {card}")
    del model, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"forward": fwd_counts, "decode": step_counts}


def capture_routing(model) -> list:
    """Forward hooks on every MoE layer of ``model``: each call appends the
    layer's expert indices (``route`` of its input, as ``moe_ffn`` routes
    it) and the smallest gap between a token's k-th and (k+1)-th router
    probability. Returns the list the hooks fill; the hooks stay for the
    model's life."""
    from repro_torch.models.moe import route

    seen = []

    def hook(mod, args, out):
        x, k = args[0], args[1]
        probs, _, idx = route(x.reshape(-1, x.shape[-1]), mod.router, k)
        top = torch.sort(probs, dim=-1, descending=True).values
        seen.append((idx, (top[:, k - 1] - top[:, k]).min().item()))

    for block in model.layers:
        if block.is_moe:
            block.moe.register_forward_hook(hook)
    return seen


def model_plain_paths(dev):
    """Phase 12: each model built twice from one seed, on the kernels and
    on their plain versions, at full width and cut depth; logits within
    MODEL_TOL of the largest logit (bf16). The MoE model runs in f32: in
    bf16 the attention kernel and its plain version round differently, and
    a near-tie between a token's k-th and (k+1)-th expert can then route it
    elsewhere. There every MoE layer must route every token alike on both
    paths (``capture_routing``) and the logits agree within MOE_F32_TOL of
    the largest."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model

    rows = []
    for arch, cut, tol in (
            ("zamba2-7b", dict(n_layers=13), MODEL_TOL),
            ("falcon-mamba-7b", dict(n_layers=4), MODEL_TOL),
            ("moonshot-v1-16b-a3b", dict(n_layers=3, dtype="float32"),
             MOE_F32_TOL),
            ("seamless-m4t-medium", dict(n_layers=4, n_encoder_layers=4),
             MODEL_TOL)):
        cfg = dataclasses.replace(get_config(arch), **cut)
        g = torch.Generator(dev).manual_seed(11)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512),
                                         generator=g, device=dev)}
        if cfg.is_encoder_decoder:
            batch["media"] = torch.randn((2, 128, cfg.d_model), generator=g,
                                         device=dev)
        step_tokens = torch.randint(0, cfg.vocab_size, (4, 2), generator=g,
                                    device=dev)
        logits, secs, routing = {}, {}, {}
        for backend in ("auto", "ref"):
            model = Model(cfg, seed=7, device=dev, backend=backend,
                          init_device=dev)
            if cfg.uses_moe:
                routing[backend] = capture_routing(model)
            with torch.no_grad():
                (fwd, _), secs[backend] = timed(lambda: model(batch))
                out = [fwd.float()]
                if cfg.arch_type in ("hybrid", "audio"):
                    state = model.init_decode_state(2, 4096)
                    sg = torch.Generator(dev).manual_seed(12)
                    for key in ("k", "v", "memory"):
                        if key in state:
                            state[key].normal_(generator=sg)
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
        row = {"phase": "model_plain_path", "arch": arch, "dtype": cfg.dtype,
               "layers": cfg.n_layers, "tokens": [2, 512],
               "decode_steps": len(rel) - 1,
               "logits_err_over_max": rel, "tolerance": tol,
               "kernel_path_s": secs["auto"], "plain_path_s": secs["ref"]}
        if cfg.is_encoder_decoder:
            row.update(encoder_layers=cfg.n_encoder_layers,
                       media_frames=batch["media"].shape[1])
        if routing:
            same = [torch.equal(a, b) for (a, _), (b, _) in
                    zip(routing["auto"], routing["ref"])]
            row.update(moe_layers_routed=len(same),
                       routing_equal=all(same),
                       smallest_kth_gap=min(gap for _, gap in
                                            routing["auto"]))
        emit(row)
        if routing:
            check(len(same) == cfg.n_layers - cfg.first_dense_layers
                  and len(routing["ref"]) == len(same) and all(same),
                  f"{arch}: the kernel and plain paths route differently "
                  f"in MoE layers {[i for i, x in enumerate(same) if not x]}")
        check(max(rel) <= tol,
              f"{arch}: kernel and plain logits differ: {rel}")
        rows.append(row)
    return rows


def moe_mla_encdec_paths(dev) -> dict:
    """Phases 9 to 11: the full moonshot-v1-16b-a3b, deepseek-v2-236b at
    full width and cut depth, and the full seamless-m4t-medium through
    ``model_path``, each with the kernel launches its attention must make.
    Returns each path's launches for the kernels line."""
    from repro_torch.configs import get_config

    mcfg = get_config("moonshot-v1-16b-a3b")
    by_path = {}
    by_path["moonshot-v1-16b-a3b"] = model_path(
        "moonshot-v1-16b-a3b", dev,
        want_fwd={"flash_attention": mcfg.n_layers,
                  "flash_attention_wgmma": mcfg.n_layers,
                  "flash_attention_simt": 0, "flash_decode": 0},
        want_step={"flash_decode": mcfg.n_layers,
                   "flash_decode_split": mcfg.n_layers,
                   "flash_decode_combine": mcfg.n_layers,
                   "flash_attention": 0},
        decode_batch=MOE_DECODE[0], cache_len=MOE_DECODE[1], seed=2,
        phase="moe_path",
        reduced=(f"decode cache {MOE_DECODE[1]} (source DECODE_32K: 32768; "
                 f"batch 128 x 32768 would need a 1.65 TB cache)",))

    dcfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                               n_layers=MLA_LAYERS)
    no_attention_kernel = {"flash_attention": 0, "flash_decode": 0}
    by_path["deepseek-v2-236b"] = model_path(
        "deepseek-v2-236b", dev, want_fwd=no_attention_kernel,
        want_step=no_attention_kernel, decode_batch=HYBRID_DECODE[0],
        cache_len=HYBRID_DECODE[1], seed=3, cfg=dcfg, phase="mla_path",
        reduced=(f"depth {MLA_LAYERS} of 60 layers (1 dense + 1 MoE of 160 "
                 "experts); the full model is 471 GB of bf16",))

    scfg = get_config("seamless-m4t-medium")
    by_path["seamless-m4t-medium"] = model_path(
        "seamless-m4t-medium", dev,
        want_fwd={"flash_attention": scfg.n_layers,
                  "flash_attention_wgmma": scfg.n_layers,
                  "flash_decode": 0},
        want_step={"flash_decode": scfg.n_layers,
                   "flash_decode_split": scfg.n_layers,
                   "flash_decode_combine": scfg.n_layers,
                   "flash_attention": 0},
        decode_batch=HYBRID_DECODE[0], cache_len=HYBRID_DECODE[1], seed=4,
        phase="encdec_path",
        reduced=(f"encoder over {MEDIA_FRAMES} media frames a forward; "
                 f"decode memory {HYBRID_DECODE[1] // 4} frames",))
    return by_path


def serve_new_archs(dev) -> dict:
    """Phase 6 for the MoE, MLA and encoder-decoder archs: ``serve`` of
    each, reduced as ``serve`` reduces it (f32), through RAS for
    SERVE_PERIODS periods; ``flash_attention`` must launch once per causal
    self-attention layer of every forward (none for deepseek's MLA; the
    encoder and cross-attention launch nothing), every one on the SIMT
    route. Then one engine built twice from the same weights, on the
    kernel and on the plain attention, must give equal serving results.
    Returns each arch's launches for the kernels line."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tasks import FRAME_PERIOD
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import Model
    from repro_torch.serving import engine
    from repro_torch.serving.engine import ServeResult, ServingEngine
    from repro_torch.sim.traces import generate_trace

    tr = generate_trace("weighted2", SERVE_PERIODS, 4, seed=0)
    frames = [(d, int(tr.entries[f, d]), f * FRAME_PERIOD)
              for f in range(SERVE_PERIODS) for d in range(4)
              if tr.entries[f, d] >= 0]
    fields = [f.name for f in dataclasses.fields(ServeResult)
              if f.name != "logits_checksum"]
    by_path = {}
    for arch in NEW_SERVE_ARCHS:
        cfg = reduced(get_config(arch))
        per_forward = 0 if cfg.use_mla else cfg.n_layers
        torch.cuda.synchronize()
        reset_counts()
        engine.forwards = 0
        t0 = time.perf_counter()
        out = serve(arch=arch, frames=SERVE_PERIODS, scheduler="ras",
                    trace="weighted2", seed=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch, n_fwd = fa.launches, engine.forwards
        emit({"phase": "serving_path", "entry": "serve", **out,
              "reduced": ["reduced(config), as serve reduces every arch "
                          "but the waste pipeline"],
              "seconds": wall, "forward_passes": n_fwd,
              "flash_attention_launches": n_launch,
              "flash_attention_simt_launches": fa.launches_simt,
              "flash_decode_launches": counts()["flash_decode"]})
        check(n_fwd > 0 and n_launch == per_forward * n_fwd
              and fa.launches_simt == n_launch,
              f"{arch}: flash_attention launched {n_launch} times "
              f"({fa.launches_simt} SIMT) for {n_fwd} forward passes of "
              f"{per_forward} causal self-attention layers")
        check(out["frames_submitted"] > 0
              and 0.0 <= out["completion_rate"] <= 1.0,
              f"serve({arch}) gave {out}")
        by_path[f"serving {arch}"] = {"forwards": {
            "flash_attention": n_launch}}

        weights = Model(cfg, seed=0, device=dev).state_dict()
        results, sums = {}, {}
        for backend in ("kernel", "ref"):
            model = Model(cfg, device=dev, backend=backend)
            model.load_state_dict(weights)
            eng = ServingEngine(cfg, scheduler="ras", seed=0, device=dev,
                                model=model)
            results[backend] = [eng.submit_frame(i, src, n, now=now)
                                for i, (src, n, now) in enumerate(frames)]
            sums[backend] = sum(r.logits_checksum for r in results[backend])
        differing = sorted({f for a, b in zip(results["kernel"],
                                              results["ref"])
                            for f in fields if getattr(a, f) != getattr(b, f)})
        emit({"phase": "serving_plain_attention", "arch": arch,
              "frames": len(frames), "differing_fields": differing,
              "completion_rate": {b: sum(r.completed for r in rs) / len(rs)
                                  for b, rs in results.items()},
              "logits_checksum": sums})
        check(not differing,
              f"{arch}: kernel and plain serving differ in {differing}")
        del weights
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def time_new_kernels(dev, errs, decode_pos):
    """Phase 13 for the SSM, hybrid and MoE paths' kernels, at their main
    shapes: ms a launch, the plain version's ms, the bound and, for
    flash_decode, SDPA's ms."""
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssm_scan import ssm_scan as ssm
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    rows = {"ssd_cases": []}
    ssd_timed = [(i, c) for i, c in enumerate(SSD_CASES) if c[0] in SSD_TIMED]
    for kernel, (i, case), inputs, ker_fn, ref_fn, bound in (
            [("ssm_scan", (0, SSM_CASES[0]), ssm_inputs, ssm.ssm_scan,
              ssm_scan_ref, ssm_bound)]
            + [("ssd_scan", ic, ssd_inputs, ssd.ssd_scan, ssd_scan_ref,
                ssd_bound) for ic in ssd_timed]):
        xs = inputs(i, case, dev)
        bound_ms, bound_by, ops, nbytes = bound(case)
        ms = time_ms(lambda: ker_fn(*xs))
        row = {
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
            row["bound_terms"] = ssm_terms(case)
        else:
            row["groups"] = case[4]
            rows["ssd_cases"].append(row)
        rows.setdefault(kernel, row)
        emit({"phase": "timing", "kernel": kernel, **row})
        del xs
    rows["decode_cases"] = []
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
        if name in DECODE_TIMED:   # the model paths' shapes: the plain
            lib = library_decode(q, k, v, pos)   # version and SDPA
            row.update({
                "plain_ms": time_ms(lambda: decode_attention_ref(q, k, v,
                                                                 pos)),
                "library_ms": time_ms(lib) if lib is not None else None,
                "library_call": "scaled_dot_product_attention, boolean "
                                "mask, caches transposed to [B,K,S,hd] "
                                "outside the timed call, GQA not expanded "
                                "(G = 1)",
                "max_abs_err": errs["flash_decode"]})
            if i == 0:
                rows["flash_decode"] = row
            rows["decode_cases"].append(row)
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
    """Phase 13 for the window-query kernels, at every case: the kernel's
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
    """Phase 14: ``hp_place`` on every device and ``lp_place`` of 4 tasks
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
    """Phase 15: the launch checker's racy fixture on the card, the
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
    through the kernels: 21 placements, 4 HP queries and 4 HP commits a
    tick, every HP query on the vector route."""
    return {"fused_place": FUSED_PER_TICK * n_frames,
            "fanout_commit": HP_COMMITS_PER_TICK * n_frames,
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
    """Phase 16: the serial DES's RAS / WPS / HYB frame-completion rates
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
    """Phase 17: ``REPRO_SANITIZE=1`` on the card. The main fleet's B_MAIN
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
    counts one ``fleet/segment`` span a segment and the tick's phase
    spans, with telemetry off and on; a device-timed timer times every
    span on the card and counts ``fused_place``'s rows attempted and
    committed and ``fanout_commit``'s rows committed, at the same launches;
    with ``REPRO_PROFILE_DIR`` set a 5-tick run writes one
    ``torch.profiler`` trace naming the three fleet kernels; under ``profile_device``'s own profiler the hook passes
    through and the run still works."""
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
    reset_counts()
    with PhaseTimer(device_time=True) as timed:
        _, stats = fleet_run(make_fleet(B_MAIN, device=dev), values, bw,
                             params=params)
        torch.cuda.synchronize()
    timed_counts = nonzero_counts()
    phases = timed.phases()
    counters = timed.counters()["fleet/fused_place"]
    commits = int(stats.lp_completed.sum() + stats.hp_preempted.sum())
    hp_counters = timed.counters()["fleet/hp_commit"]
    hp_commits = int(stats.hp_completed.sum())

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
               for k in ("fused_place_kernel", "fanout_commit_kernel",
                         "window_query_kernel")}
    emit({"phase": "profile", "replicas": B_MAIN, "frames": F,
          "spans_off": spans["off"], "spans_on": spans["on"],
          "device_timed": {"phases": phases, "counters": counters,
                           "commits": commits,
                           "hp_commit_counters": hp_counters,
                           "hp_completed": hp_commits,
                           "launches": timed_counts},
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
    want_spans = {"fleet/segment", "fleet/tick", "fleet/requeue",
                  "fleet/hp", "fleet/lp", "fleet/compaction"}
    check(set(spans["on"]) == set(spans["off"]) == want_spans,
          f"spans {sorted(spans['off'])} / {sorted(spans['on'])}")
    check(all(row["device_ms"] is not None for row in phases.values()),
          f"spans without device time: {phases}")
    check(sum(ok for _, ok in counters) == commits,
          f"fused_place counted {counters}, the stats {commits} commits")
    check(sum(do for do, _ in hp_counters) == hp_commits,
          f"fanout_commit counted {hp_counters}, the stats {hp_commits} "
          f"HP commits")
    check(timed_counts == fleet_launches(F),
          f"the device-timed run launched {timed_counts}")
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
    one card; 21 + 4 + 4 launches a tick; and the per-cell reduction of one
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


TRAIN_SEQ = 4096                  # tokens a training step (batch 1)
TRAIN_STEPS = 5                   # steps of the full qwen2.5-3b
SCAN_TRAIN_STEPS = 3              # steps of the cut zamba2 and falcon-mamba
SSM_TRAIN_SEQ = 1024              # falcon-mamba's: its backward steps
#                                   through ssm_scan_ref
TRAIN_LOSS_RTOL = 1e-5            # kernel vs plain path, f32
TRAIN_GRAD_TOL = 1e-3             # kernel vs plain gradient, of a leaf's max
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"   # git-ignored


def training_model(cfg, dev, seed: int, backend: str = "auto"):
    """``Model(cfg)`` drawn on the card with every parameter trainable."""
    from repro_torch.models.transformer import Model

    model = Model(cfg, seed=seed, device=dev, backend=backend,
                  init_device=dev)
    return model.requires_grad_(True)


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def train_leg(arch: str, cfg, dev, seq: int, steps: int, want: dict,
              reduced: tuple = ()) -> dict:
    """Phase 22 for one config: ``train`` (the entry point a user calls) of
    ``steps`` steps of 1 x ``seq`` tokens, every loss and grad norm
    finite and each kernel's launches ``want[name]`` a step; then the same
    model redrawn and two more steps of ``train_step`` timed one by one
    (launches counted a step) and one profiled. Returns the entry point's
    launches."""
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.launch.train import train, train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    free_card()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (hist, train_s) = timed(lambda: train(
        arch, config=cfg, batch=1, seq=seq, steps=steps, log_every=1,
        device=dev))
    run_counts = counts()
    peak_train = torch.cuda.max_memory_allocated()
    check(len(hist) == steps and all(
        math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
        for r in hist), f"{arch}: train history {hist}")
    for name, n in want.items():
        check(run_counts[name] == n * steps,
              f"{arch}: {name} launched {run_counts[name]} times in "
              f"{steps} steps of train(), not {n} a step")

    free_card()
    model = training_model(cfg, dev, seed=0)
    opt_cfg = AdamWConfig(total_steps=steps)
    opt = adamw_init(model)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticCorpus(cfg, seq, 1, seed=0).batch(0).items()}
    step_s, step_counts = [], []
    for _ in range(2):
        reset_counts()
        (_, gnorm), s_ = timed(lambda: train_step(model, opt_cfg, opt,
                                                  batch))
        step_s.append(s_)
        step_counts.append(nonzero_counts())
        check(math.isfinite(float(gnorm)), f"{arch}: grad norm {gnorm}")
    for c in step_counts:
        for name, n in want.items():
            check(c.get(name, 0) == n, f"{arch}: {name} launched "
                                       f"{c.get(name, 0)} times a step, "
                                       f"not {n}")
    prof = profile_device(lambda: train_step(model, opt_cfg, opt, batch),
                          f"{arch} train step")
    peak = max(peak_train, torch.cuda.max_memory_allocated())
    card = torch.cuda.get_device_properties(dev).total_memory
    n_params = sum(p.numel() for p in model.parameters())
    elapsed = [r["elapsed_s"] for r in hist]
    row = {"phase": "train_path", "arch": arch, "params": n_params,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "tokens_a_step": [1, seq], "steps": steps,
           "entry": "launch.train.train", "train_s": train_s,
           "history": hist,
           "ms_a_step_from_history": 1e3 * (elapsed[-1] - elapsed[0])
           / (steps - 1),
           "launches": run_counts, "launches_a_step": want,
           "timed_step_ms": [1e3 * x for x in step_s],
           "timed_step_launches": step_counts,
           "tokens_per_s": seq / min(step_s),
           "max_memory_allocated_gb": peak / 1e9,
           "device_memory_gb": card / 1e9, "reduced": list(reduced)}
    emit(row)
    emit({**prof, "of": f"{arch} train step, 1 x {seq}"})
    check(peak < card, f"{arch}: peak memory {peak} of the card's {card}")
    del model, opt, batch
    free_card()
    return run_counts


def backward_recompute_ms(dev) -> dict:
    """The backward of each differentiated kernel route at its training
    leg's shape: ms a call of the autograd function's backward, which
    recomputes the plain version and takes its vjp (no kernel launch)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import attention_op
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_op
    from repro_torch.models.transformer import _ssm_dims

    g = torch.Generator(dev).manual_seed(21)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            dtype)

    zcfg, fcfg = (get_config(a) for a in ("zamba2-7b", "falcon-mamba-7b"))
    zd, fd = _ssm_dims(zcfg), _ssm_dims(fcfg)
    H, P, N, di = zd.n_heads, zd.head_dim, zd.d_state, fd.d_inner
    cases = {
        "flash_attention": ("qwen2.5-3b layer, B 1 x S 4096, H 16 / K 2, "
                            "hd 128, bf16",
                            attention_op, lambda: [
                                rand(1, 16, TRAIN_SEQ, 128),
                                rand(1, 2, TRAIN_SEQ, 128),
                                rand(1, 2, TRAIN_SEQ, 128)], {}),
        "ssd_scan": (f"zamba2-7b block, B 1 x S {TRAIN_SEQ}, H {H}, P {P}, "
                     f"N {N}, bf16", ssd_scan_op, lambda: [
                         rand(1, TRAIN_SEQ, H, P),
                         torch.rand((1, TRAIN_SEQ, H), generator=g,
                                    device=dev) * 0.1 + 0.01,
                         -torch.rand((H,), generator=g, device=dev) - 0.5,
                         rand(1, TRAIN_SEQ, N, scale=0.3),
                         rand(1, TRAIN_SEQ, N, scale=0.3)],
                     {"chunk": zcfg.ssm_chunk}),
        "ssm_scan": (f"falcon-mamba-7b block, B 1 x S {SSM_TRAIN_SEQ}, "
                     f"di {di}, N {fcfg.ssm_state}, bf16",
                     ssm_scan_op, lambda: [
                         rand(1, SSM_TRAIN_SEQ, di),
                         (torch.rand((1, SSM_TRAIN_SEQ, di), generator=g,
                                     device=dev) * 0.1 + 0.01).bfloat16(),
                         -torch.rand((di, fcfg.ssm_state), generator=g,
                                     device=dev) - 0.5,
                         rand(1, SSM_TRAIN_SEQ, fcfg.ssm_state),
                         rand(1, SSM_TRAIN_SEQ, fcfg.ssm_state)], {}),
    }
    rows = {}
    for name, (case, op, make, kw) in cases.items():
        xs = [x.requires_grad_(True) for x in make()]
        y = op(*xs, backend="kernel", **kw)
        dy = torch.randn(y.shape, generator=g, device=dev).to(y.dtype)
        call = lambda: torch.autograd.grad(y, xs, dy, retain_graph=True)
        reset_counts()
        call()
        torch.cuda.synchronize()
        launched = nonzero_counts()
        ms = time_ms(call, budget_ms=1000.0)
        rows[name] = {"case": case, "backward_ms": ms,
                      "backward_launches": launched}
        emit({"phase": "train_backward", "kernel": name, **rows[name]})
        check(not launched, f"{name}: its backward launched {launched}")
        del xs, y, dy
        free_card()
    return rows


def train_vs_plain(dev) -> list:
    """Phase 22 (c): f32 at full width and cut depth, one forward and
    backward of ``Model.loss`` on the kernels (attention on the SIMT
    route) and on their plain versions from the same weights: the loss
    within TRAIN_LOSS_RTOL, every gradient leaf within TRAIN_GRAD_TOL of
    its max |plain|; then one AdamW step on each model from the same
    gradients leaves their weights equal bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    rows = []
    for arch, cut in (("qwen2.5-3b", dict(n_layers=2)),
                      ("zamba2-7b", dict(n_layers=6)),
                      ("falcon-mamba-7b", dict(n_layers=2))):
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 SyntheticCorpus(cfg, 512, 1, seed=5).batch(0).items()}
        models, losses, grads, launched = {}, {}, {}, {}
        for backend in ("kernel", "ref"):
            model = training_model(cfg, dev, seed=7, backend=backend)
            reset_counts()
            loss = model.loss(batch)
            loss.backward()
            torch.cuda.synchronize()
            launched[backend] = nonzero_counts()
            losses[backend] = loss.item()
            grads[backend] = {k: torch.zeros_like(p) if p.grad is None
                              else p.grad.clone()
                              for k, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            models[backend] = model
        rel = {k: ((grads["kernel"][k] - g).abs().max()
                   / g.abs().max().clamp_min(1e-30)).item()
               for k, g in grads["ref"].items()}
        worst = max(rel, key=rel.get)
        loss_rel = abs(losses["kernel"] - losses["ref"]) / abs(losses["ref"])
        for model in models.values():
            opt = adamw_init(model)
            adamw_update(AdamWConfig(lr=1e-3, warmup_steps=0),
                         grads["kernel"], opt, model)
        differ = [k for k, p in models["kernel"].named_parameters()
                  if not bit_equal(p.detach(),
                                   models["ref"].get_parameter(k).detach())]
        row = {"phase": "train_plain_path", "arch": arch, "dtype": "float32",
               "layers": cfg.n_layers, "tokens": [1, 512],
               "loss": losses, "loss_rel_err": loss_rel,
               "loss_tolerance": TRAIN_LOSS_RTOL,
               "grad_leaves": len(rel), "worst_grad_leaf": worst,
               "worst_grad_err_over_max": rel[worst],
               "grad_tolerance": TRAIN_GRAD_TOL,
               "launches": launched,
               "adamw_step_params_differing": differ}
        emit(row)
        check(launched["ref"] == {} and launched["kernel"],
              f"{arch}: launches by backend {launched}")
        check(launched["kernel"].get("flash_attention", 0)
              == launched["kernel"].get("flash_attention_simt", 0),
              f"{arch}: f32 attention off the SIMT route: "
              f"{launched['kernel']}")
        check(loss_rel <= TRAIN_LOSS_RTOL,
              f"{arch}: kernel and plain losses differ: {losses}")
        check(rel[worst] <= TRAIN_GRAD_TOL,
              f"{arch}: gradient {worst} differs by {rel[worst]} of its "
              f"max")
        check(not differ, f"{arch}: one AdamW step from equal gradients "
                          f"gave other weights in {differ}")
        rows.append(row)
        del models, grads, batch
        free_card()
    return rows


def checkpoint_round_trip(dev) -> dict:
    """Phase 22 (d): the full-width qwen2.5-3b cut to 2 layers, bf16,
    saved under the git-ignored build/ and restored into a differently
    seeded model: every leaf equal bit for bit; the directory removed."""
    import shutil

    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2)
    model = training_model(cfg, dev, seed=5)
    other = training_model(cfg, dev, seed=6)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        _, save_s = timed(lambda: save(str(CKPT_DIR), model, step=3,
                                       extra={"arch": "qwen2.5-3b"}))
        nbytes = (CKPT_DIR / "params.npz").stat().st_size
        (_, step), restore_s = timed(lambda: restore(str(CKPT_DIR),
                                                     like=other))
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    want = model.state_dict()
    differ = [k for k, v in other.state_dict().items()
              if not bit_equal(v, want[k])]
    row = {"phase": "train_checkpoint", "arch": "qwen2.5-3b",
           "layers": cfg.n_layers, "dtype": cfg.dtype,
           "leaves": len(want), "npz_bytes": nbytes, "step": step,
           "save_s": save_s, "restore_s": restore_s, "differing": differ,
           "removed": not CKPT_DIR.exists()}
    emit(row)
    check(step == 3 and not differ,
          f"checkpoint round trip: step {step}, differing {differ}")
    del model, other
    free_card()
    return row


def train_phase(dev) -> tuple[dict, dict]:
    """Phase 22: training through ``launch.train.train`` on the card.
    (a) the full qwen2.5-3b, (b) zamba2-7b cut to 13 blocks and
    falcon-mamba-7b cut to 2 layers, with each rematted block's kernels
    launched again in the backward's recomputation; (c) kernel path vs
    plain path in f32; (d) a bf16 checkpoint round trip; and each
    differentiated route's backward timed. Returns each leg's launches and
    the backward times."""
    from repro_torch.configs import get_config

    qcfg = get_config("qwen2.5-3b")
    L = qcfg.n_layers
    by_path = {"qwen2.5-3b train": {"steps": train_leg(
        "qwen2.5-3b", qcfg, dev, TRAIN_SEQ, TRAIN_STEPS,
        want={"flash_attention": 2 * L, "flash_attention_wgmma": 2 * L,
              "flash_attention_simt": 0},
        reduced=(f"batch 1 x {TRAIN_SEQ} tokens a step (source shape "
                 "TRAIN_4K: 256 x 4096), for one card",))}}
    zcfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=13)
    g = zcfg.shared_attn_every
    n_groups, rem = divmod(zcfg.n_layers, g)
    by_path["zamba2-7b train"] = {"steps": train_leg(
        "zamba2-7b", zcfg, dev, TRAIN_SEQ, SCAN_TRAIN_STEPS,
        want={"ssd_scan": 2 * n_groups * g + rem,
              "flash_attention": 2 * n_groups,
              "flash_attention_wgmma": 2 * n_groups},
        reduced=("depth 13 of 81 Mamba-2 blocks (2 groups of 6 with the "
                 "shared attention, 1 tail block)",
                 f"batch 1 x {TRAIN_SEQ} tokens a step"))}
    fcfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2)
    by_path["falcon-mamba-7b train"] = {"steps": train_leg(
        "falcon-mamba-7b", fcfg, dev, SSM_TRAIN_SEQ, SCAN_TRAIN_STEPS,
        want={"ssm_scan": 2 * fcfg.n_layers, "flash_attention": 0},
        reduced=("depth 2 of 64 Mamba-1 blocks",
                 f"batch 1 x {SSM_TRAIN_SEQ} tokens a step: the backward "
                 "steps through ssm_scan_ref one token at a time"))}
    train_vs_plain(dev)
    checkpoint_round_trip(dev)
    return by_path, backward_recompute_ms(dev)


DRY_PEAK_TOL = 0.10               # traced peak vs the plain route's card peak
DRY_TIMED_RUNS = 3                # kernel-route steps timed (median)
#: zamba2's plain-route prefill: its SSD is the step-by-step oracle
#: ``ssd_scan_ref``, 81 x 4096 steps at 1 x 4096 (107 s on an NVIDIA H100
#: 80GB HBM3 at 700 W)
DRY_PLAIN_SSD_SEQ = 1024


def dryrun_run(dev, cfg, shape, backend: str, runs: int, want: dict,
               rec: dict) -> dict:
    """``launch/dryrun.py::build``'s step of ``cfg`` at ``shape`` on the
    card (weights drawn there) on ``backend``, run ``runs`` times from a
    peak reset after the build. Checks the argument bytes against the
    record ``rec`` and the launches, ``want`` each run. Memory is counted
    from what the card held before the build (earlier phases leave some
    allocated), as the trace counts the step's own storages."""
    from repro_torch.launch.dryrun import build
    from repro_torch.roofline.trace import tensor_bytes

    free_card()
    base = torch.cuda.memory_allocated()
    step, args = build(cfg, shape, device=dev, backend=backend)
    arg_bytes = tensor_bytes(args)
    check(arg_bytes == rec["arg_bytes_global"],
          f"{cfg.name} {shape.name}: the card's argument bytes {arg_bytes}, "
          f"the record's {rec['arg_bytes_global']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    built = torch.cuda.memory_allocated() - base
    step_s = []
    for _ in range(runs):
        reset_counts()
        step_s.append(timed(step)[1])
        launched = nonzero_counts()
        check(launched == want, f"{cfg.name} {shape.name} ({backend}): "
                                f"launched {launched} a step, not {want}")
    peak = torch.cuda.max_memory_allocated() - base
    del step, args
    free_card()
    return {"step_s": step_s, "peak": peak, "built": built, "base": base,
            "arg_bytes": arg_bytes, "launches": launched}


def dryrun_leg(dev, arch: str, shape, want: dict, reduced: list,
               plain_shape=None) -> dict:
    """Phase 23 for one (arch, cut shape): ``dry_run_one`` on ``meta``,
    then the same step on the card: once on the plain route (at
    ``plain_shape`` when given, traced there too), where the traced peak
    must lie within DRY_PEAK_TOL of ``max_memory_allocated`` (reset
    after the build, less what the card held before it) and no kernel
    may launch; then on the kernel
    route, ``want`` launches a step, where the median of DRY_TIMED_RUNS
    steps (after one warm step) must take no less than the record's bound.
    The argument bytes of both runs must be their record's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import dry_run_one

    cfg = get_config(arch)
    rec = dry_run_one(arch, shape, mesh="1xH100", out_dir=None,
                      verbose=False)
    roof = rec["roofline"]
    bound_s = max(roof["compute_s"], roof["memory_s"])
    plain_shape = plain_shape or shape
    plain_rec = rec if plain_shape is shape else dry_run_one(
        arch, plain_shape, mesh="1xH100", out_dir=None, verbose=False)
    plain = dryrun_run(dev, cfg, plain_shape, "ref", 1, {}, plain_rec)
    kern = dryrun_run(dev, cfg, shape, "auto", 1 + DRY_TIMED_RUNS, want, rec)
    traced = plain_rec["memory"]["peak_size_in_bytes"]
    ratio = traced / plain["peak"]
    timed_s = sorted(kern["step_s"][1:])
    median_s = timed_s[len(timed_s) // 2]
    row = {"phase": "dryrun", "arch": arch, "shape": shape.name,
           "kind": shape.kind,
           "tokens": [shape.global_batch, shape.seq_len],
           "trace_s": rec["lower_s"],
           "dot_flops": roof["hlo_flops_per_chip"],
           "dot_bytes": roof["dot_bytes_per_chip"],
           "model_flops": roof["model_flops"],
           "compute_ms": 1e3 * roof["compute_s"],
           "memory_ms": 1e3 * roof["memory_s"],
           "bound_ms": 1e3 * bound_s, "bottleneck": roof["bottleneck"],
           "arg_bytes": rec["arg_bytes_global"],
           "card_arg_bytes": kern["arg_bytes"],
           "allocated_before_build": kern["base"],
           "allocated_after_build": kern["built"],
           "traced_peak_gb": rec["memory"]["peak_size_in_bytes"] / 1e9,
           "kernel_peak_gb": kern["peak"] / 1e9,
           "kernel_step_ms": [1e3 * x for x in kern["step_s"]],
           "kernel_step_ms_median": 1e3 * median_s,
           "kernel_share_of_bound": bound_s / median_s,
           "kernel_launches": kern["launches"],
           "plain_shape": plain_shape.name,
           "plain_trace_s": plain_rec["lower_s"],
           "plain_traced_peak_gb": traced / 1e9,
           "plain_peak_gb": plain["peak"] / 1e9,
           "traced_over_plain_peak": ratio,
           "plain_step_ms": 1e3 * plain["step_s"][0],
           "reduced": reduced}
    emit(row)
    check(abs(ratio - 1.0) <= DRY_PEAK_TOL,
          f"{arch} {plain_shape.name}: traced peak {traced}, the plain "
          f"route's {plain['peak']} on the card ({ratio:.3f})")
    check(median_s >= bound_s,
          f"{arch} {shape.name}: the kernel route's step {median_s} s beats "
          f"its bound {bound_s} s: the trace undercounts")
    return kern["launches"]


def dryrun_phase(dev) -> dict:
    """Phase 23: the dry run held to the card. The full qwen2.5-3b's
    training step at 1 x TRAIN_SEQ and the full zamba2-7b's prefill at 1 x
    SEQ (its plain route at 1 x DRY_PLAIN_SSD_SEQ), each traced on
    ``meta`` and run on the card (``dryrun_leg``). Returns each leg's
    kernel-route launches a step."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import InputShape

    qcfg = get_config("qwen2.5-3b")
    zcfg = get_config("zamba2-7b")
    L = qcfg.n_layers
    n_attn = zcfg.n_layers // zcfg.shared_attn_every
    return {
        "qwen2.5-3b train step": dryrun_leg(
            dev, "qwen2.5-3b",
            InputShape(f"train_1x{TRAIN_SEQ}", TRAIN_SEQ, 1, "train"),
            {"flash_attention": 2 * L, "flash_attention_wgmma": 2 * L},
            [f"batch 1 x {TRAIN_SEQ} (source shape TRAIN_4K: 256 x 4096)"]),
        "zamba2-7b prefill": dryrun_leg(
            dev, "zamba2-7b",
            InputShape(f"prefill_1x{SEQ}", SEQ, 1, "prefill"),
            {"ssd_scan": zcfg.n_layers, "flash_attention": n_attn,
             "flash_attention_wgmma": n_attn},
            [f"batch 1 x {SEQ} (source shape PREFILL_32K: 32 x 32768)",
             f"the plain route at 1 x {DRY_PLAIN_SSD_SEQ}: its SSD steps "
             "through ssd_scan_ref one token at a time"],
            plain_shape=InputShape(f"prefill_1x{DRY_PLAIN_SSD_SEQ}",
                                   DRY_PLAIN_SSD_SEQ, 1, "prefill")),
    }


MESH_TIMED_STEPS = 3              # train steps timed on each route, each
#                                   route's first (untimed) step before them
MESH_TIMED_CALLS = 3              # prefill calls timed, after one untimed
MESH_DECODE = (4, 4096)           # zamba2's decode batch and cache length


def mesh_group():
    """A world-size-1 NCCL group (a ``TCPStore`` on a free localhost port)
    and the 1 x 1 mesh over it."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    store = dist.TCPStore("localhost", port, 1, is_master=True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    return make_host_mesh()


def prefill_on_mesh(model, batch: dict, mesh, cfg) -> dict:
    """``model`` placed on ``mesh`` in place per ``launch/sharding.py``'s
    prefill specs; returns ``batch`` placed there."""
    from repro_torch import spmd
    from repro_torch.launch import sharding
    from repro_torch.models.config import InputShape

    sharding.configure_attention_sharding(mesh, cfg, "prefill")
    sharding.configure_moe_sharding(mesh, cfg)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    spmd.distribute_model(model, mesh, sharding.param_specs(
        mesh, cfg, shapes, "prefill"))
    B, S = batch["tokens"].shape
    return spmd.distribute_tree(batch, mesh, sharding.batch_specs(
        mesh, cfg, InputShape("mesh", S, B, "prefill"), batch))


def local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def timed_steps(model, opt, batch) -> list:
    """(ms, launches) of each of MESH_TIMED_STEPS train steps, after one
    untimed step."""
    from repro_torch.launch.train import train_step
    from repro_torch.optim.adamw import AdamWConfig

    cfg_opt = AdamWConfig(total_steps=MESH_TIMED_STEPS + 1)
    out = []
    for i in range(MESH_TIMED_STEPS + 1):
        reset_counts()
        (_, gnorm), s_ = timed(lambda: train_step(model, cfg_opt, opt,
                                                  batch))
        check(math.isfinite(float(local(gnorm))), f"grad norm {gnorm}")
        if i:
            out.append((1e3 * s_, nonzero_counts()))
    return out


def host_profile(fn, label: str) -> dict:
    """Where one call of ``fn`` spends the host's time: cProfile's own
    time of each function, summed by where it lies (DTensor's package,
    the rest of torch, this repo, the C functions Python calls: aten ops
    and kernel launches), as shares of the profiled total; and the call's
    wall time under the profiler."""
    import cProfile
    import pstats

    def where(path: str) -> str:
        if path == "~":
            return "C functions (aten ops, launches)"
        if "torch/distributed/tensor" in path:
            return "DTensor (torch.distributed.tensor)"
        if "repro_torch" in path:
            return "repro_torch"
        return "rest of torch" if "/torch/" in path else "other"

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    own: dict = {}
    for (path, _, _), (_, _, tt, _, _) in pstats.Stats(prof).stats.items():
        own[where(path)] = own.get(where(path), 0.0) + tt
    total = sum(own.values())
    return {"phase": "host_profile", "of": label, "wall_ms": 1e3 * wall,
            "profiled_ms": 1e3 * total,
            "own_time_share": {k: v / total for k, v in sorted(
                own.items(), key=lambda kv: -kv[1])}}


def step_profiles(model, opt, batch, route: str) -> list:
    """One more train step under the profiler (the device's busy share)
    and one under cProfile (where the host's time goes), on ``route``."""
    from repro_torch.launch.train import train_step
    from repro_torch.optim.adamw import AdamWConfig

    cfg_opt = AdamWConfig(total_steps=MESH_TIMED_STEPS + 3)

    def step():
        train_step(model, cfg_opt, opt, batch)

    label = f"qwen2.5-3b train step, {route} route"
    dev_row = profile_device(step, label)
    return [{k: dev_row[k] for k in ("phase", "of", "wall_ms",
                                     "device_busy_ms", "device_busy_share")},
            host_profile(step, label)]


def mesh_train_leg(dev, mesh) -> dict:
    """The full qwen2.5-3b at 1 x TRAIN_SEQ: loss and gradients on both
    routes, then each route's timed steps and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.launch import sharding
    from repro_torch.launch.train import place_on_mesh
    from repro_torch.optim.adamw import adamw_init

    cfg = get_config("qwen2.5-3b")
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_wgmma": 2 * cfg.n_layers}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticCorpus(cfg, TRAIN_SEQ, 1, seed=0).batch(0).items()}
    rows = {}

    free_card()
    torch.cuda.reset_peak_memory_stats()
    model = training_model(cfg, dev, seed=0)
    reset_counts()
    loss = model.loss(batch)
    loss.backward()
    torch.cuda.synchronize()
    plain_counts = nonzero_counts()
    plain_loss = loss.detach()
    plain_grads = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt = adamw_init(model)
    rows["plain"] = timed_steps(model, opt, batch)
    plain_peak = torch.cuda.max_memory_allocated()
    profiles = step_profiles(model, opt, batch, "plain")
    del model, opt
    free_card()

    torch.cuda.reset_peak_memory_stats()
    model = training_model(cfg, dev, seed=0)
    opt, place_batch = place_on_mesh(mesh, cfg, model)
    strategy = sharding.pick_strategy(cfg, "train")
    mb = place_batch(batch)
    reset_counts()
    loss = model.loss(mb)
    loss.backward()
    torch.cuda.synchronize()
    mesh_counts = nonzero_counts()
    mesh_loss = local(loss.detach())
    differing, worst = [], 0.0
    for k, p in model.named_parameters():
        g, ref = local(p.grad), plain_grads[k]
        if not torch.equal(g, ref):
            err = (g.float() - ref.float()).abs().max().item()
            scale = max(ref.float().abs().max().item(), 1e-30)
            differing.append([k, err / scale])
            worst = max(worst, err / scale)
    model.zero_grad(set_to_none=True)
    del plain_grads
    rows["mesh"] = timed_steps(model, opt, mb)
    mesh_peak = torch.cuda.max_memory_allocated()
    profiles += step_profiles(model, opt, mb, "mesh")
    bit_equal = not differing and torch.equal(mesh_loss, plain_loss)
    loss_rel = abs(float(mesh_loss) - float(plain_loss)) / abs(
        float(plain_loss))
    emit({"phase": "mesh_train", "arch": "qwen2.5-3b", "mesh": "1x1",
          "strategy": strategy, "tokens_a_step": [1, TRAIN_SEQ],
          "loss_plain": float(plain_loss), "loss_mesh": float(mesh_loss),
          "bit_equal": bit_equal, "loss_rel_err": loss_rel,
          "differing_leaves": differing[:20],
          "n_differing_leaves": len(differing),
          "worst_leaf_rel_err": worst,
          "cause": None if bit_equal else "the mesh route's ops differ "
                                          "from the plain route's",
          "launches_plain": plain_counts, "launches_mesh": mesh_counts,
          "ms_a_step_plain": [r[0] for r in rows["plain"]],
          "ms_a_step_mesh": [r[0] for r in rows["mesh"]],
          "launches_a_timed_step_plain": [r[1] for r in rows["plain"]],
          "launches_a_timed_step_mesh": [r[1] for r in rows["mesh"]],
          "peak_gb_plain": plain_peak / 1e9, "peak_gb_mesh": mesh_peak / 1e9,
          "device_memory_gb": torch.cuda.get_device_properties(
              dev).total_memory / 1e9})
    for row in profiles:
        emit(row)
    for name, c in (("plain", plain_counts), ("mesh", mesh_counts),
                    *((f"{r} step", c) for r in rows
                      for _, c in rows[r])):
        check(c == want, f"qwen2.5-3b {name}: launched {c}, not {want}")
    check(bit_equal or (loss_rel <= TRAIN_LOSS_RTOL
                        and worst <= TRAIN_GRAD_TOL),
          f"qwen2.5-3b: the mesh route's loss {float(mesh_loss)} (plain "
          f"{float(plain_loss)}) and gradients ({differing[:5]}) differ")
    del model, opt, batch, mb
    free_card()
    return {"loss and backward": mesh_counts,
            "timed steps": {k: sum(c.get(k, 0) for _, c in rows["mesh"])
                            for k in want}}


def timed_calls(fn) -> tuple:
    """(output of the first call, launches of each call, ms of each of
    MESH_TIMED_CALLS calls after the first, untimed one)."""
    out, launched, ms = None, [], []
    for i in range(MESH_TIMED_CALLS + 1):
        reset_counts()
        y, s_ = timed(fn)
        launched.append(nonzero_counts())
        if i:
            ms.append(1e3 * s_)
        else:
            out = y
    return out, launched, ms


def mesh_prefill_leg(dev, mesh, arch: str, cfg, seq: int,
                     want: dict, q_hint: str | None = None) -> dict:
    """``arch`` at cut depth, 1 x ``seq``: the forward on the plain route,
    then the same model placed on the mesh, with the attention hint set
    to ``q_hint`` when one is given: logits equal, every call's launches
    ``want``; each route timed after a first, untimed call."""
    from repro_torch.models.layers import set_attention_q_sharding

    free_card()
    model = training_model(cfg, dev, seed=0).requires_grad_(False)
    g = torch.Generator(dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, seq),
                                     generator=g, device=dev,
                                     dtype=torch.int32)}
    with torch.no_grad():
        plain, plain_counts, plain_ms = timed_calls(
            lambda: model(batch)[0])
        mb = prefill_on_mesh(model, batch, mesh, cfg)
        if q_hint is not None:
            set_attention_q_sharding(q_hint)
        meshed, mesh_counts, mesh_ms = timed_calls(
            lambda: local(model(mb)[0]))
    set_attention_q_sharding(None)
    equal = torch.equal(plain, meshed)
    emit({"phase": "mesh_prefill", "arch": arch, "layers": cfg.n_layers,
          "tokens": [1, seq], "mesh": "1x1", "q_hint": q_hint,
          "logits_bit_equal": equal,
          "max_abs_err": max_abs_err([plain], [meshed]),
          "launches_plain": plain_counts[0], "launches_mesh": mesh_counts[0],
          "ms_plain": plain_ms, "ms_mesh": mesh_ms,
          "timed_after_one_untimed_call": True})
    check(all(c == want for c in plain_counts + mesh_counts),
          f"{arch}: launched {plain_counts} plain, {mesh_counts} on the "
          f"mesh, not {want} a call")
    check(equal, f"{arch}: the mesh route's logits differ")
    del model, plain, meshed
    free_card()
    return {"prefill": mesh_counts[0]}


def mesh_decode_leg(dev, mesh, arch: str, cfg, want: dict) -> dict:
    """``arch`` at cut depth: DECODE_STEPS decode steps of MESH_DECODE's
    batch from the end of a cache filled with N(0, 1), on the plain route
    and then with the model placed by the decode specs and the state by
    ``decode_state_specs``: every step's logits and the final state equal,
    every step's launches ``want``; the first step of each route is its
    untimed warm-up."""
    from repro_torch import spmd
    from repro_torch.launch import sharding
    from repro_torch.models.config import InputShape

    b, S = MESH_DECODE
    free_card()
    model = training_model(cfg, dev, seed=0).requires_grad_(False)
    g = torch.Generator(dev).manual_seed(0)
    state0 = model.init_decode_state(b, S)
    for key in ("k", "v", "ckv"):
        if key in state0:
            state0[key].normal_(generator=g)
    state0["pos"].fill_(S - DECODE_STEPS)
    toks = torch.randint(0, cfg.vocab_size, (DECODE_STEPS, b), generator=g,
                         device=dev)

    def run(state, place_tok):
        logits, launched, ms = [], [], []
        with torch.no_grad():
            for t in toks:
                reset_counts()
                (lg, state), s_ = timed(
                    lambda: model.decode_step(state, place_tok(t)))
                launched.append(nonzero_counts())
                logits.append(local(lg))
                ms.append(1e3 * s_)
        return logits, launched, ms[1:], state

    plain, plain_counts, plain_ms, plain_state = run(
        {k: v.clone() for k, v in state0.items()}, lambda t: t)
    sharding.configure_attention_sharding(mesh, cfg, "decode")
    sharding.configure_moe_sharding(mesh, cfg)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    spmd.distribute_model(model, mesh, sharding.param_specs(
        mesh, cfg, shapes, "decode"))
    shape = InputShape("mesh_decode", S, b, "decode")
    state = spmd.distribute_tree(state0, mesh, sharding.decode_state_specs(
        mesh, cfg, shape, state0))
    tok_spec = sharding.batch_specs(mesh, cfg, shape, {"t": toks[0]})["t"]
    meshed, mesh_counts, mesh_ms, state = run(
        state, lambda t: spmd.distribute(t, mesh, tok_spec))
    equal = all(torch.equal(x, y) for x, y in zip(plain, meshed))
    differing_state = [k for k in plain_state
                       if not torch.equal(local(state[k]), plain_state[k])]
    emit({"phase": "mesh_decode", "arch": arch, "layers": cfg.n_layers,
          "batch": b, "cache": S, "steps": DECODE_STEPS, "mesh": "1x1",
          "logits_bit_equal": equal, "differing_state": differing_state,
          "max_abs_err": max_abs_err(plain, meshed),
          "launches_a_step_plain": plain_counts[0],
          "launches_a_step_mesh": mesh_counts[0],
          "ms_a_step_plain": plain_ms, "ms_a_step_mesh": mesh_ms,
          "timed_after_one_untimed_step": True})
    check(all(c == want for c in plain_counts + mesh_counts),
          f"{arch} decode: launched {plain_counts} plain, {mesh_counts} on "
          f"the mesh, not {want} a step")
    check(equal and not differing_state,
          f"{arch} decode: the mesh route's logits (equal: {equal}) or "
          f"state ({differing_state}) differ")
    del model, state, state0, plain_state
    free_card()
    return {"decode steps": {k: sum(c.get(k, 0) for c in mesh_counts)
                             for k in want}}


def mesh_sequence_shards(dev, mesh) -> None:
    """``decode_attention_op`` of a cache placed ``Shard(1)`` (its
    sequence) on the mesh's ``model`` dim: the split pass over the rank's
    slice, the partials gathered over that dim (one rank here), one
    combine; equal to the call on the plain tensors, one split and one
    combine launch a call, with and without a window."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.flash_decode.ops import decode_attention_op

    b, S = MESH_DECODE
    g = torch.Generator(dev).manual_seed(1)
    q = torch.randn((b, 32, 112), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((b, S, 32, 112), generator=g,
                        device=dev).bfloat16() for _ in range(2))
    pos = torch.tensor([S - 1, 2000, 100, 3000], dtype=torch.int32,
                       device=dev)
    seq, whole = [Replicate(), Shard(1)], [Replicate(), Replicate()]
    qd, pd = (DTensor.from_local(t, mesh, whole) for t in (q, pos))
    kd, vd = (DTensor.from_local(t, mesh, seq) for t in (k, v))
    want = {"flash_decode": 1, "flash_decode_split": 1,
            "flash_decode_combine": 1}
    rows = []
    for window in (0, 1000):
        reset_counts()
        ref = decode_attention_op(q, k, v, pos, window=window)
        plain_counts = nonzero_counts()
        reset_counts()
        got = local(decode_attention_op(qd, kd, vd, pd, window=window))
        mesh_counts = nonzero_counts()
        rows.append({"window": window, "bit_equal": torch.equal(got, ref),
                     "max_abs_err": max_abs_err([ref], [got]),
                     "launches_plain": plain_counts,
                     "launches_mesh": mesh_counts})
        check(plain_counts == mesh_counts == want,
              f"sequence shards: launched {plain_counts}, {mesh_counts}")
        check(torch.equal(got, ref), f"sequence shards, window {window}: "
                                     f"{rows[-1]['max_abs_err']}")
    emit({"phase": "mesh_sequence_shards", "cache": [b, S, 32, 112],
          "placements": str(seq), "rows": rows})


def mesh_refusals(dev, mesh) -> None:
    """A DTensor refuses every kernel wrapper (both passes of
    flash-decode), and the production mesh one card."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_decode.flash_decode import (
        flash_decode_combine,
        flash_decode_partials,
    )
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan
    from repro_torch.launch.mesh import make_production_mesh

    q = torch.zeros((1, 16, 256, 128), dtype=torch.bfloat16, device=dev)
    whole = DTensor.from_local(q, mesh, [Replicate(), Replicate()])
    dq = DTensor.from_local(q[:, 0], mesh, [Replicate(), Replicate()])
    pos = DTensor.from_local(torch.zeros(1, dtype=torch.int32, device=dev),
                             mesh, [Replicate(), Replicate()])
    refused = {}
    for name, fn, err in (
            ("DTensor into flash_attention",
             lambda: flash_attention(whole, whole, whole), TypeError),
            ("DTensor into flash_decode's split pass",
             lambda: flash_decode_partials(dq, whole, whole, pos), TypeError),
            ("DTensor into flash_decode's combine pass",
             lambda: flash_decode_combine(whole, whole, torch.bfloat16),
             TypeError),
            ("DTensor into ssd_scan",
             lambda: ssd_scan(whole, None, None, None, None), TypeError),
            ("DTensor into ssm_scan",
             lambda: ssm_scan(whole, None, None, None, None), TypeError),
            ("make_production_mesh on one card", make_production_mesh,
             ValueError)):
        reset_counts()
        try:
            fn()
        except err as e:
            refused[name] = str(e)
        check(name in refused, f"{name} was not refused")
        check(not nonzero_counts(), f"{name} launched {nonzero_counts()}")
    emit({"phase": "mesh_refusals", "refused": refused})


def mesh_records() -> list:
    """The qwen2.5-3b and granite-8b ``TRAIN_4K`` records on 16 x 16."""
    from repro_torch.launch.dryrun import dry_run_one

    out = []
    for arch in ("qwen2.5-3b", "granite-8b"):
        rec = dry_run_one(arch, "train_4k", out_dir=None, verbose=False)
        roof = rec["roofline"]
        row = {"phase": "mesh_record", "arch": arch, "shape": "train_4k",
               "mesh": rec["mesh"], "n_chips": rec["n_chips"],
               "trace_s": rec["lower_s"], "analytic": True,
               **{k: roof[k] for k in ("compute_s", "memory_s",
                                       "collective_s", "bottleneck",
                                       "hlo_flops_per_chip",
                                       "useful_flops_ratio",
                                       "wire_bytes_per_chip")},
               "argument_gb_a_chip": rec["memory"]["argument_size_in_bytes"]
               / 1e9,
               "peak_gb_a_chip": rec["memory"]["peak_size_in_bytes"] / 1e9,
               "collectives": rec["collectives"]}
        emit(row)
        check(rec["mesh"] == "16x16" and roof["collective_s"] > 0,
              f"{arch}: record {rec['mesh']}, {roof['collective_s']}")
        out.append(row)
    return out


@contextlib.contextmanager
def mesh_session():
    """``mesh_group()``'s 1 x 1 mesh for as long as the block runs; then
    both activation hints reset and the group torn down."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import reset_hints
    from repro_torch.models.config import TRAIN_4K

    mesh = mesh_group()
    try:
        yield mesh
    finally:
        reset_hints(get_config("qwen2.5-3b"), TRAIN_4K)
        dist.destroy_process_group()


def mesh_phase(dev, mesh) -> dict:
    """Phase 24: the production mesh's route on a 1 x 1 mesh held to the
    no-mesh route. Returns each leg's launches."""
    from repro_torch.configs import get_config

    zcfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=13)
    fcfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2)
    n_attn = zcfg.n_layers // zcfg.shared_attn_every
    launches = {
        "mesh qwen2.5-3b train": mesh_train_leg(dev, mesh),
        "mesh zamba2-7b prefill": mesh_prefill_leg(
            dev, mesh, "zamba2-7b", zcfg, SEQ,
            {"ssd_scan": zcfg.n_layers, "flash_attention": n_attn,
             "flash_attention_wgmma": n_attn}),
        "mesh falcon-mamba-7b prefill": mesh_prefill_leg(
            dev, mesh, "falcon-mamba-7b", fcfg, SSM_TRAIN_SEQ,
            {"ssm_scan": fcfg.n_layers}),
        "mesh zamba2-7b decode": mesh_decode_leg(
            dev, mesh, "zamba2-7b", zcfg,
            {"flash_decode": n_attn, "flash_decode_split": n_attn,
             "flash_decode_combine": n_attn}),
    }
    mesh_sequence_shards(dev, mesh)
    mesh_refusals(dev, mesh)
    return launches


# -- phase 25: attention on a sequence-sharded q ------------------------------

BF16, F32 = torch.bfloat16, torch.float32
MODEL_SHARDS = 16                 # the production meshes' ``model`` dim
#: (name, B, H, K, Sq, Sk, q_offset, hd, dtype, causal, window, softcap): q
#: rows at q_offset against every key. First the last rank's share of a q
#: sequence-sharded over ``model`` on 16 x 16 (gemma2-2b's local and global
#: layers and llava-next-34b, TRAIN_4K and PREFILL_32K: its heaviest rank
#: under causal masking), then small shares off the block on both routes
OFFSET_CASES = [
    ("gemma2-2b-train-local", 16, 8, 4, 256, 4096, 3840, 256, BF16, True,
     4096, 50.0),
    ("gemma2-2b-train-global", 16, 8, 4, 256, 4096, 3840, 256, BF16, True,
     0, 50.0),
    ("gemma2-2b-prefill-local", 2, 8, 4, 2048, 32768, 30720, 256, BF16,
     True, 4096, 50.0),
    ("gemma2-2b-prefill-global", 2, 8, 4, 2048, 32768, 30720, 256, BF16,
     True, 0, 50.0),
    ("llava-next-34b-train", 16, 56, 8, 256, 4096, 3840, 128, BF16, True, 0,
     0.0),
    ("llava-next-34b-prefill", 2, 56, 8, 2048, 32768, 30720, 128, BF16, True,
     0, 0.0),
    ("gemma2-2b-train-local-f32", 1, 8, 4, 256, 4096, 3840, 256, F32, True,
     4096, 50.0),
    ("ragged-small", 2, 4, 2, 37, 100, 50, 32, F32, True, 8, 20.0),
    ("ragged-small-bf16", 1, 4, 2, 77, 300, 101, 64, BF16, True, 0, 0.0),
    ("ragged-window-softcap-bf16", 2, 8, 2, 200, 1000, 555, 112, BF16, True,
     300, 30.0),
    ("bidirectional-window", 1, 4, 2, 50, 300, 130, 128, F32, False, 40,
     0.0),
]
#: the rank shares timed (d)
OFFSET_TIMED = 6
#: (a) also holds each case to its own scale: a share at Sk 32768 has
#: outputs of ~sqrt(e / Sk), far below ATTN_TOL, so the error must also stay
#: within this share of the plain version's largest |output| (bf16: about
#: two ulps of it)
OFFSET_REL_TOL = {F32: 1e-4, BF16: 2e-2}
#: f32 scores of one plain call above this are computed a batch row and a
#: kv-head group at a time
PLAIN_SCORE_BYTES = 4 << 30
#: the sixteen-rank emulation: (name, H, K, hd, dtype, window, softcap) at
#: batch 1 and TRAIN_4K's S 4096, shares of 256 rows
EMULATED = [
    ("gemma2-2b-global", 8, 4, 256, BF16, 0, 50.0),
    ("gemma2-2b-local", 8, 4, 256, BF16, 4096, 50.0),
    ("gemma2-2b-window-1000", 8, 4, 256, BF16, 1000, 50.0),
    ("llava-next-34b", 56, 8, 128, BF16, 0, 0.0),
    ("gemma2-2b-global-f32", 8, 4, 256, F32, 0, 50.0),
]
EMULATED_S = 4096
#: a sequence whose shares (250 rows) are not a multiple of either block
EMULATED_RAGGED = ("llava-next-34b-S4000", 56, 8, 128, BF16, 0, 0.0, 4000)
#: PREFILL_32K's S at batch 1 for these EMULATED cases: the first share
#: and the two heaviest (2048 rows each) against the same rows of the whole
#: sequence's kernel
EMULATED_LONG = ("gemma2-2b-global", "gemma2-2b-local", "llava-next-34b")
EMULATED_LONG_S = 32768
EMULATED_LONG_RANKS = (0, MODEL_SHARDS - 2, MODEL_SHARDS - 1)
HINTED_LAYERS = 4                 # llava-next-34b's cut for the prefill leg


def offset_inputs(i, case, dev):
    """Seeded N(0, 1) q [B,H,Sq,hd], k and v [B,K,Sk,hd] drawn on the
    card."""
    _, B, H, K, Sq, Sk, _, hd, dt, *_ = case
    g = torch.Generator(dev).manual_seed(2500 + i)
    return [torch.randn(shape, generator=g, device=dev).to(dt)
            for shape in ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd))]


def offset_ref(q, k, v, **kw):
    """``attention_ref`` of the whole call, or a batch row and a kv-head
    group at a time where its f32 scores would pass PLAIN_SCORE_BYTES."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, H, Sq, _ = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if 4 * B * H * Sq * Sk <= PLAIN_SCORE_BYTES:
        return attention_ref(q, k, v, **kw)
    G = H // K
    out = torch.empty_like(q)
    for b in range(B):
        for j in range(K):
            heads = slice(j * G, (j + 1) * G)
            out[b:b + 1, heads] = attention_ref(
                q[b:b + 1, heads], k[b:b + 1, j:j + 1], v[b:b + 1, j:j + 1],
                **kw)
    return out


def offset_kernel_checks(dev) -> dict:
    """(a) every OFFSET_CASES case on its route against the plain version
    at the same offset, within ATTN_TOL and within OFFSET_REL_TOL of the
    plain version's largest |output|. Returns the errors by case."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    errs = {}
    for i, c in enumerate(OFFSET_CASES):
        name, *_, Sk, q_offset, _, dt, causal, window, cap = c
        q, k, v = offset_inputs(i, c, dev)
        kw = dict(causal=causal, window=window, softcap=cap,
                  q_offset=q_offset)
        reset_counts()
        ker = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        routes = {r: counts()[f"flash_attention_{r}"] for r in ROUTES}
        ref = offset_ref(q, k, v, **kw)
        errs[name] = max_abs_err([ref], [ker])
        scale = ref.float().abs().max().item()
        tol = min(ATTN_TOL[dt], OFFSET_REL_TOL[dt] * scale)
        emit({"phase": "q_offset_kernel", "card": smi_line(), "case": name,
              "q": list(q.shape), "k": list(k.shape), **kw,
              "dtype": str(dt), "route_launches": routes,
              "max_abs_err": errs[name], "max_abs_out": scale,
              "err_over_max_abs_out": errs[name] / scale,
              "tolerance": tol, "attn_tol": ATTN_TOL[dt],
              "rel_tol": OFFSET_REL_TOL[dt],
              "plain_by_row_and_group": 4 * q.shape[0] * q.shape[1]
              * q.shape[2] * Sk > PLAIN_SCORE_BYTES})
        check(ker.shape == q.shape and bool(torch.isfinite(ker).all()),
              f"flash_attention at an offset gave a bad result in {name}")
        check(errs[name] <= tol, f"flash_attention at an offset differs "
                                 f"from its plain version in {name}: "
                                 f"{errs[name]} > {tol}")
        want = {r: int(r == fa.route(dt)) for r in ROUTES}
        check(routes == want, f"{name} took the routes {routes}, not {want}")
        del q, k, v, ker, ref
    free_card()
    return errs


def emulate_ranks(dev) -> list:
    """(b) MODEL_SHARDS ranks on one card: each share of q at its offset,
    concatenated, against the same rows of the same route's kernel on the
    whole sequence; every share at S 4096, the first and the heaviest at
    EMULATED_LONG_S; bit-equal where a share is a multiple of the route's
    block, within ATTN_TOL where it is not."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    rows = []
    every = tuple(range(MODEL_SHARDS))
    cases = ([(*c, EMULATED_S, every) for c in EMULATED]
             + [(*EMULATED_RAGGED, every)]
             + [(f"{c[0]}-S{EMULATED_LONG_S}", *c[1:], EMULATED_LONG_S,
                 EMULATED_LONG_RANKS) for c in EMULATED
                if c[0] in EMULATED_LONG])
    for i, (name, H, K, hd, dt, window, cap, S, ranks) in enumerate(cases):
        g = torch.Generator(dev).manual_seed(2600 + i)
        q, k, v = (torch.randn((1, h, S, hd), generator=g,
                               device=dev).to(dt) for h in (H, K, K))
        kw = dict(causal=True, window=window, softcap=cap)
        whole = fa.flash_attention(q, k, v, **kw)
        share = S // MODEL_SHARDS
        rows_of = [slice(r * share, (r + 1) * share) for r in ranks]
        parts = [fa.flash_attention(q[:, :, s].contiguous(), k, v,
                                    q_offset=s.start, **kw)
                 for s in rows_of]
        got = torch.cat(parts, dim=2)
        whole = torch.cat([whole[:, :, s] for s in rows_of], dim=2)
        aligned = share % fa.BLOCK_Q[fa.route(dt)] == 0
        row = {"case": name, "S": S, "shares": MODEL_SHARDS,
               "ranks": list(ranks) if ranks != every else "all",
               "rows_a_share": share, "route": fa.route(dt),
               "share_a_multiple_of_the_block": aligned,
               "bit_equal": bit_equal(got, whole),
               "max_abs_err": max_abs_err([whole], [got])}
        rows.append(row)
        check(row["bit_equal"] if aligned else
              row["max_abs_err"] <= ATTN_TOL[dt],
              f"{name}: the {MODEL_SHARDS} shares differ from the whole "
              f"sequence's kernel: {row}")
        del q, k, v, whole, parts, got
    emit({"phase": "q_offset_ranks", "card": smi_line(), "rows": rows})
    free_card()
    return rows


def loss_and_backward(model, batch):
    loss = model.loss(batch)
    loss.backward()
    return loss.detach()


def hinted_train_leg(dev, mesh, arch: str, cfg) -> dict:
    """The full ``arch`` at 1 x TRAIN_SEQ: the loss and every gradient leaf
    (remat on) of the no-mesh route, then of the model placed on the 1 x 1
    mesh with q sequence-sharded over ``model`` by hand: equal bit for bit,
    each route launching ``flash_attention`` twice a layer on the wgmma
    route."""
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.launch.train import place_on_mesh
    from repro_torch.models import layers

    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_wgmma": 2 * cfg.n_layers}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticCorpus(cfg, TRAIN_SEQ, 1, seed=0).batch(0).items()}
    free_card()
    model = training_model(cfg, dev, seed=0)
    reset_counts()
    plain_loss, plain_s = timed(lambda: loss_and_backward(model, batch))
    plain_counts = nonzero_counts()
    plain_grads = {k: p.grad for k, p in model.named_parameters()}
    del model
    free_card()

    model = training_model(cfg, dev, seed=0)
    opt, place_batch = place_on_mesh(mesh, cfg, model)
    del opt                       # the step's moments are not needed here
    layers.set_attention_q_sharding("model")
    mb = place_batch(batch)
    reset_counts()
    loss, mesh_s = timed(lambda: loss_and_backward(model, mb))
    mesh_counts = nonzero_counts()
    hint = layers._ATTN_Q_SHARDING
    layers.set_attention_q_sharding(None)
    mesh_loss = local(loss)
    differing = [k for k, p in model.named_parameters()
                 if not torch.equal(local(p.grad), plain_grads[k])]
    equal = not differing and torch.equal(mesh_loss, plain_loss)
    emit({"phase": "q_offset_train", "card": smi_line(), "arch": arch,
          "mesh": "1x1", "q_hint": hint, "tokens": [1, TRAIN_SEQ],
          "remat": True, "loss_plain": float(plain_loss),
          "loss_mesh": float(mesh_loss), "bit_equal": equal,
          "n_leaves": len(plain_grads), "differing_leaves": differing[:20],
          "launches_plain": plain_counts, "launches_mesh": mesh_counts,
          "s_loss_and_backward_plain": plain_s,
          "s_loss_and_backward_mesh": mesh_s})
    check(plain_counts == mesh_counts == want,
          f"{arch}: launched {plain_counts} plain, {mesh_counts} on the "
          f"hinted mesh, not {want}")
    check(equal, f"{arch}: the hinted mesh route's loss or gradients "
                 f"({differing[:5]}) differ from the no-mesh route's")
    del model, plain_grads, loss, mb, batch
    free_card()
    return {"loss and backward": mesh_counts}


def offset_timings(dev, errs: dict) -> list:
    """(d) the last rank's share of each OFFSET_TIMED case: the kernel's
    ms a launch, the plain version's, the library call's where there is
    one, and the bound from the visible pairs at its offset (and the
    first rank's visible pairs beside them)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    rows = []
    for i, c in enumerate(OFFSET_CASES[:OFFSET_TIMED]):
        name, B, H, K, Sq, Sk, q_offset, hd, dt, causal, window, cap = c
        q, k, v = offset_inputs(i, c, dev)
        kw = dict(causal=causal, window=window, softcap=cap,
                  q_offset=q_offset)
        ker_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = time_ms(lambda: offset_ref(q, k, v, **kw))
        lib = library_attention(q, k, v, causal, window, cap, q_offset)
        lib_ms = lib_err = None
        if lib is not None:
            lib_ms = time_ms(lib)
            lib_err = max_abs_err([lib()], [fa.flash_attention(q, k, v,
                                                               **kw)])
            check(lib_err <= ATTN_TOL[dt], f"{name}: SDPA differs by "
                                           f"{lib_err}")
        bound_ms, bound_by, flops, nbytes = attn_bound(
            B, H, K, Sq, hd, dt, causal, window, Sk, q_offset)
        last = visible_pairs(Sq, causal, window, Sk, q_offset)
        first = visible_pairs(Sq, causal, window, Sk, 0)
        row = {"case": name, "route": fa.route(dt), "q": [B, H, Sq, hd],
               "k": [B, K, Sk, hd], "q_offset": q_offset,
               "rank": q_offset // Sq, "ms": ker_ms, "us": 1e3 * ker_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "none (softcap)" if lib is None else
               "SDPA, causal_lower_right" if causal and window == 0
               and q_offset + Sq == Sk else "SDPA, boolean mask",
               "library_max_abs_err": lib_err,
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "tflops": flops / ker_ms / 1e9,
               "share_of_bound": bound_ms / ker_ms,
               "visible_pairs_last_over_first_rank": last / first,
               "max_abs_err": errs[name]}
        rows.append(row)
        emit({"phase": "q_offset_timing", "card": smi_line(), **row})
        del q, k, v, lib
    free_card()
    return rows


def mesh_sequence_sharded_q(dev, mesh) -> None:
    """(e) ``attention_op`` of a q DTensor placed on its sequence over the
    mesh's ``model`` dim (the call phase 24 refused before the kernels took
    an offset): equal bit for bit to the kernel on the plain tensors, one
    wgmma launch each, and to the plain version within ATTN_TOL."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.flash_attention.ops import attention_op
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(dev).manual_seed(2700)
    q, k, v = (torch.randn((1, h, 256, 128), generator=g,
                           device=dev).bfloat16() for h in (16, 2, 2))
    kw = dict(causal=True, window=100, softcap=30.0)
    seq_q = DTensor.from_local(q, mesh, [Replicate(), Shard(2)])
    kd, vd = (DTensor.from_local(t, mesh, [Replicate(), Replicate()])
              for t in (k, v))
    reset_counts()
    want = attention_op(q, k, v, **kw)
    plain_counts = nonzero_counts()
    reset_counts()
    got = local(attention_op(seq_q, kd, vd, **kw))
    mesh_counts = nonzero_counts()
    err = max_abs_err([attention_ref(q, k, v, **kw)], [got])
    one = {"flash_attention": 1, "flash_attention_wgmma": 1}
    emit({"phase": "q_offset_mesh_op", "card": smi_line(),
          "q": list(q.shape), "placements": str(seq_q.placements), **kw,
          "bit_equal_plain_route": bit_equal(got, want),
          "max_abs_err_plain_version": err, "tolerance": ATTN_TOL[BF16],
          "launches_plain": plain_counts, "launches_mesh": mesh_counts})
    check(plain_counts == mesh_counts == one,
          f"sequence-sharded q: launched {plain_counts}, {mesh_counts}")
    check(bit_equal(got, want), "sequence-sharded q: the mesh route's "
                                "output differs from the plain route's")
    check(err <= ATTN_TOL[BF16], f"sequence-sharded q: {err} from the "
                                 f"plain version")


def q_offset_phase(dev, mesh) -> tuple[dict, dict]:
    """Phase 25: attention on a sequence-sharded q, each share of q rows
    at its offset against every key. Returns the model legs' launches and,
    for the kernels line, the timed shares and the emulation's rows."""
    from repro_torch.configs import get_config

    errs = offset_kernel_checks(dev)
    emulation = emulate_ranks(dev)
    mesh_sequence_sharded_q(dev, mesh)
    gcfg = get_config("gemma2-2b")
    lcfg = dataclasses.replace(get_config("llava-next-34b"),
                               n_layers=HINTED_LAYERS)
    wgmma = {"flash_attention": lcfg.n_layers,
             "flash_attention_wgmma": lcfg.n_layers}
    launches = {
        "hinted gemma2-2b train": hinted_train_leg(dev, mesh, "gemma2-2b",
                                                   gcfg),
        "hinted llava-next-34b-4 prefill": mesh_prefill_leg(
            dev, mesh, "llava-next-34b", lcfg, SEQ, wgmma, q_hint="model"),
    }
    emit({"phase": "q_offset_model", "card": smi_line(), "mesh": "1x1",
          "q_hint": "model", "launches": launches})
    rows = offset_timings(dev, errs)
    return launches, {"q_offset_cases": rows,
                      "q_offset_emulation": emulation}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    from repro_torch.carry import fleet_to_numpy
    from repro_torch.fleet import FleetParams, SweepConfig, fleet_run
    from repro_torch.fleet import make_fleet, run_sweep
    from repro_torch.fleet.metrics import FleetStats, stats_to_numpy, summarize
    from repro_torch.fleet.sweep import _build_population
    from repro_torch.kernels import _build
    from repro_torch.kernels.placement import placement
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import attention_op
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dev = torch.device("cuda")
    # full-f32 matmuls in the plain versions (TF32 would round the inputs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card ---------------------------------------------------------
    smi = smi_line()
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
                                "fanout_commit_kernel",
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
        ("fused_place", "fanout_commit", "window_query")) and (
            r.get("spill_stores") or r.get("spill_loads"))]
    check(not spilled, f"ptxas spilled registers of {spilled}")

    # -- 3. kernel against its plain version ---------------------------------
    kernel_err = check_fused_place(dev)
    fanout_err = check_fanout_commit(dev)

    attn_err = {}
    for i, c in enumerate(ATTN_CASES):
        name, *_, dt, causal, window, cap = c
        q, k, v = attn_inputs(i, c, dev)
        kw = dict(causal=causal, window=window, softcap=cap,
                  scale=ATTN_SCALE.get(name))
        reset_counts()
        ker = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        routes = {r: counts()[f"flash_attention_{r}"] for r in ROUTES}
        if kw["scale"] is not None:   # the models' entry passes it on
            check(torch.equal(attention_op(q, k, v, **kw), ker),
                  f"attention_op differs from flash_attention in case "
                  f"{name}")
        ref = offset_ref(q, k, v, **kw)
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
    hp_commits = fleet_counts["fanout_commit"]
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
          "fanout_commit_launches": hp_commits,
          "window_query_batched_launches": hp_queries,
          "window_query_vec_launches": hp_vec,
          "frame_completion_rate": {
              c: summary[c]["frame_completion_rate"] for c in cells},
          "conservation_residual_max_abs": residual})
    check(launches == FUSED_PER_TICK * N_FRAMES,
          f"fused_place launched {launches} times, not "
          f"{FUSED_PER_TICK * N_FRAMES}")
    check(hp_commits == HP_COMMITS_PER_TICK * N_FRAMES,
          f"fanout_commit launched {hp_commits} times, not "
          f"{HP_COMMITS_PER_TICK * N_FRAMES}")
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
    hp_commit_launches = hp_commit_phase(dev, values, bw)

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
    launches_by_path = {"serving": {"forwards": {
        "flash_attention": serve_launches}}}
    launches_by_path.update(serve_new_archs(dev))

    # -- 7. the hybrid path: full zamba2-7b ----------------------------------
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

    # -- 9. the MoE path; 10. the MLA path; 11. the encoder-decoder path ------
    launches_by_path.update(moe_mla_encdec_paths(dev))

    # -- 12. kernel path vs plain path at model level -------------------------
    model_plain_paths(dev)

    # -- 13. timing -----------------------------------------------------------
    place_row = time_fused_place(dev)
    fanout_row = time_fanout_commit(dev)

    attn_rows = []
    for i, c in enumerate(ATTN_CASES):
        name, *_, causal, window, cap = c
        q, k, v = attn_inputs(i, c, dev)
        kw = dict(causal=causal, window=window, softcap=cap,
                  scale=ATTN_SCALE.get(name))
        ker_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        ref_ms = time_ms(lambda: offset_ref(q, k, v, **kw))
        lib = library_attention(q, k, v, causal, window, cap,
                                scale=kw["scale"])
        lib_ms = time_ms(lib) if lib is not None else None
        bound_ms, bound_by, flops, nbytes = attn_bound(*c[1:9])
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

    # -- 14. single controller; 15. the launch checker's fixture -------------
    single_controller_phase(dev)
    racy_row, racy_launches = fixture_phase(dev)

    # -- 16. the calibration; 17. the sanitizers -----------------------------
    calib_report, calib_counts = calibration_phase(dev)
    sanitize_phase(dev, values[:SANITIZE_FRAMES], bw[:SANITIZE_FRAMES],
                   calib_report)

    # -- 18. telemetry; 19. profile; 20. the obs CLI; 21. the sharded sweep
    obs_counts = {
        "fleet telemetry": telemetry_phase(dev, values, bw, main_leaves),
        "fleet profile": profile_phase(dev, values, bw),
        "obs CLI record": obs_cli_phase(dev),
        "sharded run_sweep": sharded_phase(dev, summary, sweep, tk, sk,
                                           owners),
    }

    # -- 22. training -----------------------------------------------------------
    train_by_path, backward_rows = train_phase(dev)
    launches_by_path.update(train_by_path)

    # -- 23. the dry run on the card -----------------------------------------
    dryrun_phase(dev)

    # -- 24. the production mesh's route on one card; 25. attention on a
    # sequence-sharded q ------------------------------------------------------
    with mesh_session() as mesh:
        launches_by_path.update(mesh_phase(dev, mesh))
        offset_launches, offset_rows = q_offset_phase(dev, mesh)
        launches_by_path.update(offset_launches)
    mesh_records()

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

    def train_fields(name):
        """A differentiated kernel's launches on the training legs, and its
        backward's time a call (the plain version recomputed)."""
        return {"training_launches": {
                    path: parts["steps"][name]
                    for path, parts in train_by_path.items()
                    if parts["steps"].get(name)},
                "backward_recompute_ms": backward_rows[name]["backward_ms"],
                "backward_case": backward_rows[name]["case"]}

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
        "name": "fanout_commit",
        "route": "cuda",
        "source": "src/repro_torch/kernels/placement/csrc/placement.cu",
        "replaces": "src/repro_torch/core/tensor_state.py::fanout_commit "
                    "in the fleet (plain PyTorch; the JAX package's HP "
                    "commit is jnp, not a Pallas kernel)",
        "launches": hp_commits + hp_commit_launches["fanout_commit"] + sum(
            fleet_counts_by_path("fanout_commit").values()),
        "launches_by_path": {
            "fleet run_sweep": hp_commits,
            "fleet kernel route against plain":
                hp_commit_launches["fanout_commit"],
            **fleet_counts_by_path("fanout_commit")},
        "matched": True,
        "max_abs_err": fanout_err,
        "case": "bench-524288",
        **fanout_row,
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
        **offset_rows,
        **train_fields("flash_attention"),
    }, {**new_entry("ssd_scan",
                    "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                    "src/repro/kernels/ssd_scan/ssd_scan.py:74"),
        "cases": [{k: r[k] for k in ("case", "groups", "ms", "plain_ms",
                                     "bound_ms", "bound_by",
                                     "share_of_bound")}
                  for r in new_rows["ssd_cases"]],
        **train_fields("ssd_scan")},
        {**new_entry("ssm_scan",
                     "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/ssm_scan.py:61"),
         **train_fields("ssm_scan")},
        {**new_entry("flash_decode",
                     "src/repro_torch/kernels/flash_decode/csrc/"
                     "flash_decode.cu",
                     "src/repro/kernels/flash_decode/flash_decode.py:80"),
         "launches_split": path_launches("flash_decode_split")[0],
         "launches_combine": path_launches("flash_decode_combine")[0],
         **{k: new_rows["flash_decode"][k]
            for k in ("split_ms", "combine_ms")},
         "launch_parameters": {k: new_rows["flash_decode"][k]
                               for k in ("n_split", "chunk")},
         "cases": [{k: r[k] for k in ("case", "ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by",
                                      "share_of_bound")}
                   for r in new_rows["decode_cases"]]},
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
