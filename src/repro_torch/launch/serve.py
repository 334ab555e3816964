"""Serving launcher: deadline-constrained serving of the waste pipeline (or
any ported arch's reduced variant) through the RAS scheduler, in PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.serve --frames 40
    PYTHONPATH=src python -m repro_torch.launch.serve --scheduler wps
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --frames 4

Runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, reduced
from repro_torch.core.tasks import FRAME_PERIOD
from repro_torch.serving.engine import ServingEngine
from repro_torch.sim.traces import generate_trace


def serve(
    arch: str = "waste-pipeline",
    frames: int = 40,
    n_workers: int = 4,
    scheduler: str = "ras",
    trace: str = "weighted2",
    seed: int = 0,
    device=None,
) -> dict:
    """Serve ``frames`` frames of ``trace`` and summarise them; the keys are
    those of the JAX package's ``serve``. ``device`` None -> CUDA."""
    cfg = get_config(arch)
    if arch != "waste-pipeline":
        cfg = reduced(cfg)
    eng = ServingEngine(cfg, n_workers=n_workers, scheduler=scheduler,
                        seed=seed, device=device)
    tr = generate_trace(trace, frames, n_workers, seed=seed)
    fid = 0
    for f in range(frames):
        for d in range(n_workers):
            v = int(tr.entries[f, d])
            if v < 0:
                continue
            eng.submit_frame(fid, d, v, now=f * FRAME_PERIOD)
            fid += 1
    return {
        "arch": arch,
        "scheduler": scheduler,
        "frames_submitted": fid,
        "completion_rate": round(eng.completion_rate(), 4),
        "stage1_latency_s": round(eng.stage1.latency, 4),
        "stage3_latency_s": round(eng.stage3.latency, 4),
        "offloaded_total": sum(r.offloaded for r in eng.results),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="waste-pipeline")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--scheduler", default="ras", choices=["ras", "wps"])
    ap.add_argument("--trace", default="weighted2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    out = serve(args.arch, args.frames, args.workers, args.scheduler,
                args.trace, args.seed, device=args.device)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
