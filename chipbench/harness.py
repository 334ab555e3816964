"""One run of one cell of ``BENCHMARK.json``, and its result line.

The cell's configuration, traffic mix, driver and per-layer readers are
found by name under the checkout's root (the directory above this
package), so a new cell is new files and new ``BENCHMARK.json`` entries.
A run on a machine without the card the cell asks for fails: no device
metric comes from the CPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent.name
#: top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def load_json(root: Path, rel: str):
    with open(root / rel) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise RunError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_spec(root: Path, workload: str) -> dict:
    """The cell's entries, configuration and traffic, by name."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root, configs[cell["config"]]["file"])
    traffic = load_json(root, f"{PACKAGE}/traffic/{cell['traffic']}.json")

    def reported(m):
        return workload in m.get("workloads", [workload])

    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if reported(m)],
        "per_layer": [m for m in bench["per_layer"] if reported(m)],
    }


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def run_cell(root: Path, workload: str, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, program=None) -> dict:
    """Run the cell once and return its result line as a dict."""
    spec = cell_spec(root, workload)
    traffic = spec["traffic"]
    driver = _module(root / PACKAGE / "drivers" / f"{traffic['driver']}.py",
                     f"{PACKAGE}_driver_{traffic['driver']}")
    out = driver.run(spec["config"], traffic, seed=seed, seconds=seconds,
                     trace=trace, device=device, t_start=t_start,
                     program=program)
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            reader = _module(root / PACKAGE / "metrics" / f"{m['name']}.py",
                             f"{PACKAGE}_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out.context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            if m["name"] not in out.e2e:
                raise RunError(f"the driver gives no {m['name']}")
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    correct = all(v <= limit for v, limit in out.checks.values())
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": _device(device, spec["cell"]["chips"],
                              out.memory_peak_bytes)}
    if trace:
        line["device"]["busy_s"] = out.trace["busy_s"]
        line["device"]["window_s"] = out.trace["wall_s"]
        line["breakdown"] = {"device_ops": out.trace["top_device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": limit}
                      for k, (v, limit) in out.checks.items()}
    return line


def _device(device, chips: int, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak,
            "power_limit_w": _power_limit()}


def _power_limit():
    """The card's power limit in watts, as nvidia-smi reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number")
    if args.seconds <= 0:
        ap.error("--seconds must be positive")
    return args


def _caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc libraries already land in its ``kernels/build``)."""
    base = root / "build" / PACKAGE
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    _caches(ROOT)
    try:
        spec = cell_spec(ROOT, args.workload)
    except (RunError, OSError, KeyError) as e:
        print(f"chipbench: {e}", file=sys.stderr)
        return 2
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chipbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 2
    line = run_cell(ROOT, args.workload, seed=args.seed,
                    seconds=args.seconds, trace=bool(args.trace),
                    device="cuda", t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"chipbench: the run loaded {found}: no result",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
