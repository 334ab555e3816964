#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s model-family phases alone on one card, with its
checks: quicker than the whole smoke run when only the models changed.

    python3 tools/smoke_models.py [paths] [serve] [plain] [train] [dryrun]
        [mesh] [offset]

``paths``: the full moonshot-v1-16b-a3b, deepseek-v2-236b at full width
cut to 2 layers and the full seamless-m4t-medium, forward and decode
(``moe_mla_encdec_paths``); ``serve``: the reduced MoE, MLA and
encoder-decoder archs served through RAS, kernel vs plain engine
(``serve_new_archs``); ``plain``: the model-level kernel-vs-plain
comparisons (``model_plain_paths``); ``train``: the training legs, their
kernel-vs-plain gradients, the checkpoint round trip and the backward
times (``train_phase``); ``dryrun``: the dry run's traces held to the
card (``dryrun_phase``); ``mesh``: the production mesh's route on a 1 x 1
mesh held to the no-mesh route, and two 16 x 16 records
(``mesh_phase``, ``mesh_records``); ``offset``: attention on a
sequence-sharded q, the kernels at a query offset and the hinted mesh
route on the 1 x 1 mesh (``q_offset_phase``). No argument runs all
seven. The
kernels are built first, as ``chip_smoke.py`` builds them. Every line is
JSON; the first names the card and its power limit. Exits non-zero
without CUDA or when a check fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("paths", "serve", "plain", "train", "dryrun", "mesh", "offset")


def main() -> None:
    if not torch.cuda.is_available():
        print("smoke_models: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    what = sys.argv[1:] or list(PHASES)
    if set(what) - set(PHASES):
        sys.exit(f"smoke_models: phases are {PHASES}, not {what}")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "src"))
    import chip_smoke as smoke
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smoke.emit({"card": smoke.smi_line(), "torch": torch.__version__})
    t0 = time.perf_counter()
    _build.build(smoke.KERNELS)
    smoke.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    if "paths" in what:
        smoke.moe_mla_encdec_paths(dev)
    if "serve" in what:
        smoke.serve_new_archs(dev)
    if "plain" in what:
        smoke.model_plain_paths(dev)
    if "train" in what:
        smoke.train_phase(dev)
    if "dryrun" in what:
        smoke.dryrun_phase(dev)
    if "mesh" in what or "offset" in what:
        with smoke.mesh_session() as mesh:
            if "mesh" in what:
                smoke.mesh_phase(dev, mesh)
            if "offset" in what:
                smoke.q_offset_phase(dev, mesh)
        if "mesh" in what:
            smoke.mesh_records()


if __name__ == "__main__":
    main()
