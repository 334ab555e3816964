"""The port's serving path against the JAX package on the CPU.

Two ``ServingEngine``s, one per package, serve the same frames with the
same weights (the JAX engine's, carried across by
``carry.model_params_from_numpy``) through the RAS scheduler and the WPS
baseline. The scheduling is pure Python in both packages, so every
``ServeResult`` field is equal; ``logits_checksum`` sums the frame's logits
and agrees within 1e-4 of the sum of their magnitudes (f32; the forward
passes agree to ~2e-5 a logit, see test_torch_models.py).

The engines run the reduced waste-pipeline config (2 layers, d_model 256,
16 media tokens, f32) on all 35 frames of a 10-period trace, to keep the
file well under a minute; ``serve`` runs the full waste-pipeline config in
bf16, as the launcher does, on 3 periods. The MoE, MLA and
encoder-decoder archs (deepseek-v2-236b, kimi-k2-1t-a32b,
moonshot-v1-16b-a3b, seamless-m4t-medium) run the same way through RAS,
reduced as ``serve`` reduces them (f32); seamless's engine feeds its
encoder zero media frames, so its decoder cross-attends to an empty
memory.
"""

import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.configs import reduced as reduced_j
from repro.launch.serve import serve as serve_j
from repro.serving.engine import ServingEngine as ServingEngine_j
from repro.sim.traces import generate_trace
from repro_torch.carry import model_params_from_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.core.tasks import FRAME_PERIOD
from repro_torch.launch.serve import serve
from repro_torch.models.transformer import Model
from repro_torch.serving import engine as engine_t
from repro_torch.serving.engine import ServeResult, ServingEngine

CHECKSUM_RTOL = 1e-4


def _frames(n_periods=10, n_workers=4):
    tr = generate_trace("weighted2", n_periods, n_workers, seed=0)
    return [(d, int(tr.entries[f, d]), f * FRAME_PERIOD)
            for f in range(n_periods) for d in range(n_workers)
            if tr.entries[f, d] >= 0]


NEW_ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b", "moonshot-v1-16b-a3b",
             "seamless-m4t-medium")
#: (arch, scheduler): the waste pipeline through both schedulers, the
#: MoE, MLA and encoder-decoder archs through RAS
CASES = pytest.mark.parametrize(
    "arch,scheduler",
    [("waste-pipeline", "ras"), ("waste-pipeline", "wps"),
     *((a, "ras") for a in NEW_ARCHS)],
    ids=["ras", "wps", *(f"{a}-ras" for a in NEW_ARCHS)])


@CASES
def test_engine_matches_jax_engine(arch, scheduler):
    cfg_j = reduced_j(get_config_j(arch))
    cfg_t = reduced(get_config(arch))
    assert cfg_t.dtype == "float32"
    eng_j = ServingEngine_j(cfg_j, scheduler=scheduler, seed=0)
    model = Model(cfg_t, device="cpu")
    model.load_state_dict(model_params_from_numpy(
        cfg_t, jax.device_get(eng_j.params), device="cpu"))
    forwards = engine_t.forwards
    eng_t = ServingEngine(cfg_t, scheduler=scheduler, seed=0, device="cpu",
                          model=model)
    assert engine_t.forwards == forwards + 8       # 2 stages x (1 + 3) timed
    with torch.inference_mode():
        mag1 = model(eng_t.stage1.batch)[0].abs().sum().item()
        mag3 = model(eng_t.stage3.batch)[0].abs().sum().item()

    frames = _frames()
    assert len(frames) == 35
    for fid, (src, n, now) in enumerate(frames):
        rj = eng_j.submit_frame(fid, src, n, now=now)
        rt = eng_t.submit_frame(fid, src, n, now=now)
        for f in dataclasses.fields(ServeResult):
            if f.name != "logits_checksum":
                assert getattr(rt, f.name) == getattr(rj, f.name), (fid, f)
        tol = CHECKSUM_RTOL * (mag1 + n * mag3)
        assert abs(rt.logits_checksum - rj.logits_checksum) <= tol, fid
    assert eng_t.completion_rate() == eng_j.completion_rate()
    assert sum(r.offloaded for r in eng_t.results) > 0


@CASES
def test_serve_matches_jax_serve(arch, scheduler):
    kw = dict(arch=arch, frames=3, scheduler=scheduler, seed=0)
    ref = serve_j(**kw)
    got = serve(**kw, device="cpu")
    assert set(got) == set(ref)
    for key in ("arch", "scheduler", "frames_submitted", "completion_rate",
                "offloaded_total"):
        assert got[key] == ref[key], key
    for key in ("stage1_latency_s", "stage3_latency_s"):
        assert got[key] > 0 and got[key] == round(got[key], 4), key


def test_serve_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(frames=1)


def test_unknown_scheduler_raises():
    cfg = reduced(get_config("waste-pipeline"))
    with pytest.raises(KeyError):
        ServingEngine(cfg, scheduler="fifo", device="cpu")
