"""The two legs of the dry run's count tests (``test_torch_dryrun_counts.py``
and ``test_torch_dryrun_train_counts.py``).

The reference leg is built as ``repro/launch/dryrun.py``'s ``build_*``
build it, without its mesh and shardings: the step jitted, lowered on the
reference's ``ShapeDtypeStruct`` inputs and compiled on one CPU device,
and the compiled HLO text passed to ``repro.roofline.hlo_graph.analyze``
(trip-weighted dot FLOPs and dot bytes). ``repro.launch.dryrun`` itself is
not imported: it rewrites ``XLA_FLAGS`` on import and asks for a 256-chip
mesh. The port's leg is ``repro_torch.launch.dryrun.build`` on ``meta``
under ``StepTrace``.

Both at ``reduced(...)`` configs (f32), batch 2 x 128 tokens; a decode
step against a 128-long cache.
"""

import jax
import jax.numpy as jnp

import repro.configs as configs_j
from repro.data.pipeline import make_batch_specs as batch_specs_j
from repro.models.transformer import Model as Model_j
from repro.optim.adamw import AdamWConfig as AdamWConfig_j
from repro.optim.adamw import adamw_init as adamw_init_j
from repro.optim.adamw import adamw_update as adamw_update_j
from repro.roofline.hlo_graph import analyze
import repro_torch.configs as configs_t
from repro_torch.launch.dryrun import build
from repro_torch.models.config import InputShape
from repro_torch.roofline.trace import StepTrace

SEQ, BATCH = 128, 2
#: one arch of each family: dense, dense with local/global windows and
#: softcaps, VLM, MoE, MLA, encoder-decoder, SSM, hybrid
FAMILIES = ("qwen2.5-3b", "gemma2-2b", "llava-next-34b",
            "moonshot-v1-16b-a3b", "deepseek-v2-236b",
            "seamless-m4t-medium", "falcon-mamba-7b", "zamba2-7b")


def shape(kind: str) -> InputShape:
    return InputShape(f"{kind}_test", SEQ, BATCH, kind)


def reference_counts(arch: str, kind: str) -> tuple[float, float]:
    """(dot FLOPs, dot bytes) of the reference's compiled step."""
    cfg = configs_j.reduced(configs_j.get_config(arch))
    model = Model_j(cfg)
    sh = shape(kind)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    if kind == "train":
        opt_cfg = AdamWConfig_j(total_steps=1000)

        def step(p, o, b):
            loss, grads = jax.value_and_grad(model.loss)(p, b)
            p, o, _ = adamw_update_j(opt_cfg, grads, o, p)
            return p, o, loss

        args = (params, jax.eval_shape(adamw_init_j, params),
                batch_specs_j(cfg, sh))
    elif kind == "prefill":
        def step(p, b):
            return model.forward(p, b)[0]

        args = (params, batch_specs_j(cfg, sh))
    else:
        def step(p, s, t):
            return model.decode_step(p, s, t)

        args = (params,
                jax.eval_shape(lambda: model.init_decode_state(BATCH, SEQ)),
                jax.ShapeDtypeStruct((BATCH,), jnp.int32))
    a = analyze(jax.jit(step).lower(*args).compile().as_text())
    return a["weighted_dot_flops"], a["weighted_dot_bytes"]


def port_counts(arch: str, kind: str) -> tuple[float, float]:
    """(dot FLOPs, dot bytes) of the port's step traced on ``meta``."""
    cfg = configs_t.reduced(configs_t.get_config(arch))
    step, args = build(cfg, shape(kind))
    with StepTrace(args) as tr:
        step()
    c = tr.counts()
    return c["dot_flops"], c["dot_bytes"]
