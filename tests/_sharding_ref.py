"""The two legs of the sharded count tests (``test_torch_sharding_counts.py``),
each run as a script in a process of its own, which prints one JSON object
of counts by "arch/kind".

``python tests/_sharding_ref.py reference``: the reference's step at
``reduced(...)`` (f32), batch 2 x 128 (a decode step against a 128-long
cache), built as ``repro/launch/dryrun.py``'s ``build`` builds it (the
strategy, the shardings of the parameters, moments, batch and decode
state, both ``configure_*`` hints) on a 2 x 2 mesh ("data", "model") of
four forced host devices, compiled, its HLO text passed to
``repro.roofline.hlo_graph.analyze`` (per-partition, trip-weighted) and
its ``memory_analysis()`` read. ``repro.launch.dryrun`` itself is not
imported: it forces 512 devices on import.

``python tests/_sharding_ref.py port``: the port's step traced on ``meta``
under a fake 4-rank process group (``launch/dryrun.py::trace_step``).
"""

import json
import os
import sys

SEQ, BATCH = 128, 2
KINDS = ("prefill", "decode", "train")
#: one arch of each family (``_dryrun_ref.FAMILIES``)
FAMILIES = ("qwen2.5-3b", "gemma2-2b", "llava-next-34b",
            "moonshot-v1-16b-a3b", "deepseek-v2-236b",
            "seamless-m4t-medium", "falcon-mamba-7b", "zamba2-7b")


def reference() -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp

    import repro.configs as configs_j
    from repro.data.pipeline import make_batch_specs
    from repro.launch import sharding as sh
    from repro.models.config import InputShape
    from repro.models.transformer import Model
    from repro.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                   adamw_update)
    from repro.roofline.hlo_graph import analyze

    from jax.sharding import AxisType

    # Auto axes, as GSPMD's with_sharding_constraint hints need
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))

    def build(cfg, shape):
        sh.configure_attention_sharding(mesh, cfg, shape.kind)
        sh.configure_moe_sharding(mesh, cfg)
        model = Model(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        if shape.kind == "train":
            opt_cfg = AdamWConfig(total_steps=1000)

            def step(p, o, b):
                loss, grads = jax.value_and_grad(model.loss)(p, b)
                p, o, _ = adamw_update(opt_cfg, grads, o, p)
                return p, o, loss

            strategy = sh.pick_strategy(cfg, shape.kind)
            p_sh = sh.param_shardings(mesh, cfg, params, phase="train",
                                      strategy=strategy)
            m_sh = sh.moment_shardings(mesh, params, strategy, p_sh)
            o_sh = OptState(step=sh.replicated(mesh), mu=m_sh, nu=m_sh)
            b = make_batch_specs(cfg, shape)
            b_sh = sh.batch_shardings(mesh, cfg, shape, b, strategy=strategy)
            jitted = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh),
                             out_shardings=(p_sh, o_sh, sh.replicated(mesh)))
            return jitted, (params, jax.eval_shape(adamw_init, params), b)
        if shape.kind == "prefill":
            p_sh = sh.param_shardings(mesh, cfg, params, phase="prefill")
            b = make_batch_specs(cfg, shape)
            b_sh = sh.batch_shardings(mesh, cfg, shape, b)
            return jax.jit(lambda p, b_: model.forward(p, b_)[0],
                           in_shardings=(p_sh, b_sh)), (params, b)
        p_sh = sh.param_shardings(mesh, cfg, params, phase="decode")
        st = jax.eval_shape(lambda: model.init_decode_state(BATCH, SEQ))
        s_sh = sh.decode_state_shardings(mesh, cfg, shape, st)
        tok = jax.ShapeDtypeStruct((BATCH,), jnp.int32)
        t_sh = sh.batch_shardings(mesh, cfg, shape, {"t": tok})["t"]
        return jax.jit(model.decode_step, in_shardings=(p_sh, s_sh, t_sh),
                       out_shardings=(None, s_sh)), (params, st, tok)

    out = {}
    for arch in FAMILIES:
        cfg = configs_j.reduced(configs_j.get_config(arch))
        for kind in KINDS:
            shape = InputShape(f"{kind}_test", SEQ, BATCH, kind)
            with mesh:
                jitted, args = build(cfg, shape)
                compiled = jitted.lower(*args).compile()
            a = analyze(compiled.as_text())
            out[f"{arch}/{kind}"] = {
                "dot_flops": a["weighted_dot_flops"],
                "dot_bytes": a["weighted_dot_bytes"],
                "arg_bytes": compiled.memory_analysis().argument_size_in_bytes,
                "collectives": a["collectives_weighted"]}
    return out


def port() -> dict:
    import repro_torch.configs as configs_t
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.config import InputShape

    mesh = AbstractMesh((2, 2), ("data", "model"))
    out = {}
    for arch in FAMILIES:
        cfg = configs_t.reduced(configs_t.get_config(arch))
        for kind in KINDS:
            shape = InputShape(f"{kind}_test", SEQ, BATCH, kind)
            counts, _, _ = trace_step(cfg, shape, mesh)
            out[f"{arch}/{kind}"] = {
                "dot_flops": counts["dot_flops"],
                "dot_bytes": counts["dot_bytes"],
                "arg_bytes": counts["arg_bytes"],
                "collectives": counts["collectives"],
                "groups": sorted(len(g) for g in counts["wire_by_group"])}
    return out


if __name__ == "__main__":
    print(json.dumps({"reference": reference, "port": port}[sys.argv[1]]()))
