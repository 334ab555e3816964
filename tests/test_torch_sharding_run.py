"""The port's model run on a mesh for real: four gloo ranks on the CPU, a
2 x 2 mesh ("data", "model"), reduced qwen2.5-3b (dense; its train step
takes ``dp_zero1``) and moonshot-v1-16b-a3b (MoE, expert-parallel), f32,
batch 4 x 32 (``tests/_sharding_run.py`` is one rank).

Each rank is held to the reference on one CPU device, with the MoE's
dispatch groups set to the mesh's data degree, 2, as
``configure_moe_sharding`` sets them (capacity is per group, so this is
the same function): the prefill logits within 1e-4, the train loss within
1e-5 of it and every gradient leaf within 1e-4 of the leaf's max; and a
checkpoint saved whole and restored onto the mesh equals, shard by shard
and bit for bit, the shards of the parameters it holds.

The same ranks hold ``spmd.halves`` (Mamba's split of its column-sharded
``in_proj`` output, one all-to-all) to ``chunk`` on 2 x 2 and 1 x 4
meshes, values and gradient.

A sequence-sharded q, each rank's rows at their offset against every key:
``attention_op`` on the 2 x 2 and a 1 x 4 mesh against the reference's
``attention_ref`` of the whole tensors (within 1e-5) and its vjp (q, k and
v within 1e-4 of each one's max); and reduced gemma2-2b with 3 heads and 1
kv head, which do not divide ``model`` (2), so that the port's
``configure_attention_sharding`` shards q's sequence as the reference's
hint does: prefill logits within 1e-4, the train loss within 1e-5 of it
and every gradient leaf within 1e-4 of the leaf's max.

Also: ``launch/mesh.py`` and ``train(mesh_kind="prod")`` refuse a world
size they cannot shape, and the fake process group the dry run uses
imports.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as configs_j
import repro.models.moe as moe_j
from repro.kernels.flash_attention.ref import attention_ref as attention_ref_j
from repro.models.transformer import Model as Model_j
from repro_torch.checkpoint import save

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)

from _sharding_run import (  # noqa: E402
    ARCHS,
    ATTN_SEQ_CASES,
    DECODE_BATCHES,
    DECODE_CACHE,
    DECODE_POS,
    DECODE_STEPS,
    HINTED_ARCH,
    HINTED_HEADS,
    _flat,
)

WORLD, BATCH, SEQ = 4, 4, 32


def _reference(arch: str, out_dir: str) -> None:
    """The reference's parameters, batch, logits, loss and gradients on
    one CPU device, and the parameters saved as a checkpoint."""
    cfg = configs_j.reduced(configs_j.get_config(arch))
    model = Model_j(cfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                             dtype=np.int32) for k in ("tokens", "labels")}
    decode = {}
    moe_j.set_dispatch_groups(2)
    try:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits = model.forward(params, {"tokens": jb["tokens"]})[0]
        loss, grads = jax.value_and_grad(model.loss)(params, jb)
        for b in DECODE_BATCHES:
            state = model.init_decode_state(b, DECODE_CACHE)
            state["pos"] = jnp.full((b,), DECODE_POS, jnp.int32)
            toks = rng.integers(0, cfg.vocab_size, (DECODE_STEPS, b),
                                dtype=np.int32)
            out = []
            for t in toks:
                lg, state = model.decode_step(params, state, jnp.asarray(t))
                out.append(np.asarray(lg))
            decode[f"dec{b}/tokens"] = toks
            decode[f"dec{b}/logits"] = np.stack(out)
    finally:
        moe_j.set_dispatch_groups(1)
    arrays = {**{"p/" + k: np.asarray(v) for k, v in _flat(params).items()},
              **{"g/" + k: np.asarray(v)
                 for k, v in _flat(jax.device_get(grads)).items()},
              **batch, **decode, "logits": np.asarray(logits),
              "loss": np.asarray(loss)}
    np.savez(os.path.join(out_dir, f"{arch}.npz"), **arrays)
    save(os.path.join(out_dir, f"{arch}_ckpt"), params)


def _batch(cfg, rng) -> dict:
    return {k: rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
            for k in ("tokens", "labels")}


def _hinted_reference(out_dir: str) -> None:
    """HINTED_ARCH reduced at HINTED_HEADS on one CPU device: its
    parameters, batch, logits, loss and gradients."""
    cfg = dataclasses.replace(
        configs_j.reduced(configs_j.get_config(HINTED_ARCH)), **HINTED_HEADS)
    model = Model_j(cfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(0)))
    batch = _batch(cfg, np.random.default_rng(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = model.forward(params, {"tokens": jb["tokens"]})[0]
    loss, grads = jax.value_and_grad(model.loss)(params, jb)
    np.savez(os.path.join(out_dir, f"{HINTED_ARCH}-hinted.npz"),
             **{"p/" + k: np.asarray(v) for k, v in _flat(params).items()},
             **{"g/" + k: np.asarray(v)
                for k, v in _flat(jax.device_get(grads)).items()},
             **batch, logits=np.asarray(logits), loss=np.asarray(loss))


def _attention_reference(out_dir: str) -> None:
    """Each ATTN_SEQ_CASES case's inputs, a cotangent, and the
    reference's ``attention_ref`` of the whole tensors with its vjp."""
    rng = np.random.default_rng(2)
    arrays = {}
    for name, _, B, H, K, S, hd, kw, _ in ATTN_SEQ_CASES:
        q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((B, H, S, hd), (B, K, S, hd),
                                    (B, K, S, hd), (B, H, S, hd)))
        out, vjp = jax.vjp(lambda *x: attention_ref_j(*x, causal=True, **kw),
                           *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(g))
        arrays.update({f"{name}/{x}": a for x, a in (
            ("q", q), ("k", k), ("v", v), ("g", g), ("out", out),
            *zip(("dq", "dk", "dv"), grads))})
    np.savez(os.path.join(out_dir, "attention_offset.npz"),
             **{k: np.asarray(a) for k, a in arrays.items()})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding_run")
    for arch in ARCHS:
        _reference(arch, str(out))
    _hinted_reference(str(out))
    _attention_reference(str(out))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_sharding_run.py"), str(r),
         str(WORLD), str(port), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return json.loads((out / "result.json").read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_equal_reference(result, arch):
    assert result[arch]["logits_max_abs_err"] <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_equal_reference(result, arch):
    assert result[arch]["loss_rel_err"] <= 1e-5
    assert result[arch]["grad_worst_rel_err"] <= 1e-4
    assert result[arch]["strategy"] == {"qwen2.5-3b": "dp_zero1",
                                        "moonshot-v1-16b-a3b": "tp"}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_onto_the_mesh(result, arch):
    assert result[arch]["checkpoint_leaves_equal"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch", DECODE_BATCHES)
def test_decode_steps_equal_reference(result, arch, batch):
    """Decode steps on the mesh from a cache of DECODE_CACHE positions, the
    batch rows over ``data`` (batch 4) or, at batch 1, the cache's
    sequence over ``data``, across the slices' boundary: every step's
    logits within 1e-4 of the reference's."""
    assert result[arch][f"decode{batch}_max_abs_err"] <= 1e-4
    # [L, B, S, K, hd]: rows over data at batch 4, the sequence at batch 1;
    # the kv heads over model
    assert result[arch][f"decode{batch}_cache_placements"] == {
        4: "(Shard(dim=1), Shard(dim=3))",
        1: "(Shard(dim=2), Shard(dim=3))"}[batch]


def test_decode_attention_on_sequence_shards(result):
    """``decode_attention_op`` of caches sharded on their sequence (each
    rank's partials gathered for one combine) equals the plain version of
    the whole tensors, at four placements of the cache."""
    assert result["decode_on_sequence_shards_max_abs_err"] <= 1e-5


def test_mamba_split_of_a_sharded_projection(result):
    assert result["halves"] == "equal"


def test_attention_on_a_sequence_sharded_q(result):
    """``attention_op`` of a q sharded on its sequence over ``model``
    (each rank's rows at their offset against every key) equals the
    reference's ``attention_ref`` of the whole tensors, and its gradients
    (k's and v's summed over the shares) the reference's vjp."""
    worst = result["attention_on_sequence_shards"]
    assert worst["out"] <= 1e-5
    assert worst["grad"] <= 1e-4


def test_hinted_arch_shards_q_on_its_sequence(result):
    """3 heads do not divide ``model``: the hint shards q's sequence in
    prefill and train, as the reference's does."""
    assert result["hinted"]["prefill_hint"] == "model"
    assert result["hinted"]["train_hint"] == "model"


def test_hinted_prefill_logits_equal_reference(result):
    assert result["hinted"]["logits_max_abs_err"] <= 1e-4


def test_hinted_train_loss_and_gradients_equal_reference(result):
    assert result["hinted"]["loss_rel_err"] <= 1e-5
    assert result["hinted"]["grad_worst_rel_err"] <= 1e-4


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("WORLD_SIZE", None)
    return subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                          capture_output=True, text=True)


def test_production_mesh_refuses_other_world_sizes():
    r = _run(
        "from repro_torch.launch.dryrun import fake_group\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "for world, mp in ((1, False), (4, False), (256, True)):\n"
        "    with fake_group(world):\n"
        "        try:\n"
        "            make_production_mesh(multi_pod=mp)\n"
        "        except ValueError as e:\n"
        "            assert '256' in str(e) and '512' in str(e), e\n"
        "            print('refused', world)\n"
        "with fake_group(256):\n"
        "    m = make_production_mesh()\n"
        "    assert m.mesh_dim_names == ('data', 'model')\n"
        "    assert tuple(m.shape) == (16, 16)\n"
        "    assert m.get_group('model').size() == 16\n"
        "with fake_group(512):\n"
        "    m = make_production_mesh(multi_pod=True)\n"
        "    assert tuple(m.shape) == (2, 16, 16)\n"
        "print('ok')\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["refused", "1", "refused", "4", "refused",
                                "256", "ok"]


def test_train_on_the_production_mesh_refuses_world_size_one():
    r = _run(
        "from repro_torch.launch.train import train\n"
        "try:\n"
        "    train('qwen2.5-3b', steps=1, mesh_kind='prod', device='cpu')\n"
        "except ValueError as e:\n"
        "    assert '256' in str(e), e\n"
        "    import torch.distributed as dist\n"
        "    assert not dist.is_initialized()\n"
        "    print('refused')\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "refused"


def test_train_setup_on_the_mesh_holds_a_ranks_shards():
    """``train(mesh_kind="prod")``'s set-up (``setup_on_mesh``) on a fake
    16 x 16 group, on the CPU, as rank 0: the peak of the bytes it holds
    alive (``StepTrace``'s count, ``meta`` storages left out) stays within
    the dry run's argument bytes a chip of the same step, plus one weight
    drawn whole (its f32 draw, scaled in place, and the cast: 4 +
    itemsize bytes an element), and below the whole model with its f32
    moments, which a rank held before placing them. Reduced qwen2.5-3b
    (``dp_zero1``: the moments sharded 256 ways) and reduced
    moonshot-v1-16b-a3b widened to 16 heads and 16 experts, so that
    ``tp`` shards its heads and experts over ``model``."""
    r = _run(
        "import dataclasses\n"
        "from repro_torch.configs import get_config, reduced\n"
        "from repro_torch.launch.dryrun import fake_group, trace_step\n"
        "from repro_torch.launch.mesh import make_production_mesh, "
        "production_shape\n"
        "from repro_torch.launch.train import setup_on_mesh\n"
        "from repro_torch.models.config import InputShape\n"
        "from repro_torch.models.transformer import Model\n"
        "from repro_torch.roofline.trace import StepTrace\n"
        "class Held(StepTrace):\n"
        "    def _hold(self, t):\n"
        "        if t.device.type != 'meta':\n"
        "            super()._hold(t)\n"
        "moon = reduced(get_config('moonshot-v1-16b-a3b'))\n"
        "cfgs = {'qwen2.5-3b': reduced(get_config('qwen2.5-3b')),\n"
        "        'moonshot': dataclasses.replace(moon, n_heads=16,\n"
        "                                        n_kv_heads=16, "
        "n_experts=16)}\n"
        "for name, cfg in cfgs.items():\n"
        "    counts, _, _ = trace_step(cfg, InputShape('t', 64, 256, "
        "'train'), production_shape())\n"
        "    with fake_group(256):\n"
        "        mesh = make_production_mesh()\n"
        "        with Held() as tr:\n"
        "            model, opt, _ = setup_on_mesh(mesh, cfg, device='cpu')\n"
        "        peak = tr.peak_bytes\n"
        "        del model, opt\n"
        "    ps = list(Model(cfg, device='meta').parameters())\n"
        "    leaf = max(p.numel() * (4 + p.element_size()) for p in ps)\n"
        "    whole = sum(p.numel() * (p.element_size() + 8) for p in ps)\n"
        "    print(name, peak, counts['arg_bytes'], leaf, whole)\n")
    assert r.returncode == 0, r.stderr
    rows = [line.split() for line in r.stdout.strip().splitlines()]
    assert [row[0] for row in rows] == ["qwen2.5-3b", "moonshot"]
    for name, peak, args, leaf, whole in rows:
        peak, args, leaf, whole = map(float, (peak, args, leaf, whole))
        assert peak <= args + leaf, (name, peak, args, leaf)
        assert args + leaf < whole, (name, args, leaf, whole)


def test_trace_counts_one_ranks_collectives():
    """``StepTrace`` on a fake 4-rank 2 x 2 mesh counts what rank 0 runs:
    the local shards' products, and each collective with the reference's
    wire bytes (an all-gather its result, an all-reduce twice its
    operand) by the ranks of its group."""
    r = _run(
        "import torch\n"
        "from torch.distributed.tensor import DTensor, Shard, Replicate\n"
        "from repro_torch.launch.dryrun import fake_group\n"
        "from repro_torch.launch.mesh import make_mesh\n"
        "from repro_torch.roofline.trace import StepTrace\n"
        "R = Replicate()\n"
        "with fake_group(4):\n"
        "    m = make_mesh((2, 2), ('data', 'model'))\n"
        "    def dt(shape, pl):\n"
        "        return DTensor.from_local(torch.empty(shape, device='meta'),"
        " m, pl, run_check=False)\n"
        "    x = dt((4, 64), [Shard(0), R])\n"
        "    w = dt((64, 16), [R, Shard(1)])\n"
        "    with StepTrace((x, w)) as tr:\n"
        "        (x @ w).redistribute(m, [Shard(0), R])\n"
        "        (dt((8, 32), [R, Shard(1)]) @ dt((32, 32), [R, Shard(0)])"
        ").full_tensor()\n"
        "    c = tr.counts()\n"
        "    print(c['dot_flops'], c['collectives']['all-gather'],\n"
        "          c['collectives']['all-reduce'],\n"
        "          c['collectives']['total_wire_bytes'],\n"
        "          *sorted(c['wire_by_group']))\n")
    assert r.returncode == 0, r.stderr
    flops, gather, reduce_, total, *groups = r.stdout.split()
    # rank 0's shards: [4, 64] x [64, 16], then [8, 32] x [32, 32]
    assert float(flops) == 2 * 4 * 64 * 16 + 2 * 8 * 32 * 32
    # y's columns gathered over model: the result, [4, 32] f32
    assert float(gather) == 4 * 32 * 4
    # the partial [8, 32] f32 product reduced over model: twice its bytes
    assert float(reduce_) == 2 * 8 * 32 * 4
    assert float(total) == float(gather) + float(reduce_)
    assert groups == ["(0,", "1)"]


def test_fake_process_group_imports():
    """The dry run's fake group is a private torch module: pin that it is
    there, with no fallback."""
    r = _run("from torch.testing._internal.distributed.fake_pg import "
             "FakeStore\nprint(FakeStore.__name__)")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "FakeStore"
