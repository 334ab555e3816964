"""One rank of the gloo runs of ``test_torch_sharding_run.py``:

    python tests/_sharding_run.py RANK WORLD PORT DIR

Joins a gloo group of WORLD ranks at ``tcp://localhost:PORT``, builds the
2 x 2 mesh ("data", "model") and, for each arch whose reference arrays
``DIR/<arch>.npz`` holds (the reference's parameters ``p/<path>``, the
batch, and its logits, loss and gradients ``g/<path>``):

- prefill: the port's model on the mesh (``carry.model_on_mesh_from_numpy``,
  prefill specs) gives the reference's logits;
- decode: the model placed by the decode specs, its decode state by
  ``decode_state_specs`` (batch 4: rows over ``data``; batch 1: the
  cache's sequence over ``data``), gives the reference's logits at each
  of DECODE_STEPS steps;
- train: the model, its AdamW state and the batch placed as
  ``train(mesh_kind="prod")`` places them (``pick_strategy``'s specs):
  ``Model.loss`` and its backward give the reference's loss and every
  gradient leaf, and an AdamW step on the mesh moves the loss;
- checkpoint: ``DIR/<arch>_ckpt``, saved whole, restored onto the mesh by
  ``checkpoint.restore(..., shardings=, mesh=)``, equals shard by shard,
  bit for bit, the shards of the reference's parameters.

and first ``spmd.halves`` (Mamba's split of its sharded ``in_proj``
output) on a 2 x 2 and a 1 x 4 mesh, against ``chunk``, and
``decode_attention_op`` of caches sharded on their sequence against its
plain version of the whole tensors.

Then the sequence-sharded q: ``attention_op`` of a q placed on its
sequence over ``model`` (the dispatch the card takes, the plain version
on the CPU: each rank's rows at their offset against every key) against
the reference's ``attention_ref`` of the whole tensors and its vjp
(``DIR/attention_offset.npz``), on the 2 x 2 and a 1 x 4 mesh; and
HINTED_ARCH reduced with heads that do not divide ``model`` (HINTED_HEADS),
so that ``configure_attention_sharding`` sets the hint itself: its prefill
logits, train loss and gradients against ``DIR/<arch>-hinted.npz``.

Each check raises on a miss (the rank then exits non-zero); rank 0 writes
the measured differences to ``DIR/result.json``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import carry, spmd
from repro_torch.checkpoint import restore
from repro_torch.configs import get_config, reduced
from repro_torch.launch import sharding
from repro_torch.launch.dryrun import reset_hints
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import place_on_mesh
from repro_torch.models.config import InputShape
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_update

ARCHS = ("qwen2.5-3b", "moonshot-v1-16b-a3b")
#: the arch run with a sequence-sharded q: 3 heads and 1 kv head do not
#: divide ``model`` (2) on the 2 x 2 mesh; S 32 crosses the shards'
#: boundary at 16 and the reduced window of 16
HINTED_ARCH = "gemma2-2b"
HINTED_HEADS = dict(n_heads=3, n_kv_heads=1)
#: attention on a sequence-sharded q: (name, mesh shape, B, H, K, S, hd,
#: options, q's spec); S 30 gives the 1 x 4 mesh ragged shares (8, 8, 8, 6)
ATTN_SEQ_CASES = (
    ("2x2-window-softcap", (2, 2), 2, 4, 2, 32, 16,
     {"window": 8, "softcap": 20.0}, ("data", None, "model", None)),
    ("1x4-causal", (1, 4), 1, 4, 2, 30, 16, {},
     (None, None, "model", None)),
)
ATTN_TOL = 1e-5            # absolute, f32 outputs
ATTN_GRAD_TOL = 1e-4       # of each gradient's max |reference|
#: decode: batch 4 (rows over data) and 1 (the cache's sequence over
#: data), DECODE_STEPS steps from position DECODE_POS of a cache of
#: DECODE_CACHE, across its slices' boundary at 16
DECODE_BATCHES = (4, 1)
DECODE_CACHE, DECODE_POS, DECODE_STEPS = 32, 14, 4
LOGITS_TOL = 1e-4          # absolute, f32 logits
LOSS_RTOL = 1e-5           # relative
GRAD_TOL = 1e-4            # of each leaf's max |reference|


def _load(out_dir: str, name: str) -> dict:
    with np.load(os.path.join(out_dir, f"{name}.npz")) as f:
        return {k: f[k] for k in f.files}


def _tree(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, a in flat.items():
        if not key.startswith(prefix):
            continue
        *parents, last = key[len(prefix):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = a
    return tree


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _specs(mesh, cfg, kind: str):
    shapes = {k: tuple(p.shape)
              for k, p in Model(cfg, device="meta").named_parameters()}
    strategy = sharding.pick_strategy(cfg, kind)
    return sharding.param_specs(mesh, cfg, shapes, kind, strategy), strategy


def run_arch(mesh, arch: str, data: dict, out_dir: str) -> dict:
    cfg = reduced(get_config(arch))
    params = _tree(data, "p/")
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    shape_of = {"tokens": batch["tokens"]}
    res = {}

    # prefill
    sharding.configure_attention_sharding(mesh, cfg, "prefill")
    sharding.configure_moe_sharding(mesh, cfg)
    specs, _ = _specs(mesh, cfg, "prefill")
    model = carry.model_on_mesh_from_numpy(cfg, params, mesh, specs,
                                           device="cpu")
    shape = InputShape("run", batch["tokens"].shape[1],
                       batch["tokens"].shape[0], "prefill")
    b = spmd.distribute_tree(
        {"tokens": batch["tokens"]}, mesh,
        sharding.batch_specs(mesh, cfg, shape, shape_of))
    with torch.no_grad():
        logits = model(b)[0].full_tensor()
    err = float((logits - torch.from_numpy(data["logits"])).abs().max())
    assert err <= LOGITS_TOL, (arch, "logits", err)
    res["logits_max_abs_err"] = err

    # decode, from DECODE_POS
    sharding.configure_attention_sharding(mesh, cfg, "decode")
    specs, _ = _specs(mesh, cfg, "decode")
    model = carry.model_on_mesh_from_numpy(cfg, params, mesh, specs,
                                           device="cpu")
    for B in DECODE_BATCHES:
        shape = InputShape("dec", DECODE_CACHE, B, "decode")
        state = model.init_decode_state(B, DECODE_CACHE)
        state["pos"].fill_(DECODE_POS)
        state = spmd.distribute_tree(state, mesh, sharding.decode_state_specs(
            mesh, cfg, shape, state))
        res[f"decode{B}_cache_placements"] = str(state["k"].placements)
        err = 0.0
        with torch.no_grad():
            for t, want in zip(data[f"dec{B}/tokens"],
                               data[f"dec{B}/logits"]):
                tok = torch.from_numpy(t)
                tok = spmd.distribute(tok, mesh, sharding.batch_specs(
                    mesh, cfg, shape, {"t": tok})["t"])
                lg, state = model.decode_step(state, tok)
                err = max(err, float((lg.full_tensor()
                                      - torch.from_numpy(want)).abs().max()))
        assert err <= LOGITS_TOL, (arch, "decode", B, err)
        res[f"decode{B}_max_abs_err"] = err

    # train, placed as train(mesh_kind="prod") places it: the loss and its
    # gradients, then an AdamW step on the mesh
    model = Model(cfg, device="cpu")
    model.load_state_dict(carry.model_params_from_numpy(cfg, params,
                                                        device="cpu"))
    model.requires_grad_(True)
    opt, place_batch = place_on_mesh(mesh, cfg, model)
    strategy = sharding.pick_strategy(cfg, "train")
    b = place_batch(batch)
    loss = model.loss(b)
    loss.backward()
    loss = float(loss.full_tensor())
    want = float(data["loss"])
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (arch, loss, want)
    res["loss_rel_err"] = abs(loss - want) / abs(want)
    grads = _flat(carry.model_params_to_numpy(
        cfg, {k: p.grad for k, p in model.named_parameters()}))
    worst = 0.0
    for path, g in grads.items():
        ref = data["g/" + path]
        scale = max(float(np.abs(ref).max()), 1e-30)
        rel = float(np.abs(g - ref).max()) / scale
        assert rel <= GRAD_TOL, (arch, path, rel)
        worst = max(worst, rel)
    assert set(grads) == {k[2:] for k in data if k.startswith("g/")}
    res["grad_worst_rel_err"] = worst
    res["strategy"] = strategy
    adamw_update(AdamWConfig(), None, opt, model)
    after = float(model.loss(b).full_tensor())
    assert np.isfinite(after) and after != loss, (arch, loss, after)
    res["loss_after_a_step"] = after
    specs, _ = _specs(mesh, cfg, "train")

    # checkpoint: restored onto the mesh, shard by shard
    model, _ = restore(os.path.join(out_dir, f"{arch}_ckpt"),
                       like=Model(cfg, device="meta"), shardings=specs,
                       mesh=mesh)
    state = carry.model_params_from_numpy(cfg, params, device="cpu")
    n = 0
    for name, p in model.named_parameters():
        want = spmd.distribute(state[name], mesh, specs[name])
        assert p.placements == want.placements, name
        assert torch.equal(p.to_local(), want.to_local()), name
        n += 1
    res["checkpoint_leaves_equal"] = n
    reset_hints(cfg, shape)
    return res


def check_halves() -> None:
    """``spmd.halves`` of a [B, S, 2w] tensor column-sharded over a 2 x 2
    and a 1 x 4 mesh: both halves and the gradient equal ``chunk``'s."""
    g = torch.Generator().manual_seed(0)
    full = torch.randn(2, 8, 32, generator=g)
    a, b = torch.randn(2, 8, 16, generator=g), torch.randn(2, 8, 16,
                                                         generator=g)
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"))
        spec = ("data", None, "model")
        t = spmd.distribute(full, mesh, spec).requires_grad_(True)
        x, z = spmd.halves(t)
        assert x.placements == z.placements == t.placements
        assert torch.equal(x.full_tensor(), full.chunk(2, dim=-1)[0])
        assert torch.equal(z.full_tensor(), full.chunk(2, dim=-1)[1])
        loss = (x * spmd.distribute(a, mesh, spec)).sum() + \
            (z * spmd.distribute(b, mesh, spec)).sum()
        loss.backward()
        assert torch.equal(t.grad.full_tensor(), torch.cat([a, b], dim=-1))


#: the caches' specs of the sequence-sharded decode check: S over one mesh
#: dim, over both, beside sharded batch rows, beside sharded kv heads
SEQ_CACHE_SPECS = ((None, "model", None, None),
                   (None, ("data", "model"), None, None),
                   ("data", "model", None, None),
                   (None, "data", "model", None))
DECODE_TOL = 1e-5          # absolute, f32


def check_decode_on_sequence_shards(mesh) -> float:
    """``decode_attention_op`` (the plain route: the split pass's plain
    version a rank, the partials gathered, one combine) of caches sharded
    on their sequence, q's heads over ``model``: equal to
    ``decode_attention_ref`` of the whole tensors within DECODE_TOL, at
    positions that leave some ranks' slices with no visible key, with and
    without a window and a soft-cap. Returns the largest difference."""
    from repro_torch.kernels.flash_decode.ops import decode_attention_op
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref

    g = torch.Generator().manual_seed(1)
    B, S, H, K, hd = 4, 64, 8, 4, 16
    q = torch.randn(B, H, hd, generator=g)
    k = torch.randn(B, S, K, hd, generator=g)
    v = torch.randn(B, S, K, hd, generator=g)
    pos = torch.tensor([0, 13, 40, 63], dtype=torch.int32)
    worst = 0.0
    for spec in SEQ_CACHE_SPECS:
        kd, vd = (spmd.distribute(t, mesh, spec) for t in (k, v))
        qd = spmd.distribute(q, mesh, (None, "model", None))
        pd = spmd.distribute(pos, mesh, (None,))
        for window, cap in ((0, 0.0), (20, 0.0), (0, 30.0)):
            got = decode_attention_op(qd, kd, vd, pd, window=window,
                                      softcap=cap, backend="ref")
            want = decode_attention_ref(q, k, v, pos, window=window,
                                        softcap=cap)
            err = float((got.full_tensor() - want).abs().max())
            assert err <= DECODE_TOL, (spec, window, cap, err)
            worst = max(worst, err)
    return worst


def check_attention_on_sequence_shards(data: dict) -> dict:
    """``attention_op`` of each ATTN_SEQ_CASES q DTensor, k and v over the
    batch's data shards only: the output equal to the reference's within
    ATTN_TOL, and the gradients of q, k and v (k's and v's partial sums
    over the shares) within ATTN_GRAD_TOL of each one's max. Returns the
    largest differences."""
    from repro_torch.kernels.flash_attention.ops import attention_op

    worst = {"out": 0.0, "grad": 0.0}
    for name, shape, *_, kw, spec in ATTN_SEQ_CASES:
        mesh = make_mesh(shape, ("data", "model"))
        kv_spec = (spec[0], None, None, None)
        q, k, v, g = (torch.from_numpy(data[f"{name}/{x}"])
                      for x in ("q", "k", "v", "g"))
        qd = spmd.distribute(q, mesh, spec).requires_grad_(True)
        kd, vd = (spmd.distribute(t, mesh, kv_spec).requires_grad_(True)
                  for t in (k, v))
        out = attention_op(qd, kd, vd, causal=True, **kw)
        assert out.placements == qd.placements, (name, out.placements)
        (out * spmd.distribute(g, mesh, spec)).sum().backward()
        err = float((out.full_tensor()
                     - torch.from_numpy(data[f"{name}/out"])).abs().max())
        assert err <= ATTN_TOL, (name, "out", err)
        worst["out"] = max(worst["out"], err)
        for x, t in (("q", qd), ("k", kd), ("v", vd)):
            ref = data[f"{name}/d{x}"]
            rel = float(np.abs(t.grad.full_tensor().numpy() - ref).max()
                        / max(float(np.abs(ref).max()), 1e-30))
            assert rel <= ATTN_GRAD_TOL, (name, x, rel)
            worst["grad"] = max(worst["grad"], rel)
    return worst


def hinted_config():
    return dataclasses.replace(reduced(get_config(HINTED_ARCH)),
                               **HINTED_HEADS)


def run_hinted(mesh, data: dict) -> dict:
    """HINTED_ARCH at HINTED_HEADS on ``mesh``: the prefill logits, the
    train loss and every gradient leaf against the reference's, with the
    attention hint set by ``configure_attention_sharding`` in both."""
    from repro_torch.models import layers

    cfg = hinted_config()
    params = _tree(data, "p/")
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    res = {}

    sharding.configure_attention_sharding(mesh, cfg, "prefill")
    res["prefill_hint"] = layers._ATTN_Q_SHARDING
    specs, _ = _specs(mesh, cfg, "prefill")
    model = carry.model_on_mesh_from_numpy(cfg, params, mesh, specs,
                                           device="cpu")
    shape = InputShape("run", batch["tokens"].shape[1],
                       batch["tokens"].shape[0], "prefill")
    b = spmd.distribute_tree(
        {"tokens": batch["tokens"]}, mesh,
        sharding.batch_specs(mesh, cfg, shape, {"tokens": batch["tokens"]}))
    with torch.no_grad():
        logits = model(b)[0].full_tensor()
    err = float((logits - torch.from_numpy(data["logits"])).abs().max())
    assert err <= LOGITS_TOL, (HINTED_ARCH, "logits", err)
    res["logits_max_abs_err"] = err

    model = Model(cfg, device="cpu")
    model.load_state_dict(carry.model_params_from_numpy(cfg, params,
                                                        device="cpu"))
    model.requires_grad_(True)
    opt, place_batch = place_on_mesh(mesh, cfg, model)
    res["train_hint"] = layers._ATTN_Q_SHARDING
    loss = model.loss(place_batch(batch))
    loss.backward()
    loss = float(loss.full_tensor())
    want = float(data["loss"])
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
    res["loss_rel_err"] = abs(loss - want) / abs(want)
    grads = _flat(carry.model_params_to_numpy(
        cfg, {k: p.grad for k, p in model.named_parameters()}))
    assert set(grads) == {k[2:] for k in data if k.startswith("g/")}
    worst = 0.0
    for path, g in grads.items():
        ref = data["g/" + path]
        rel = float(np.abs(g - ref).max()) / max(float(np.abs(ref).max()),
                                                  1e-30)
        assert rel <= GRAD_TOL, (HINTED_ARCH, path, rel)
        worst = max(worst, rel)
    res["grad_worst_rel_err"] = worst
    reset_hints(cfg, shape)
    return res


def main() -> None:
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        check_halves()
        mesh = make_mesh((2, 2), ("data", "model"))
        out = {"halves": "equal",
               "decode_on_sequence_shards_max_abs_err":
                   check_decode_on_sequence_shards(mesh)}
        for arch in ARCHS:
            out[arch] = run_arch(mesh, arch, _load(out_dir, arch), out_dir)
        out["attention_on_sequence_shards"] = \
            check_attention_on_sequence_shards(
                _load(out_dir, "attention_offset"))
        out["hinted"] = run_hinted(mesh, _load(out_dir,
                                               f"{HINTED_ARCH}-hinted"))
        if rank == 0:
            with open(os.path.join(out_dir, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
