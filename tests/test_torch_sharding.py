"""The port's sharding rules against the reference's, leaf for leaf, on the
production mesh's shape (16 x 16 and 2 x 16 x 16), with no devices: the
reference's side on an ``AbstractMesh``, as ``tests/test_sharding.py``
builds it, the port's on ``repro_torch.launch.mesh.AbstractMesh``.

Every spec of the port (a tuple of axis names, tuples of names or None a
dim) must equal the reference's ``PartitionSpec`` padded with None to the
leaf's rank; a parameter or moment of the port is one layer of the
reference's stacked leaf, whose leading layer axes must be None and are
dropped. Then the reference's seven cases, ported, and the placements
helper.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh as AbstractMesh_j
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as get_config_j
from repro.data.pipeline import make_batch_specs as batch_specs_j
from repro.launch import sharding as sh_j
from repro.models.transformer import Model as Model_j
from repro_torch.carry import _stack_names
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import sharding as sh
from repro_torch.launch.dryrun import DRY_ARCHS
from repro_torch.launch.mesh import AbstractMesh, production_shape
from repro_torch.models.config import ALL_SHAPES, DECODE_32K, LONG_500K
from repro_torch.models.transformer import Model


def _mesh_j(sizes, names):
    try:
        return AbstractMesh_j(tuple(sizes), tuple(names))
    except TypeError:
        return AbstractMesh_j(tuple(zip(names, sizes)))


MESHES = {"16x16": production_shape(False), "2x16x16": production_shape(True)}
MESHES_J = {k: _mesh_j(m.sizes, m.names) for k, m in MESHES.items()}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = get_config_j(arch)
    return jax.eval_shape(Model_j(cfg).init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return Model(get_config(arch), device="meta")


def _port_shapes(arch):
    return {k: tuple(p.shape)
            for k, p in _port_model(arch).named_parameters()}


def _flat(tree, is_leaf=None):
    """Tree path "a/b/c" -> leaf."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = leaf
    return out


def _spec_tuple(spec, rank):
    """A ``PartitionSpec`` as the port writes it: a tuple of ``rank``
    entries, a list of names as a tuple."""
    entries = [tuple(e) if isinstance(e, list) else e for e in spec]
    return tuple(entries + [None] * (rank - len(entries)))


def _ref_path(cfg, name):
    """(reference tree path, number of layer axes) of a port parameter."""
    head, *rest = name.split(".")
    for key, port, layers in _stack_names(cfg):
        if port == head:
            return "/".join([key, *rest[len(layers):]]), len(layers)
    return name.replace(".", "/"), 0


def _ref_specs(shardings, shapes):
    shardings = _flat(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    shapes = _flat(shapes)
    return {k: _spec_tuple(shardings[k].spec, len(shapes[k].shape))
            for k in shapes}


def _held_to(cfg, port_specs, ref_specs):
    seen = set()
    for name, spec in port_specs.items():
        path, n_layers = _ref_path(cfg, name)
        ref = ref_specs[path]
        assert ref[:n_layers] == (None,) * n_layers, (name, ref)
        assert spec == ref[n_layers:], (name, spec, ref)
        seen.add(path)
    assert seen == set(ref_specs)


@pytest.mark.parametrize("strategy", ["tp", "dp_zero1"])
@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_param_specs_equal_reference(arch, mesh, phase, strategy):
    cfg = get_config(arch)
    shapes_j = _ref_params(arch)
    ref = _ref_specs(sh_j.param_shardings(MESHES_J[mesh], get_config_j(arch),
                                          shapes_j, phase=phase,
                                          strategy=strategy), shapes_j)
    port = sh.param_specs(MESHES[mesh], cfg, _port_shapes(arch), phase=phase,
                          strategy=strategy)
    _held_to(cfg, port, ref)


@pytest.mark.parametrize("strategy", ["tp", "dp_zero1"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_moment_specs_equal_reference(arch, mesh, strategy):
    cfg, cfg_j = get_config(arch), get_config_j(arch)
    shapes_j = _ref_params(arch)
    p_j = sh_j.param_shardings(MESHES_J[mesh], cfg_j, shapes_j,
                               strategy=strategy)
    ref = _ref_specs(sh_j.moment_shardings(MESHES_J[mesh], shapes_j,
                                           strategy, p_j), shapes_j)
    shapes = _port_shapes(arch)
    p = sh.param_specs(MESHES[mesh], cfg, shapes, strategy=strategy)
    port = sh.moment_specs(MESHES[mesh], cfg, shapes, strategy, p)
    _held_to(cfg, port, ref)


@pytest.mark.parametrize("strategy", ["tp", "dp_zero1"])
@pytest.mark.parametrize("shape", ALL_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_batch_specs_equal_reference(arch, mesh, shape, strategy):
    specs_j = batch_specs_j(get_config_j(arch), shape)
    ref = _ref_specs(sh_j.batch_shardings(MESHES_J[mesh], get_config_j(arch),
                                          shape, specs_j, strategy=strategy),
                     specs_j)
    port = sh.batch_specs(MESHES[mesh], get_config(arch), shape,
                          make_batch_specs(get_config(arch), shape),
                          strategy=strategy)
    assert port == ref


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_decode_state_specs_equal_reference(arch, mesh, shape):
    cfg_j = get_config_j(arch)
    model_j = Model_j(cfg_j)
    st_j = jax.eval_shape(
        lambda: model_j.init_decode_state(shape.global_batch, shape.seq_len))
    ref = _ref_specs(sh_j.decode_state_shardings(MESHES_J[mesh], cfg_j,
                                                 shape, st_j), st_j)
    st = _port_model(arch).init_decode_state(shape.global_batch,
                                             shape.seq_len)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in _flat(st_j).items()}
    port = sh.decode_state_specs(MESHES[mesh], get_config(arch), shape, st)
    assert port == ref


# -- the reference's own cases (tests/test_sharding.py), ported -------------

def _axis_sz(mesh, ax):
    if ax is None:
        return 1
    sizes = dict(zip(mesh.names, mesh.sizes))
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= sizes[a]
        return n
    return sizes[ax]


def _check_divisible(specs, shapes, mesh):
    assert set(specs) == set(shapes)
    for k, spec in specs.items():
        for i, ax in enumerate(spec):
            assert shapes[k][i] % _axis_sz(mesh, ax) == 0, (k, spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_param_specs_divisible(arch, mesh):
    shapes = _port_shapes(arch)
    for phase in ("train", "decode"):
        specs = sh.param_specs(MESHES[mesh], get_config(arch), shapes,
                               phase=phase)
        _check_divisible(specs, shapes, MESHES[mesh])


@pytest.mark.parametrize("arch", DRY_ARCHS)
@pytest.mark.parametrize("shape", [DECODE_32K, LONG_500K],
                         ids=lambda s: s.name)
def test_decode_state_specs_divisible(arch, shape):
    st = _port_model(arch).init_decode_state(shape.global_batch,
                                             shape.seq_len)
    mesh = MESHES["16x16"]
    specs = sh.decode_state_specs(mesh, get_config(arch), shape, st)
    _check_divisible(specs, {k: tuple(v.shape) for k, v in st.items()}, mesh)


def test_kv_cache_not_hd_sharded():
    """qwen's 2 kv heads on a 16-way axis: the cache shards S, never hd."""
    st = _port_model("qwen2.5-3b").init_decode_state(
        DECODE_32K.global_batch, DECODE_32K.seq_len)
    spec = sh.decode_state_specs(MESHES["16x16"], get_config("qwen2.5-3b"),
                                 DECODE_32K, st)["k"]
    assert spec[4] is None
    assert spec[2] == "model"


def test_batch_specs_replicate_indivisible():
    specs = {"tokens": (1,)}
    assert sh.batch_specs(MESHES["16x16"], get_config("qwen2.5-3b"),
                          LONG_500K, specs) == {"tokens": (None,)}


def test_pick_strategy():
    assert sh.pick_strategy(get_config("gemma2-2b"), "train") == "dp_zero1"
    assert sh.pick_strategy(get_config("granite-8b"), "train") == "tp"
    assert sh.pick_strategy(get_config("kimi-k2-1t-a32b"), "train") == "tp"
    assert sh.pick_strategy(get_config("gemma2-2b"), "decode") == "tp"


def test_zero1_moments_sharded():
    cfg, mesh = get_config("gemma2-2b"), MESHES["16x16"]
    shapes = _port_shapes("gemma2-2b")
    p = sh.param_specs(mesh, cfg, shapes, strategy="dp_zero1")
    m = sh.moment_specs(mesh, cfg, shapes, "dp_zero1", p)
    assert all(all(e is None for e in s) for s in p.values())
    assert m["embed"] != (None, None)
    _check_divisible(m, shapes, mesh)


def test_expert_weights_expert_parallel():
    cfg = get_config("deepseek-v2-236b")
    specs = sh.param_specs(MESHES["16x16"], cfg, _port_shapes(
        "deepseek-v2-236b"), phase="train")
    # [E, D, F] a layer (the reference's [L, E, D, F]): experts over model
    assert specs["layers.0.moe.wg"][0] == "model"


def test_a_sharded_layer_axis_is_dropped():
    """A spec that shards a stacked layer axis (reduced zamba2's A_log
    [n_groups, g, H] on g) leaves the port's per-layer tensor replicated
    there; no arch of the pool has one (the parity tests)."""
    cfg = get_config("zamba2-7b")
    assert sh._unstack(cfg, "groups.0.0.ssm.A_log", (13, 6, 112),
                       [None, "model", None]) == (None,)
    assert sh._unstack(cfg, "embed", (32000, 3584), ["model", None]) == \
        ("model", None)


# -- placements ---------------------------------------------------------------

def test_placements_of_pod_data_are_two_shards_major_first():
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements((None, None), mesh) == (Replicate(),) * 3
    assert sh.placements((None, ("pod", "data", "model")), mesh) == \
        (Shard(1),) * 3


def test_placements_refuse_an_axis_twice():
    mesh = AbstractMesh((16, 16), ("data", "model"))
    with pytest.raises(ValueError, match="twice"):
        sh.placements(("model", "model"), mesh)


# -- the collective term ------------------------------------------------------

def test_collective_term_charges_each_group_at_its_link():
    """Ranks row-major, 8 a node: a group inside one node at NVLink's 450
    GB/s, any other at InfiniBand's 50 GB/s; on 16 x 16 both axes cross
    nodes (a model group is 16 consecutive ranks, a data group a
    stride-16 one)."""
    from repro_torch.roofline import terms

    assert terms.link_bytes_per_s(range(8)) == 450e9
    assert terms.link_bytes_per_s(range(8, 16)) == 450e9
    assert terms.link_bytes_per_s(range(16)) == 50e9
    assert terms.link_bytes_per_s(range(0, 256, 16)) == 50e9
    assert terms.collective_seconds({tuple(range(8)): 450e9,
                                     tuple(range(0, 32, 16)): 50e9}) == 2.0
    cfg = get_config("qwen2.5-3b")
    counts = {"dot_flops": 989e12, "dot_bytes": 0.0,
              "collectives": {"total_wire_bytes": 100e9},
              "wire_by_group": {tuple(range(16)): 100e9}}
    t = terms.roofline_terms(cfg, ALL_SHAPES[0], counts, 256 * 3.35e12,
                             n_chips=256)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 1.0
    assert t["collective_s"] == 2.0 and t["bottleneck"] == "collective"
    assert t["wire_bytes_per_chip"] == 100e9
    assert t["arg_bytes_per_chip"] == 3.35e12
    assert t["model_flops_per_chip"] == t["model_flops"] / 256
