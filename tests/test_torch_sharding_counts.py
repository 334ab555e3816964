"""The port's sharded step against the reference's compiled SPMD program,
per chip, on a 2 x 2 mesh ("data", "model"): one arch of each family at
``reduced(...)`` (f32), batch 2 x 128, prefill, decode (against a
128-long cache) and train (``tests/_sharding_ref.py`` builds both legs,
each in a process of its own, the two run at once).

Per chip, the dot FLOPs, the dot bytes and the argument bytes of the two
must be equal, and the collective wire bytes equal by kind and in total.
Every case where they are not is pinned below, the port's and the
reference's numbers both, with its cause:

- ``ZERO1_BATCH``: these train steps take ``dp_zero1`` (every reduced
  config is below 4e9 parameters): parameters replicated, the batch over
  all four ranks, which batch 2 does not divide, so the batch is
  replicated too. The port then computes the whole step on each rank;
  GSPMD spreads it by propagating the ZeRO-1 moments' sharding back
  through the step, with activation collectives the port does not need.
  At the production mesh's sizes the batch divides (256 on 16 x 16).
- ``KV_LAYER``: the reference's decode-state rule takes the first dim
  equal to the batch as the batch; at these sizes that is the layer axis
  (L = B = 2 of ``[L, B, ...]``), so the caches and states shard their
  layer axis over ``data``. A layer of the port's state is a view of that
  axis, which DTensor gathers; GSPMD's scan reads its slice in place.
- ``TUPLE``: XLA combines collectives into one tuple-shaped op (the MoE's
  and the train steps' all-reduces), and ``repro.roofline.hlo_graph``
  reads such an op as 0 bytes (its parser takes the tuple's parenthesis
  for the operand list), so the reference's all-reduce bytes are short.
- ``XZ_SPLIT``: a Mamba block splits its column-sharded ``in_proj``
  output [x | z]: the port sends each shard's two blocks to their owners
  in one all-to-all (``spmd.halves``), GSPMD in a collective-permute of
  the same bytes a chip.
- ``SSD_CB``: the SSD's per-chunk C·Bᵀ products have no head axis: the
  port computes them on each model shard, GSPMD splits them.
- ``A_LOG``: the reference's right-aligned ``A_log`` rule shards a hybrid
  group's stacked [n_groups, g, H] on g (a layer axis, as ``model``
  divides g = 2 here); the port's per-layer tensor is replicated there
  (``sharding._unstack``).
- ``UNUSED_ARGS``: ``jax.jit`` drops the arguments a step never reads
  (the encoder's weights in a decode step); the port counts them.
"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)

from _sharding_ref import FAMILIES, KINDS  # noqa: E402

CASES = [(a, k) for a in FAMILIES for k in KINDS]
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: (arch, kind) -> (port dot FLOPs, reference's, port dot bytes,
#: reference's), cause
COMPUTE = {
    ("qwen2.5-3b", "train"): (
        (2214592512.0, 591396864.0, 58982400.0, 29982720.0), "ZERO1_BATCH"),
    ("gemma2-2b", "train"): (
        (2214592512.0, 578813952.0, 58982400.0, 28114944.0), "ZERO1_BATCH"),
    ("llava-next-34b", "train"): (
        (2214592512.0, 629145600.0, 58982400.0, 29294592.0), "ZERO1_BATCH"),
    ("seamless-m4t-medium", "train"): (
        (3028287488.0, 844627968.0, 97386496.0, 45105152.0), "ZERO1_BATCH"),
    ("falcon-mamba-7b", "train"): (
        (1837105152.0, 541065216.0, 94208000.0, 49553408.0), "ZERO1_BATCH"),
    ("zamba2-7b", "prefill"): (
        (434438144.0, 434274304.0, 19013632.0, 18972672.0), "SSD_CB"),
    ("zamba2-7b", "train"): (
        (6512574464.0, 1781825536.0, 210147328.0, 103899136.0),
        "ZERO1_BATCH"),
}

#: (arch, kind) -> (port argument bytes, reference's), cause
ARGUMENTS = {
    ("seamless-m4t-medium", "decode"): ((4959244, 2989068), "UNUSED_ARGS"),
    ("zamba2-7b", "prefill"): ((5730432, 5725184), "A_LOG"),
    ("zamba2-7b", "decode"): ((5892748, 5887500), "A_LOG"),
}

#: (arch, kind) -> {kind: (port wire bytes, reference's)} of every kind
#: either moves, cause
COLLECTIVES = {
    ("qwen2.5-3b", "decode"): ({"all-gather": (263168.0, 0.0),
                                "all-reduce": (10240.0, 10240.0)},
                               "KV_LAYER"),
    ("qwen2.5-3b", "train"): ({"all-gather": (6695424.0, 9182208.0),
                               "all-reduce": (32.0, 3700736.0),
                               "collective-permute": (0.0, 65664.0)},
                              "ZERO1_BATCH"),
    ("gemma2-2b", "decode"): ({"all-gather": (263168.0, 0.0),
                               "all-reduce": (10240.0, 10240.0)},
                              "KV_LAYER"),
    ("gemma2-2b", "train"): ({"all-gather": (6692352.0, 8918016.0),
                              "all-reduce": (32.0, 1603584.0)},
                             "ZERO1_BATCH"),
    ("llava-next-34b", "decode"): ({"all-gather": (263168.0, 0.0),
                                    "all-reduce": (10240.0, 10240.0)},
                                   "KV_LAYER"),
    ("llava-next-34b", "train"): ({"all-gather": (7478784.0, 9409536.0),
                                   "all-reduce": (32.0, 1075200.0)},
                                  "ZERO1_BATCH"),
    ("moonshot-v1-16b-a3b", "prefill"): ({"all-gather": (8.0, 4096.0),
                                          "all-reduce": (1310728.0,
                                                         1048576.0)},
                                         "TUPLE"),
    ("moonshot-v1-16b-a3b", "decode"): ({"all-gather": (263176.0, 131104.0),
                                         "all-reduce": (10248.0, 8192.0)},
                                        "KV_LAYER"),
    ("moonshot-v1-16b-a3b", "train"): ({"all-gather": (520.0, 8192.0),
                                        "all-reduce": (8285216.0, 1050632.0),
                                        "reduce-scatter": (1536.0, 0.0)},
                                       "TUPLE"),
    ("deepseek-v2-236b", "prefill"): ({"all-gather": (98312.0, 102400.0),
                                       "all-reduce": (1312776.0, 1050624.0)},
                                      "TUPLE"),
    ("deepseek-v2-236b", "decode"): ({"all-gather": (329736.0, 164640.0),
                                      "all-reduce": (10264.0, 8208.0),
                                      "collective-permute": (0.0, 81920.0)},
                                     "KV_LAYER"),
    ("deepseek-v2-236b", "train"): ({"all-gather": (148744.0, 207104.0),
                                     "all-reduce": (8898080.0, 1415176.0),
                                     "reduce-scatter": (198144.0, 0.0)},
                                    "TUPLE"),
    ("seamless-m4t-medium", "decode"): ({"all-gather": (263168.0, 0.0),
                                         "all-reduce": (14336.0, 14336.0)},
                                        "KV_LAYER"),
    ("seamless-m4t-medium", "train"): ({"all-gather": (14565888.0,
                                                       16395264.0),
                                        "all-reduce": (32.0, 2928640.0)},
                                       "ZERO1_BATCH"),
    ("falcon-mamba-7b", "prefill"): ({"all-reduce": (884736.0, 884736.0),
                                      "all-to-all": (524288.0, 0.0),
                                      "collective-permute": (0.0, 524288.0)},
                                     "XZ_SPLIT"),
    ("falcon-mamba-7b", "decode"): ({"all-gather": (233472.0, 77824.0),
                                     "all-reduce": (6912.0, 6912.0),
                                     "all-to-all": (4096.0, 0.0),
                                     "collective-permute": (0.0, 4096.0)},
                                    ("KV_LAYER", "XZ_SPLIT")),
    ("falcon-mamba-7b", "train"): ({"all-gather": (6830592.0, 8911872.0),
                                    "all-reduce": (32.0, 8665088.0),
                                    "collective-permute": (0.0, 1404928.0)},
                                   "ZERO1_BATCH"),
    ("zamba2-7b", "prefill"): ({"all-gather": (0.0, 81920.0),
                                "all-reduce": (2872320.0, 2954240.0),
                                "all-to-all": (1310720.0, 0.0),
                                "collective-permute": (0.0, 1392640.0)},
                               ("XZ_SPLIT", "SSD_CB")),
    ("zamba2-7b", "decode"): ({"all-gather": (1041408.0, 287360.0),
                               "all-reduce": (22440.0, 22440.0),
                               "all-to-all": (10240.0, 0.0),
                               "collective-permute": (0.0, 10880.0)},
                              ("KV_LAYER", "XZ_SPLIT")),
    ("zamba2-7b", "train"): ({"all-gather": (17176992.0, 25656256.0),
                              "all-reduce": (32.0, 24848384.0),
                              "collective-permute": (0.0, 3512320.0)},
                             "ZERO1_BATCH"),
}

CAUSES = {"ZERO1_BATCH", "KV_LAYER", "TUPLE", "XZ_SPLIT", "SSD_CB",
          "A_LOG", "UNUSED_ARGS"}


def _leg(name: str) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(HERE, "..", "src"),
                    os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, os.path.join(HERE,
                                                          "_sharding_ref.py"),
                             name], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, text=True)


@pytest.fixture(scope="module")
def legs():
    procs = {name: _leg(name) for name in ("reference", "port")}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=400)
        assert p.returncode == 0, stderr[-4000:]
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("arch,kind", CASES)
def test_counts_per_chip_equal_reference(legs, arch, kind):
    ref = legs["reference"][f"{arch}/{kind}"]
    port = legs["port"][f"{arch}/{kind}"]
    got = (port["dot_flops"], ref["dot_flops"], port["dot_bytes"],
           ref["dot_bytes"])
    if (arch, kind) in COMPUTE:
        assert got == COMPUTE[arch, kind][0]
        assert got[0] != got[1]
    else:
        assert got[0] == got[1] and got[2] == got[3]
    args = (port["arg_bytes"], ref["arg_bytes"])
    if (arch, kind) in ARGUMENTS:
        assert args == ARGUMENTS[arch, kind][0]
    else:
        assert args[0] == args[1]
    coll = {k: (port["collectives"].get(k, 0.0), ref["collectives"].get(
        k, 0.0)) for k in COLLECTIVE_KINDS}
    moved = {k: v for k, v in coll.items() if v != (0.0, 0.0)}
    if (arch, kind) in COLLECTIVES:
        assert moved == COLLECTIVES[arch, kind][0]
    else:
        assert all(p == r for p, r in coll.values())
    assert port["collectives"]["total_wire_bytes"] == sum(
        p for p, _ in coll.values())
    # a 2 x 2 mesh on four ranks of one node: every group is one axis of 2
    assert set(port["groups"]) <= {2}


def test_every_pin_names_a_cause():
    for table in (COMPUTE, ARGUMENTS, COLLECTIVES):
        assert set(table) <= set(CASES)
        for _, cause in table.values():
            assert set((cause,) if isinstance(cause, str) else cause) \
                <= CAUSES
