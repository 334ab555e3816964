"""Launch geometry of the placement kernels (``csrc/placement.cu``),
``fused_place`` and ``fanout_commit``, for ``analysis/launch_check.py``.

Both run one warp a replica, blocks of ``BLOCK_B`` replicas (one a warp),
a grid of ``launch_grid(B)``; the ragged last block is masked in the
kernel, so the replica dim of every tensor is a masked dim. Both commit in
place: the window tensors t1, t2 and valid are both inputs and the first
three outputs, declared as aliases sharing their buffers, and a block
touches only its own replicas' windows (``fanout_commit`` only those of
one device, declared as the replicas' whole rows).
"""

from __future__ import annotations

from repro_torch.analysis.launch_check import (
    BlockDecl, KernelGeometry, register,
)
from repro_torch.kernels.placement.placement import BLOCK_B, launch_grid

_MODULE = "repro_torch.kernels.placement.placement"


def _decl(B):
    """A replica-tiled block declaration at batch ``B``."""
    masked = frozenset({0})

    def decl(name, tail, buf=None):
        return BlockDecl(name, (B, *tail), (BLOCK_B, *tail),
                         lambda i: (i,) + (0,) * len(tail),
                         masked_dims=masked, buffer=buf)

    return decl


def _case(B, Dev=4, CFG=3, T=2, W=16):
    decl = _decl(B)
    win = (Dev, CFG, T, W)
    return KernelGeometry(
        kernel="placement", module=_MODULE,
        case=f"B{B}Dev{Dev}CFG{CFG}T{T}W{W}", grid=launch_grid(B),
        inputs=(
            decl("t1", win, "win_t1"), decl("t2", win, "win_t2"),
            decl("valid", win, "win_valid"), decl("min_dur", (CFG,)),
            decl("q1", (Dev,)), decl("dl", (Dev,)), decl("src", ()),
            decl("do", ()),
        ),
        outputs=(
            decl("t1_out", win, "win_t1"), decl("t2_out", win, "win_t2"),
            decl("valid_out", win, "win_valid"), decl("ok", ()),
            decl("sel", ()), decl("start", ()), decl("dur", ()),
            decl("use4", ()), decl("n_dropped", ()),
        ),
        # the windows are committed in place
        aliases={0: 0, 1: 1, 2: 2},
    )


@register("placement")
def geometries():
    # chip_smoke.py's fleet batch and ragged batch, the fleet tests' B=17,
    # and the placement tests' batches
    return [_case(8192), _case(37), _case(17), _case(13), _case(5),
            _case(1)]


def _fanout_case(B, Dev=4, CFG=3, T=2, W=16):
    decl = _decl(B)
    win = (Dev, CFG, T, W)
    return KernelGeometry(
        kernel="fanout_commit", module=_MODULE,
        case=f"B{B}Dev{Dev}CFG{CFG}T{T}W{W}", grid=launch_grid(B),
        inputs=(
            decl("t1", win, "win_t1"), decl("t2", win, "win_t2"),
            decl("valid", win, "win_valid"), decl("min_dur", (CFG,)),
            decl("s", ()), decl("e", ()), decl("do", ()),
        ),
        outputs=(
            decl("t1_out", win, "win_t1"), decl("t2_out", win, "win_t2"),
            decl("valid_out", win, "win_valid"), decl("n_dropped", ()),
        ),
        # the windows are committed in place
        aliases={0: 0, 1: 1, 2: 2},
    )


@register("fanout_commit")
def fanout_geometries():
    # chip_smoke.py's fleet batch and ragged batches, and the fleet tests'
    # B=17 (a larger batch only repeats the same block pattern)
    return [_fanout_case(8192), _fanout_case(1027), _fanout_case(37),
            _fanout_case(17), _fanout_case(1)]
