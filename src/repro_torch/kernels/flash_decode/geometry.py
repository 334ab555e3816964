"""Launch geometry of the decode-attention kernel (``csrc/flash_decode.cu``),
for ``analysis/launch_check.py``.

One block per (kv head, batch row): grid ``launch_grid(B, K)`` in (x, y)
order. A block reads the G query heads of its kv head, that head's rows of
both caches ([B,S,K,hd], the visible keys of which it visits) and its
row's pos, and writes the G output heads. The grid has no ragged edge.
"""

from __future__ import annotations

from repro_torch.analysis.launch_check import (
    BlockDecl, KernelGeometry, register,
)
from repro_torch.kernels.flash_decode.flash_decode import launch_grid

_MODULE = "repro_torch.kernels.flash_decode.flash_decode"


def _case(B, H, K, S, hd):
    G = H // K
    heads = lambda name: BlockDecl(name, (B, H, hd), (1, G, hd),
                                   lambda kh, b: (b, kh, 0))
    cache = lambda name: BlockDecl(name, (B, S, K, hd), (1, S, 1, hd),
                                   lambda kh, b: (b, 0, kh, 0))
    return KernelGeometry(
        kernel="flash_decode", module=_MODULE,
        case=f"B{B}H{H}K{K}S{S}hd{hd}", grid=launch_grid(B, K),
        inputs=(heads("q"), cache("k_cache"), cache("v_cache"),
                BlockDecl("pos", (B,), (1,), lambda kh, b: (b,))),
        outputs=(heads("o"),),
    )


@register("flash_decode")
def geometries():
    return [
        # zamba2-7b's decode step; chip_smoke.py's GQA cases
        _case(4, 32, 32, 32768, 112), _case(3, 8, 2, 1000, 64),
        _case(2, 16, 2, 4097, 128),
        # the decode tests' GQA and MQA cases
        _case(2, 8, 2, 256, 64), _case(3, 2, 1, 128, 32),
    ]
