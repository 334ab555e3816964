"""Launch geometry of the flash-attention kernels (``csrc/``), for
``analysis/launch_check.py``.

One block per (BLOCK_Q[route] query rows, head, batch row): grid
``launch_grid(B, H, S, route)`` in CUDA's (x, y, z) order, 128 rows a block
on the bf16 route (``flash_attention_wgmma.cu``), 64 on the f32 one
(``flash_attention.cu``). A block reads its rows of q and every key and
value row of its kv head (the causal and window masks skip tiles inside
the block's loop, not across blocks), and writes its rows of o. The ragged
last row block is masked in the kernel.
"""

from __future__ import annotations

from repro_torch.analysis.launch_check import (
    BlockDecl, KernelGeometry, register,
)
from repro_torch.kernels.flash_attention.flash_attention import (
    BLOCK_Q, launch_grid,
)

_MODULE = "repro_torch.kernels.flash_attention.flash_attention"


def _case(B, H, K, S, hd, route):
    G = H // K
    rows = lambda name: BlockDecl(
        name, (B, H, S, hd), (1, 1, BLOCK_Q[route], hd),
        lambda i, h, b: (b, h, i, 0), masked_dims=frozenset({2}))
    keys = lambda name: BlockDecl(
        name, (B, K, S, hd), (1, 1, S, hd), lambda i, h, b: (b, h // G, 0, 0))
    return KernelGeometry(
        kernel="flash_attention", module=_MODULE,
        case=f"{route}-B{B}H{H}K{K}S{S}hd{hd}",
        grid=launch_grid(B, H, S, route),
        inputs=(rows("q"), keys("k"), keys("v")),
        outputs=(rows("o"),),
    )


@register("flash_attention")
def geometries():
    return [
        # the waste pipeline's stage-1 and stage-3 forwards (bf16)
        _case(1, 8, 8, 173, 64, "wgmma"), _case(1, 8, 8, 233, 64, "wgmma"),
        # qwen2.5-3b, gemma2-2b and zamba2-7b layers of chip_smoke.py (bf16)
        _case(1, 16, 2, 4096, 128, "wgmma"),
        _case(1, 8, 4, 8192, 256, "wgmma"),
        _case(1, 32, 32, 4096, 112, "wgmma"),
        # chip_smoke.py's f32 cases: waste, ragged and bidirectional
        _case(1, 8, 8, 173, 64, "simt"), _case(2, 4, 2, 37, 32, "simt"),
        _case(1, 4, 2, 300, 128, "simt"),
        # the attention tests' GQA and MQA cases, on both routes
        _case(1, 4, 2, 128, 64, "wgmma"), _case(2, 2, 1, 256, 32, "wgmma"),
        _case(1, 4, 2, 128, 64, "simt"), _case(2, 2, 1, 256, 32, "simt"),
    ]
