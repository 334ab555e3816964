"""Launch geometry of the flash-attention kernels (``csrc/``), for
``analysis/launch_check.py``.

One block per (BLOCK_Q[route] query rows, head, batch row): grid
``launch_grid(B, H, Sq, route)`` in CUDA's (x, y, z) order, 128 rows a
block on the bf16 route (``flash_attention_wgmma.cu``), 64 on the f32 one
(``flash_attention.cu``). A block reads its rows of q [B,H,Sq,hd] and
every key and value row [B,K,Sk,hd] of its kv head (the causal and window
masks, at the rows' positions ``q_offset + i``, skip tiles inside the
block's loop, not across blocks), and writes its rows of o. The ragged
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


def _case(B, H, K, Sq, hd, route, Sk=None, q_offset=0):
    """The launch over q [B,H,Sq,hd] whose rows stand at ``q_offset`` ..
    ``q_offset + Sq - 1``, against k and v [B,K,Sk,hd] (Sk = Sq by
    default)."""
    Sk = Sq if Sk is None else Sk
    if q_offset < 0 or q_offset + Sq > Sk:
        raise ValueError(f"query rows {q_offset} + {Sq} past {Sk} keys")
    G = H // K
    rows = lambda name: BlockDecl(
        name, (B, H, Sq, hd), (1, 1, BLOCK_Q[route], hd),
        lambda i, h, b: (b, h, i, 0), masked_dims=frozenset({2}))
    keys = lambda name: BlockDecl(
        name, (B, K, Sk, hd), (1, 1, Sk, hd),
        lambda i, h, b: (b, h // G, 0, 0))
    seq = f"S{Sq}" if (Sk, q_offset) == (Sq, 0) else \
        f"Sq{Sq}Sk{Sk}off{q_offset}"
    return KernelGeometry(
        kernel="flash_attention", module=_MODULE,
        case=f"{route}-B{B}H{H}K{K}{seq}hd{hd}",
        grid=launch_grid(B, H, Sq, route),
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
        # zamba2-7b-instruct's hd 224 at the prefill cell's longest step,
        # and a ragged f32 case of it
        _case(4, 32, 32, 4096, 224, "wgmma"),
        _case(2, 4, 2, 77, 224, "simt"),
        # chip_smoke.py's f32 cases: waste, ragged and bidirectional
        _case(1, 8, 8, 173, 64, "simt"), _case(2, 4, 2, 37, 32, "simt"),
        _case(1, 4, 2, 300, 128, "simt"),
        # the attention tests' GQA and MQA cases, on both routes
        _case(1, 4, 2, 128, 64, "wgmma"), _case(2, 2, 1, 256, 32, "wgmma"),
        _case(1, 4, 2, 128, 64, "simt"), _case(2, 2, 1, 256, 32, "simt"),
        # the last rank's share of a q sequence-sharded over model on
        # 16 x 16 (gemma2-2b and llava-next-34b, TRAIN_4K and PREFILL_32K)
        _case(16, 8, 4, 256, 256, "wgmma", 4096, 3840),
        _case(2, 8, 4, 2048, 256, "wgmma", 32768, 30720),
        _case(16, 56, 8, 256, 128, "wgmma", 4096, 3840),
        _case(2, 56, 8, 2048, 128, "wgmma", 32768, 30720),
        # a ragged f32 share off the block
        _case(2, 4, 2, 37, 32, "simt", 100, 50),
    ]
