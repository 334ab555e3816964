"""Launch geometry of the decode-attention kernels (``csrc/flash_decode.cu``),
for ``analysis/launch_check.py``. A call is two launches.

The split pass: one block per (chunk, 4 adjacent kv heads, batch row), a
warp a kv head, grid ``launch_grid(B, K, S)[0]`` = (n_split, ceil(K / 4),
B) in (x, y, z) order. A block reads the query heads of its kv heads, its
chunk of ``chunk_size(B, K, S)`` rows of both caches ([B,S,K,hd]; the last
chunk and the last group of heads ragged, masked in the kernel) and its
row's pos, and writes its heads' partials: (m, l) [B,K,n_split,G,2] and
acc [B,K,n_split,G,hd], in f32.

The combine pass: one block per (kv head, batch row), grid
``launch_grid(B, K, S)[1]`` = (K, B). A block reads every partial of its
(b, kv head) and writes its G output heads.
"""

from __future__ import annotations

from repro_torch.analysis.launch_check import (
    BlockDecl, KernelGeometry, register,
)
from repro_torch.kernels.flash_decode.flash_decode import (
    _WARPS, chunk_size, launch_grid,
)

_MODULE = "repro_torch.kernels.flash_decode.flash_decode"


def _cases(B, H, K, S, hd):
    G = H // K
    split_grid, combine_grid = launch_grid(B, K, S)
    n, chunk, w = split_grid[0], chunk_size(B, K, S), _WARPS
    ragged = frozenset({1}) if K % w else frozenset()
    split_at = lambda s, y, b: (b, y, s, 0, 0)
    combine_at = lambda kh, b: (b, kh, 0, 0, 0)
    return [
        KernelGeometry(
            kernel="flash_decode", module=_MODULE,
            case=f"split-B{B}H{H}K{K}S{S}hd{hd}", grid=split_grid,
            inputs=(
                BlockDecl("q", (B, H, hd), (1, w * G, hd),
                          lambda s, y, b: (b, y, 0), masked_dims=ragged),
                *(BlockDecl(name, (B, S, K, hd), (1, chunk, w, hd),
                            lambda s, y, b: (b, s, y, 0),
                            masked_dims=frozenset({1, 2}))
                  for name in ("k_cache", "v_cache")),
                BlockDecl("pos", (B,), (1,), lambda s, y, b: (b,))),
            outputs=(
                BlockDecl("part_ml", (B, K, n, G, 2), (1, w, 1, G, 2),
                          split_at, masked_dims=ragged),
                BlockDecl("part_acc", (B, K, n, G, hd), (1, w, 1, G, hd),
                          split_at, masked_dims=ragged))),
        KernelGeometry(
            kernel="flash_decode", module=_MODULE,
            case=f"combine-B{B}H{H}K{K}S{S}hd{hd}", grid=combine_grid,
            inputs=(
                BlockDecl("part_ml", (B, K, n, G, 2), (1, 1, n, G, 2),
                          combine_at),
                BlockDecl("part_acc", (B, K, n, G, hd), (1, 1, n, G, hd),
                          combine_at)),
            outputs=(BlockDecl("o", (B, H, hd), (1, G, hd),
                               lambda kh, b: (b, kh, 0)),)),
    ]


@register("flash_decode")
def geometries():
    return [g for case in (
        # zamba2-7b's decode step; chip_smoke.py's GQA cases
        (4, 32, 32, 32768, 112), (3, 8, 2, 1000, 64), (2, 16, 2, 4097, 128),
        # the decode tests' GQA and MQA cases
        (2, 8, 2, 256, 64), (3, 2, 1, 128, 32),
    ) for g in _cases(*case)]
