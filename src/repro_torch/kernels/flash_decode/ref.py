"""Plain PyTorch version of the flash-decode kernel: the oracle the CUDA
kernel is held to, and the path ``backend="ref"`` and CPU tensors take.

The caches are in the decode state's layout ``[B,S,K,hd]``; the JAX
package's kernel and oracle take them as ``[B,K,S,hd]``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, pos, *, softcap=0.0,
                         window=0):
    """q: [B,H,hd]; k_cache, v_cache: [B,S,K,hd] (K divides H); pos: [B]
    int32, the index of the newest key -> [B,H,hd] in q's dtype.

    Attends to keys ``j <= pos[b]``, and ``pos[b] - j < window`` when
    ``window`` > 0; ``softcap`` > 0 applies ``tanh(s / softcap) * softcap``
    after the ``hd**-0.5`` scale. Scores and softmax in f32."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(B, K, H // K, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    s = s * hd ** -0.5
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    idx = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    p = pos.to(torch.int32)[:, None]
    ok = idx <= p
    if window > 0:
        ok &= (p - idx) < window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)
