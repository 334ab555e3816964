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


def decode_partials_ref(q, k_cache, v_cache, pos, *, softcap=0.0,
                        window=0):
    """Plain version of ``flash_decode_partials`` with the whole cache as
    one chunk: (m, l) [B,K,1,G,2] and acc [B,K,1,G,hd], f32, over the keys
    ``decode_attention_ref`` sees (any int32 ``pos``): m the largest
    visible score (NEG_INF if none), l the sum of exp(s - m) over the
    visible keys, acc that of exp(s - m) v."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(B, K, H // K, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * hd ** -0.5
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    idx = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    p = pos.to(torch.int32)[:, None]
    ok = idx <= p
    if window > 0:
        ok &= (p - idx) < window
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(ok, torch.exp(s - m), 0.0)
    acc = torch.einsum("bkgs,bskd->bkgd", e, v_cache.float())
    ml = torch.stack([m[..., 0], e.sum(dim=-1)], dim=-1)
    return ml[:, :, None], acc[:, :, None]


def decode_combine_ref(part_ml, part_acc, dtype):
    """Plain version of ``flash_decode_combine``: the partials [B,K,n,G,2]
    and [B,K,n,G,hd] merged, each weighed by exp(m - max m) (an empty one,
    l = 0, by 0), divided by max(l, 1e-30) -> [B,K*G,hd] in ``dtype``."""
    B, K, n, G, hd = part_acc.shape
    m, l = part_ml[..., 0], part_ml[..., 1]
    w = torch.where(l > 0, torch.exp(m - m.amax(dim=2, keepdim=True)), 0.0)
    acc = (w[..., None] * part_acc).sum(dim=2)
    tot = (w * l).sum(dim=2)
    return (acc / tot.clamp_min(1e-30)[..., None]).reshape(
        B, K * G, hd).to(dtype)
