"""Plain PyTorch version of the flash-attention kernel: the oracle the CUDA
kernel is held to, and the path CPU tensors take."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                  q_offset=0, scale=None):
    """q: [B,H,Sq,hd]; k, v: [B,K,Sk,hd] (K divides H) -> [B,H,Sq,hd].

    Materialises the full score matrix in f32; the output is in q's dtype.
    Query row i stands at position ``q_offset + i``, key row j at j.
    ``window`` > 0 keeps keys with ``q_pos - k_pos < window``; ``softcap``
    > 0 applies ``tanh(s / softcap) * softcap`` after the scale
    (``scale``, ``hd**-0.5`` where None)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * (hd ** -0.5 if scale is None else scale)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(q_offset, q_offset + Sq, dtype=torch.int32,
                      device=q.device)[:, None]
    kp = torch.arange(Sk, dtype=torch.int32, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
