"""Plain PyTorch version of the flash-attention kernel: the oracle the CUDA
kernel is held to, and the path CPU tensors take."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: [B,H,S,hd]; k, v: [B,K,S,hd] (K divides H) -> [B,H,S,hd].

    Materialises the full score matrix in f32; the output is in q's dtype.
    ``window`` > 0 keeps keys with ``q_pos - k_pos < window``; ``softcap``
    > 0 applies ``tanh(s / softcap) * softcap`` after the ``hd**-0.5``
    scale."""
    B, H, S, hd = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * hd ** -0.5
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
