"""Plain PyTorch version of the SSD kernel: the exact sequential
recurrence, one step a time. The oracle the CUDA kernel is held to, and
the path ``backend="ref"`` and CPU tensors take."""

from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, A, B, C):
    """x: [B,S,H,P]; dt: [B,S,H]; A: [H]; B, C: [B,S,N] -> [B,S,H,P] in
    x's dtype.

    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t · h_t``, with
    the state ``h [B,H,P,N]`` in f32 from 0."""
    out_dtype = x.dtype
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    Bsz, S, H, P = x.shape
    h = torch.zeros((Bsz, H, P, B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    y = torch.empty_like(x)
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None, :])                      # [B,H]
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
        h = a[:, :, None, None] * h + upd
        y[:, t] = torch.einsum("bhpn,bn->bhp", h, C[:, t])
    return y.to(out_dtype)
