"""Plain PyTorch version of the selective-scan kernel: the exact sequential
recurrence, one step a time. The oracle the CUDA kernel is held to, and
the path ``backend="ref"`` and CPU tensors take."""

from __future__ import annotations

import torch


def ssm_scan_ref(u, dt, A, B, C):
    """u, dt: [B,S,di]; A: [di,N]; B, C: [B,S,N] -> y [B,S,di] in u's dtype.

    ``h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t``, ``y_t = C_t · h_t``,
    in f32 from ``h_0 = 0``."""
    out_dtype = u.dtype
    u, dt, B, C, A = (t.float() for t in (u, dt, B, C, A))
    h = torch.zeros((u.shape[0], u.shape[2], A.shape[-1]),
                    dtype=torch.float32, device=u.device)
    y = torch.empty_like(u)
    for t in range(u.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A[None])              # [B,di,N]
        b = (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        h = a * h + b
        y[:, t] = torch.einsum("bdn,bn->bd", h, C[:, t])
    return y.to(out_dtype)
