"""Plain PyTorch versions of the SSD kernel.

``ssd_scan_ref`` is the exact sequential recurrence, one step a time: the
oracle the CUDA kernel is held to, and the path ``backend="ref"`` takes.
``ssd_chunked_ref`` is the same function in the chunked block form (the
reference's ``models/ssm.py::_ssd_chunked``): the path CPU tensors take in
``models/ssm.py``, and the function whose vjp the kernel route's backward
recomputes (``ops.py``), since stepping through S is far too slow to
differentiate at a model's length.

B and C are [B,S,N], one state group for every head, or [B,S,G,N], G
groups of the heads in order (Mamba-2's ngroups): head h reads group
``h // (H // G)``."""

from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, A, B, C):
    """x: [B,S,H,P]; dt: [B,S,H]; A: [H]; B, C: [B,S,N] or [B,S,G,N] ->
    [B,S,H,P] in x's dtype.

    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t · h_t``, with
    the state ``h [B,H,P,N]`` in f32 from 0."""
    if B.dim() == 4:
        return _by_group(ssd_scan_ref, x, dt, A, B, C)
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


def _by_group(fn, x, dt, A, B, C, *args):
    """``fn`` on each state group's heads with its B and C [B,S,N], the
    heads' outputs side by side: B, C [B,S,G,N], head h in group
    ``h // (H // G)``."""
    k = x.shape[2] // B.shape[2]
    heads = [slice(g * k, (g + 1) * k) for g in range(B.shape[2])]
    return torch.cat([fn(x[:, :, h], dt[:, :, h], A[h], B[:, :, g],
                         C[:, :, g], *args) for g, h in enumerate(heads)],
                     dim=2)


def ssd_chunked_ref(xh, dt, A, B, C, chunk: int):
    """SSD scan in chunks of ``chunk`` steps. xh: [B,S,H,P]; dt: [B,S,H];
    A: [H] (negative); B, C: [B,S,N] (one state group) or [B,S,G,N] -> y
    [B,S,H,P] in xh's dtype. S must be a multiple of ``chunk``. The
    reference's ``_ssd_chunked``, with the decay's exponent masked before
    its exp so that the gradient stays finite where the masked exponent
    overflows."""
    Bsz, S, H, P = xh.shape
    if S % chunk:
        raise ValueError(f"sequence of {S} is not a multiple of the SSM "
                         f"chunk {chunk} (pad upstream)")
    if B.dim() == 4:
        return _by_group(ssd_chunked_ref, xh, dt, A, B, C, chunk)
    nchunks = S // chunk
    l = (dt * A[None, None]).float().reshape(Bsz, nchunks, chunk, H)
    Lcum = torch.cumsum(l, dim=2)                             # [B,nc,C,H]
    xc_all = xh.float().reshape(Bsz, nchunks, chunk, H, P)
    dt_c = dt.float().reshape(Bsz, nchunks, chunk, H)
    B_c = B.float().reshape(Bsz, nchunks, chunk, -1)
    C_c = C.float().reshape(Bsz, nchunks, chunk, -1)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    h = torch.zeros((Bsz, H, P, B.shape[-1]), dtype=torch.float32,
                    device=xh.device)
    ys = []
    for c in range(nchunks):
        Lc, xc, dtc = Lcum[:, c], xc_all[:, c], dt_c[:, c]
        Bc, Cc = B_c[:, c], C_c[:, c]
        # intra-chunk: masked decay matrix M[t,s] = exp(L_t - L_s), s <= t.
        # The exponent is masked before the exp: above the diagonal
        # L_t - L_s > 0 can overflow to inf, and the vjp of where(mask,
        # inf, 0) is inf * 0 = NaN (the reference masks after the exp, and
        # its gradient is NaN at zamba2's scale). The forward is the same.
        diff = Lc[:, :, None, :] - Lc[:, None, :, :]          # [B,t,s,H]
        M = torch.exp(torch.where(tri[None, :, :, None], diff, -torch.inf))
        G = torch.einsum("btn,bsn->bts", Cc, Bc)
        W = G[:, :, :, None] * M * dtc[:, None, :, :]         # [B,t,s,H]
        y_intra = torch.einsum("btsh,bshp->bthp", W, xc)
        # inter-chunk: contribution of the carried state
        y_inter = (torch.einsum("btn,bhpn->bthp", Cc, h)
                   * torch.exp(Lc)[..., None])
        # new carry
        decay_to_end = torch.exp(Lc[:, -1:, :] - Lc)          # [B,s,H]
        S_c = torch.einsum("bsh,bsn,bshp->bhpn", decay_to_end * dtc, Bc, xc)
        h = torch.exp(Lc[:, -1])[:, :, None, None] * h + S_c
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y.to(xh.dtype)
