"""State-space sequence layers in PyTorch: the port of
``repro/models/ssm.py``, Mamba-1 (selective scan) and Mamba-2 (SSD).

Shapes and parameter layouts are the JAX package's, so weights carry
across unchanged; ``D``, ``dt_bias``, ``A_log`` and ``D_head`` are f32 in a
model of any dtype, as there.

The full-sequence forward of a CUDA tensor goes through the hand-written
scan kernels (``kernels/ssm_scan/ops.py::ssm_scan_op`` and
``kernels/ssd_scan/ops.py::ssd_scan_op``), with the casts the JAX package
applies before its TPU kernels: Mamba-1 passes dt, B and C in the
activation dtype (in bf16, dt is rounded to bf16), Mamba-2 passes B and C
in the activation dtype and keeps dt in f32. A CPU tensor takes the
chunked forms ``_selective_scan_chunked`` and ``_ssd_chunked`` (which
``kernels/ssd_scan/ref.py`` holds as ``ssd_chunked_ref``, since the
kernel's backward recomputes it), as the JAX package does off the TPU.
Both routes differentiate. Either way the sequence must be a multiple of
``SSMDims.chunk``, as the JAX package's chunked forms assert.

Single-token decode is the exact recurrence (O(1) state per token).

``SSMDims.ngroups`` > 0 selects the published Mamba-2 mixer (Zamba2-7B,
transformers' ``Zamba2MambaMixer``) in place of the JAX package's:
``in_proj`` gives z, the conv's input [x, B, C] and dt at once; the conv
(with its bias) covers x, B and C; B and C come in ``ngroups`` state
groups, head h reading group ``h // (H / ngroups)``; the gated RMS norm
is taken over each group's channels of ``y * silu(z)``. Its decode is not
written.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import spmd
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref as _ssd_chunked
from repro_torch.kernels.ssm_scan.ops import ssm_scan_op
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models.layers import act_fn, normal_init, rms_norm


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int
    d_conv: int = 4
    expand: int = 2
    version: int = 1          # 1 = mamba1, 2 = mamba2 (SSD)
    head_dim: int = 64        # mamba2 P
    chunk: int = 256
    ngroups: int = 0          # mamba2: 0 the JAX package's mixer, else the
    #                           published one with B, C in this many groups
    norm_eps: float = 1e-6    # the published mixer's gated norm

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _inverse_softplus_linspace(n: int, device):
    """``log(exp(linspace(1e-3, 1e-1, n)) - 1)`` in f32: the dt biases."""
    x = torch.linspace(1e-3, 1e-1, n, dtype=torch.float32, device=device)
    return torch.log(torch.exp(x) - 1.0)


def init_ssm(gen, dims: SSMDims, dtype=torch.bfloat16, device=None) -> dict:
    """One block's parameters, drawn from ``gen``: the projections in
    ``dtype``, ``D``, ``dt_bias``, ``A_log`` and ``D_head`` in f32."""
    di, N = dims.d_inner, dims.d_state

    def draw(shape, scale):
        return normal_init(gen, shape, scale, dtype, device)

    f32 = dict(dtype=torch.float32, device=device)
    if dims.ngroups:
        # the published mixer: in_proj gives [z, x B C, dt]
        H, conv = dims.n_heads, di + 2 * dims.ngroups * N
        return {
            "in_proj": draw((dims.d_model, di + conv + H),
                            dims.d_model ** -0.5),
            "conv_w": draw((dims.d_conv, conv), dims.d_conv ** -0.5),
            "conv_b": torch.zeros((conv,), dtype=dtype, device=device),
            "out_proj": draw((di, dims.d_model), di ** -0.5),
            "dt_bias": _inverse_softplus_linspace(H, device),
            "A_log": torch.log(torch.arange(1, H + 1, **f32)),
            "D_head": torch.ones((H,), **f32),
            "norm_scale": torch.zeros((di,), dtype=dtype, device=device),
        }
    p = {
        "in_proj": draw((dims.d_model, 2 * di), dims.d_model ** -0.5),
        "conv_w": draw((dims.d_conv, di), 0.2),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": draw((di, dims.d_model), di ** -0.5),
        "D": torch.ones((di,), **f32),
    }
    if dims.version == 1:
        p.update(
            x_dbc=draw((di, dims.dt_rank + 2 * N), di ** -0.5),
            dt_proj=draw((dims.dt_rank, di), dims.dt_rank ** -0.5),
            dt_bias=_inverse_softplus_linspace(di, device),
            A_log=torch.log(torch.arange(1, N + 1, **f32)).expand(di, N)
            .contiguous(),
        )
    else:
        H = dims.n_heads
        p.update(
            x_bcdt=draw((di, 2 * N + H), di ** -0.5),
            dt_bias=_inverse_softplus_linspace(H, device),
            A_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
            D_head=torch.ones((H,), **f32),
            norm_scale=torch.zeros((di,), dtype=dtype, device=device),
        )
    return p


def softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, b):
    """Depthwise causal conv as a sum of K shifted products. x: [B,S,C];
    w: [K,C]. DTensors go through ``spmd.scan``: a channel's conv over
    the whole sequence is local to its shard."""
    if spmd.is_dtensor(x):
        return spmd.scan(_causal_conv, x, w, b, maps=({2: 1}, {2: 0}),
                         channel=2)
    K, S = w.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i: i + S, :] * w[i] for i in range(K))
    return out + b


def _check_chunked(S: int, chunk: int) -> None:
    if S % chunk:
        raise ValueError(f"sequence of {S} is not a multiple of the SSM "
                         f"chunk {chunk} (pad upstream)")


# ---------------------------------------------------------------------------
# Mamba-1: chunked selective scan
# ---------------------------------------------------------------------------

def _selective_scan_chunked(u, dt, A, B, C, chunk: int):
    """u: [B,S,di]; dt: [B,S,di]; A: [di,N]; B, C: [B,S,N] -> y [B,S,di]
    in u's dtype.

    The JAX package carries the state ``h [B,di,N]`` (f32) across chunks
    and runs an associative scan inside each; here the plain version of the
    scan kernel runs the recurrence step by step throughout, the same
    function summed in another order. A ``meta`` tensor (the dry run's
    trace, ``launch/dryrun.py``) takes ``_selective_scan_blocked``, the
    reference's form, whose ops and shapes it counts: the step oracle
    would trace a run of ops a token, 32 x 32768 of them at
    ``PREFILL_32K``."""
    _check_chunked(u.shape[1], chunk)
    if u.is_meta:
        return _selective_scan_blocked(u, dt, A, B, C, chunk)
    return ssm_scan_ref(u, dt, A, B, C)


def _selective_scan_blocked(u, dt, A, B, C, chunk: int):
    """The reference's chunked selective scan, op for op at its shapes:
    the decay ``a`` and input ``b`` [B,S,di,N] in f32, an inclusive scan
    of (a, b) pairs within each chunk (log2(chunk) doubling steps, each
    combining ``(a_l, b_l), (a_r, b_r) -> (a_l a_r, b_r + a_r b_l)``), the
    carried state ``h [B,di,N]`` applied to the chunk, and the
    ``bcdn,bcn->bcd`` product with C. The same function as
    ``ssm_scan_ref``."""
    Bsz, S, di = u.shape
    N = A.shape[-1]
    nchunks = S // chunk
    a = torch.exp(dt[..., None].float() * A[None, None])      # [B,S,di,N]
    b = (dt * u)[..., None].float() * B[:, :, None, :]
    a = a.reshape(Bsz, nchunks, chunk, di, N)
    b = b.reshape(Bsz, nchunks, chunk, di, N)
    Cc = C.float().reshape(Bsz, nchunks, chunk, N)
    h = torch.zeros((Bsz, di, N), dtype=torch.float32, device=u.device)
    ys = []
    for c in range(nchunks):
        acc_a, acc_b = a[:, c], b[:, c]                       # [B,chunk,di,N]
        k = 1
        while k < chunk:
            acc_b = torch.cat([acc_b[:, :k], acc_b[:, k:]
                               + acc_a[:, k:] * acc_b[:, :-k]], dim=1)
            acc_a = torch.cat([acc_a[:, :k],
                               acc_a[:, k:] * acc_a[:, :-k]], dim=1)
            k *= 2
        h_t = acc_a * h[:, None] + acc_b
        ys.append(_ChunkReadout.apply(h_t, Cc[:, c]))
        h = h_t[:, -1]
    return torch.stack(ys, dim=1).reshape(Bsz, S, di).to(u.dtype)


class _ChunkReadout(torch.autograd.Function):
    """``einsum("bcdn,bcn->bcd", h, C)``, the read-out of a chunk's
    states, with the vjp of the reference's compiled program: the
    cotangent of ``h`` a broadcast product (it has no contraction, and XLA
    computes it without a dot), that of ``C`` a product over d. Autograd
    of the einsum would run both as matmuls."""

    @staticmethod
    def forward(ctx, h, C):
        ctx.save_for_backward(h, C)
        return torch.einsum("bcdn,bcn->bcd", h, C)

    @staticmethod
    def backward(ctx, g):
        h, C = ctx.saved_tensors
        dh = g[..., None] * C[:, :, None, :] if ctx.needs_input_grad[0] \
            else None
        dC = torch.einsum("bcd,bcdn->bcn", g, h) \
            if ctx.needs_input_grad[1] else None
        return dh, dC


def _dt_softplus(dt_raw, dt_bias):
    return softplus(dt_raw.float() + dt_bias)


def mamba1_forward(p, x, dims: SSMDims, backend: str = "auto"):
    """Full-sequence Mamba-1 block. x: [B,S,D] -> [B,S,D]. ``backend`` is
    passed to ``ssm_scan_op`` for CUDA tensors."""
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = spmd.halves(xz)
    xin = act_fn("silu")(_causal_conv(xin, p["conv_w"], p["conv_b"]))
    # the product over a sharded d_inner is partial: reduce it once here
    dbc = spmd.settle(torch.einsum("bsd,de->bse", xin, p["x_dbc"]))
    dt_r, Bm, Cm = torch.split(
        dbc, [dims.dt_rank, dims.d_state, dims.d_state], dim=-1)
    dt = _dt_softplus(torch.einsum("bsr,rd->bsd", dt_r, p["dt_proj"]),
                      p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if xin.is_cuda:
        _check_chunked(xin.shape[1], dims.chunk)
        y = ssm_scan_op(
            xin.contiguous(), dt.to(xin.dtype), A,
            Bm.to(xin.dtype).contiguous(), Cm.to(xin.dtype).contiguous(),
            backend=backend,
        )
    elif spmd.is_dtensor(xin):
        # local_map, as the kernel's route: a channel's scan is local
        y = spmd.scan(
            lambda u, d, a, b, c: _selective_scan_chunked(u, d, a, b, c,
                                                          dims.chunk),
            xin, dt, A, Bm.float(), Cm.float(),
            maps=({0: 0, 2: 2}, {2: 0}, {0: 0}, {0: 0}), channel=2)
    else:
        y = _selective_scan_chunked(xin, dt, A, Bm.float(), Cm.float(),
                                    dims.chunk)
    y = y + xin * p["D"].to(x.dtype)
    y = y * act_fn("silu")(z)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"])


def _conv_step(p, conv_buf, xin):
    """The causal conv at the newest token: (silu(conv) [B,di], the new
    buffer of the last d_conv - 1 inputs)."""
    window = torch.cat([conv_buf, xin], dim=1)               # [B,d_conv,di]
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    return act_fn("silu")(conv), window[:, 1:]


def mamba1_decode(p, x, dims: SSMDims, h, conv_buf):
    """One-token recurrence. x: [B,1,D]; h: [B,di,N] f32; conv_buf:
    [B,d_conv-1,di] (the trailing inputs). Returns (out [B,1,D], h,
    conv_buf)."""
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = spmd.halves(xz)                              # [B,1,di]
    xc, conv_buf = _conv_step(p, conv_buf, xin)
    xc = xc[:, None, :]
    dbc = spmd.settle(torch.einsum("bsd,de->bse", xc, p["x_dbc"]))
    dt_r, Bm, Cm = torch.split(
        dbc, [dims.dt_rank, dims.d_state, dims.d_state], dim=-1)
    dt = _dt_softplus(torch.einsum("bsr,rd->bsd", dt_r, p["dt_proj"]),
                      p["dt_bias"])[:, 0]                     # [B,di]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A[None])                    # [B,di,N]
    b = (dt * xc[:, 0])[..., None] * Bm[:, 0, None, :].float()
    h = a * h + b
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())
    y = y.to(x.dtype) + xc[:, 0] * p["D"].to(x.dtype)
    y = y * act_fn("silu")(z[:, 0])
    out = torch.einsum("be,ed->bd", y, p["out_proj"])[:, None, :]
    return out, h, conv_buf


# ---------------------------------------------------------------------------
# Mamba-2: SSD (chunked block decomposition)
# ---------------------------------------------------------------------------

def gated_rms_norm(y, z, scale, groups: int, eps: float):
    """``y * silu(z)`` RMS-normed over each of ``groups`` equal groups of
    its last dim, in f32, times ``1 + scale``; in y's dtype."""
    h = y.float() * torch.nn.functional.silu(z.float())
    h = h.unflatten(-1, (groups, -1))
    h = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + eps)
    return (h.flatten(-2) * (1.0 + scale.float())).to(y.dtype)


def _mamba2_grouped_forward(p, x, dims: SSMDims, backend: str):
    """The published Mamba-2 mixer (``dims.ngroups`` state groups)."""
    B_, S, _ = x.shape
    H, P, N, G = dims.n_heads, dims.head_dim, dims.d_state, dims.ngroups
    di = dims.d_inner
    proj = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xbc, dt_h = torch.split(proj, [di, di + 2 * G * N, H], dim=-1)
    xbc = act_fn("silu")(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xin, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = _dt_softplus(dt_h, p["dt_bias"])                     # [B,S,H]
    A = -torch.exp(p["A_log"])                                # [H]
    xh = xin.reshape(B_, S, H, P)
    Bg, Cg = Bm.reshape(B_, S, G, N), Cm.reshape(B_, S, G, N)
    if xh.is_cuda:
        _check_chunked(S, dims.chunk)
        y = ssd_scan_op(xh.contiguous(), dt.contiguous(), A,
                        Bg.contiguous(), Cg.contiguous(), backend=backend,
                        chunk=dims.chunk)
    else:
        y = _ssd_chunked(xh, dt, A, Bg, Cg, dims.chunk)
    y = y + xh * p["D_head"][None, None, :, None].to(x.dtype)
    y = gated_rms_norm(y.reshape(B_, S, di), z, p["norm_scale"], G,
                       dims.norm_eps)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"])


def mamba2_forward(p, x, dims: SSMDims, backend: str = "auto"):
    """Full-sequence Mamba-2 block. x: [B,S,D] -> [B,S,D]. ``backend`` is
    passed to ``ssd_scan_op`` for CUDA tensors."""
    if dims.ngroups:
        return _mamba2_grouped_forward(p, x, dims, backend)
    B_, S, _ = x.shape
    H, P, N = dims.n_heads, dims.head_dim, dims.d_state
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = spmd.halves(xz)
    xin = act_fn("silu")(_causal_conv(xin, p["conv_w"], p["conv_b"]))
    # the product over a sharded d_inner is partial: reduce it once here
    bcdt = spmd.settle(torch.einsum("bsd,de->bse", xin, p["x_bcdt"]))
    Bm, Cm, dt_h = torch.split(bcdt, [N, N, H], dim=-1)
    dt = _dt_softplus(dt_h, p["dt_bias"])                     # [B,S,H]
    A = -torch.exp(p["A_log"])                                # [H]
    xh = xin.reshape(B_, S, H, P)
    if xh.is_cuda:
        _check_chunked(S, dims.chunk)
        y = ssd_scan_op(
            xh.contiguous(), dt.contiguous(), A,
            Bm.to(xh.dtype).contiguous(), Cm.to(xh.dtype).contiguous(),
            backend=backend, chunk=dims.chunk,
        )
    elif spmd.is_dtensor(xh):
        # local_map, as the kernel's route: a head's scan is local
        y = spmd.scan(
            lambda x_, d, a, b, c: _ssd_chunked(x_, d, a, b, c, dims.chunk),
            xh, dt, A, Bm, Cm,
            maps=({0: 0, 2: 2}, {2: 0}, {0: 0}, {0: 0}), channel=2)
    else:
        y = _ssd_chunked(xh, dt, A, Bm, Cm, dims.chunk)
    y = y + xh * p["D_head"][None, None, :, None].to(x.dtype)
    y = y.reshape(B_, S, H * P)
    y = y * act_fn("silu")(z)
    y = rms_norm(y, p["norm_scale"])
    return torch.einsum("bse,ed->bsd", y, p["out_proj"])


def mamba2_decode(p, x, dims: SSMDims, h, conv_buf):
    """One-token SSD recurrence. x: [B,1,D]; h: [B,H,P,N] f32; conv_buf:
    [B,d_conv-1,di]. Returns (out [B,1,D], h, conv_buf)."""
    if dims.ngroups:
        raise NotImplementedError("decode of the grouped Mamba-2 mixer")
    B_ = x.shape[0]
    H, P, N = dims.n_heads, dims.head_dim, dims.d_state
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = spmd.halves(xz)
    xc, conv_buf = _conv_step(p, conv_buf, xin)               # [B,di]
    bcdt = spmd.settle(torch.einsum("bd,de->be", xc, p["x_bcdt"]))
    Bm, Cm, dt_h = torch.split(bcdt, [N, N, H], dim=-1)
    dt = _dt_softplus(dt_h, p["dt_bias"])                     # [B,H]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None])                               # [B,H]
    xh = xc.reshape(B_, H, P)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), xh.float())
    h = a[:, :, None, None] * h + upd
    y = torch.einsum("bhpn,bn->bhp", h, Cm.float()).to(x.dtype)
    y = y + xh * p["D_head"][None, :, None].to(x.dtype)
    y = y.reshape(B_, H * P) * act_fn("silu")(z[:, 0])
    y = rms_norm(y, p["norm_scale"])
    out = torch.einsum("be,ed->bd", y, p["out_proj"])[:, None, :]
    return out, h, conv_buf
