"""Plain-torch models of the two scan kernels' designs on the card, held to
the scans' oracles on the CPU.

The CUDA kernels cannot run here (no card, no ``nvcc``); ``chip_smoke.py``
holds them to their plain versions on the H100. What can be checked here is
the arithmetic their designs choose:

- ``ssd_scan.cu``'s tensor-core route: the P-split (16 columns of the head
  dim a block), 64-row chunks, bf16 operands where the inputs are exact in
  bf16 (C, B, x), sums of bf16 terms where an operand is made in f32 (three
  for W, two -- hi + lo -- for the state h and the decay-weighted x of the
  state update), f32 sums, exps
  in log2 units with W off the diagonal as a row factor times a column
  factor. The model is held at one zamba2-7b head (P 64, N 64) over
  S 4096 against the port's ``ssd_scan_ref`` and the JAX package's, within
  the card's scan rule (one bf16 ulp of the largest |y|); and the extra
  terms are shown to matter: the same model with single bf16 terms errs
  many times more, and a third term for W never errs more than two.
- ``ssm_scan.cu``'s reduce-scatter of y across a channel's lanes: after
  its rounds, lane l holds the whole y of step l of the group.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as ssd_ref_j
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_t
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_t

Q = 64                       # rows a chunk (kQ of ssd_scan.cu)
LOG2E = 1.4426950408889634


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _terms(x, k: int):
    """x as the kernel feeds it to the tensor cores: k bf16 terms, each
    the bf16 of what the earlier ones left."""
    out = []
    for _ in range(k):
        out.append(_bf16(x))
        x = x - out[-1]
    return out


def ssd_mma_model(x, dt, a, B, C, *, terms=(3, 2, 2)):
    """One head: x [S, P] and B, C [S, N], exact in bf16; dt [S]; a the
    head's A -> y [S, P] in f32, as the tensor-core route computes it, with
    W, h and the weighted x as ``terms`` bf16 terms (the kernel's
    kTermsW, kTermsH, kTermsX)."""
    tw, th, tx = terms
    S, P = x.shape
    N = B.shape[1]
    y = torch.empty(S, P)
    e = torch.arange(Q) // 16 * 16 + 15          # last row of each 16-tile
    t_idx = torch.arange(Q)[:, None]
    s_idx = torch.arange(Q)[None, :]
    same_tile = (t_idx // 16) == (s_idx // 16)
    for p0 in range(0, P, ssd_t.BLOCK_P):
        cols = slice(p0, p0 + ssd_t.BLOCK_P)
        h = torch.zeros(ssd_t.BLOCK_P, N)
        for t0 in range(0, S, Q):
            q = min(Q, S - t0)
            pad = lambda v: torch.cat([v, v.new_zeros((Q - q,) + v.shape[1:])])
            xs, Bs, Cs = pad(x[t0:t0 + q, cols]), pad(B[t0:t0 + q]), \
                pad(C[t0:t0 + q])
            d = pad(dt[t0:t0 + q])
            L = torch.cumsum(d * (a * LOG2E), 0)
            last = L[-1]
            cf = torch.exp2(L[e] - L) * d                  # column factors
            off = torch.exp2(L[:, None] - L[e][None, :]) * cf[None, :]
            diag = torch.exp2(L[:, None] - L[None, :]) * d[None, :]
            decay = torch.where(same_tile, diag, off)
            W = torch.where(s_idx <= t_idx, (Cs @ Bs.T) * decay, 0.0)
            yi = sum(w @ xs for w in _terms(W, tw))
            ye = sum(Cs @ hh.T for hh in _terms(h, th))
            y[t0:t0 + q, cols] = (yi + torch.exp2(L)[:, None] * ye)[:q]
            w = torch.exp2(last - L) * d
            h = torch.exp2(last) * h + sum(
                xw.T @ Bs for xw in _terms(xs * w[:, None], tx))
    return y


def _zamba2_head(head: int, S: int = 4096, seed: int = 0):
    """One zamba2-7b head (P 64, N 64) drawn as chip_smoke.py draws the
    layer: x, B, C ~ N(0, 1) rounded to bf16; dt = softplus(N(0, 1) +
    dt_bias); A = -linspace(1, 16, 112)[head]."""
    H, P, N = 112, 64, 64
    rng = np.random.default_rng(seed + head)
    bias = math.log(math.expm1(np.linspace(1e-3, 1e-1, H)[head]))
    x = _bf16(torch.from_numpy(rng.standard_normal((S, P)).astype(np.float32)))
    B = _bf16(torch.from_numpy(rng.standard_normal((S, N)).astype(np.float32)))
    C = _bf16(torch.from_numpy(rng.standard_normal((S, N)).astype(np.float32)))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal(S).astype(np.float32)) + bias)
    a = float(-np.linspace(1.0, 16.0, H, dtype=np.float32)[head])
    return x, dt, a, B, C


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 7)


@pytest.fixture(scope="module", params=[0, 111], ids=["A-1", "A-16"])
def zamba2_head(request):
    x, dt, a, B, C = _zamba2_head(request.param)
    args = (x[None, :, None], dt[None, :, None], torch.tensor([a]), B[None],
            C[None])
    ref32 = ssd_scan_ref(*args)[0, :, 0]
    bf = (args[0].bfloat16(), args[1], args[2], args[3].bfloat16(),
          args[4].bfloat16())
    ref16 = ssd_scan_ref(*bf)[0, :, 0].float()
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    ref_j = torch.from_numpy(np.asarray(
        ssd_ref_j(*map(to_j, bf)).astype(jnp.float32)))[0, :, 0]
    return (x, dt, a, B, C), ref32, ref16, ref_j


def test_ssd_mma_model_holds_the_scan_rule(zamba2_head):
    """The design's bf16 output against the port's and the JAX package's
    oracle on the same bf16 inputs: within one bf16 ulp of the largest
    |y|, chip_smoke.py's rule for the kernel."""
    inputs, _, ref16, ref_j = zamba2_head
    got = _bf16(ssd_mma_model(*inputs))
    tol = _bf16_ulp(ref16.abs().max().item())
    assert (got - ref16).abs().max().item() <= tol
    assert (got - ref_j).abs().max().item() <= tol


def test_ssd_mma_model_needs_the_lo_halves(zamba2_head):
    """In f32, before the output's rounding: W, h and the weighted x as
    sums of terms err far less than as single bf16 halves, so the f32
    check tells the two apart; hi + lo everywhere lies between."""
    inputs, ref32, _, _ = zamba2_head
    top = ref32.abs().max().item()
    err = lambda terms: (ssd_mma_model(*inputs, terms=terms)
                         - ref32).abs().max().item() / top
    design, hilo, single = err((3, 2, 2)), err((2, 2, 2)), err((1, 1, 1))
    assert design < 1e-4 and single > 100 * design
    assert design <= hilo < single / 100


def test_ssd_mma_model_matches_the_recurrence_at_small_shapes():
    """Ragged S, several chunks and P-slices: the model is the recurrence
    within 1e-4 of the largest |y| (f32, hi + lo)."""
    rng = np.random.default_rng(5)
    S, P, N = 150, 32, 64
    x = _bf16(torch.from_numpy(rng.standard_normal((S, P)).astype(np.float32)))
    B = _bf16(torch.from_numpy(rng.standard_normal((S, N)).astype(np.float32)))
    C = _bf16(torch.from_numpy(rng.standard_normal((S, N)).astype(np.float32)))
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, S).astype(np.float32))
    ref = ssd_scan_ref(x[None, :, None], dt[None, :, None],
                       torch.tensor([-2.0]), B[None], C[None])[0, :, 0]
    got = ssd_mma_model(x, dt, -2.0, B, C)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def _reduce_scatter(part):
    """ssm_scan.cu's rounds over a channel's lanes: part[l][j] is lane l's
    partial sum for step j of a group of LANES steps."""
    lanes = len(part)
    part = [list(p) for p in part]
    rnd = 1
    while rnd < lanes:
        w = lanes // (2 * rnd)
        new = [p[:] for p in part]
        for l in range(lanes):
            upper = bool(l & w)
            for i in range(w):
                send = part[l ^ w][i + w] if not (l ^ w) & w else \
                    part[l ^ w][i]
                keep = part[l][i + w] if upper else part[l][i]
                new[l][i] = keep + send
        part = new
        rnd *= 2
    return [p[0] for p in part]


def test_ssm_reduce_scatter_leaves_step_l_on_lane_l():
    lanes = ssm_t.LANES
    rng = np.random.default_rng(lanes)
    part = rng.standard_normal((lanes, lanes))
    got = _reduce_scatter(part.tolist())
    np.testing.assert_allclose(got, part.sum(0), rtol=1e-12, atol=1e-12)
    assert 16 % lanes == 0 and ssm_t.THREADS % lanes == 0
