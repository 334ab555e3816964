"""Plain float32 reference of a dense pre-norm decoder with grouped-query
attention: Qwen2 (hf:Qwen/Qwen2.5-3B, ``modeling_qwen2.py``), read from
the configuration's own keys. Plain ``torch`` operations on whatever
device the weights are on, with TF32 off; it imports nothing of the
program.

A layer: ``x += o(attn(rope(q(n1(x))), rope(k(n1(x))), v(n1(x))))``,
then ``x += down(silu(gate(n2(x))) * up(n2(x)))``, where ``n`` is the RMS
norm ``x / sqrt(mean(x^2) + eps) * w``, q, k and v carry a bias, rope
rotates the two halves of each head (``rotate_half``) by ``pos *
theta^(-2i/hd)``, and attention is causal softmax over ``q k^T /
sqrt(hd)``, query head h reading key head ``h // (H / K)``. The logits
are ``n_f(x) @ E^T`` with the embedding ``E`` tied.

The weights are the benchmark's (``weight_specs``), in the layout the
port loads (``wq`` [D, H, hd], ``wo`` [H, hd, D], ``wg`` [D, F]), in
bfloat16; they are upcast to float32 a layer at a time. A norm's weight
is held as its offset from 1, as the port keeps it, and the reference
works out ``w = 1 + offset`` itself. Attention is computed a key head
and a block of queries at a time, so that 8,192 positions fit.

``precision="float8_e4m3fn"`` is the control: every projection of the
blocks (q, k, v, o, gate, up, down) takes both operands rounded to
``float8_e4m3fn`` with one scale a tensor (its largest magnitude onto
448, as fp8 inference scales a tensor), the step below the
configuration's bfloat16; the rest stays float32.
"""

from __future__ import annotations

import contextlib
import math

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def dims(config: dict):
    """``(L, D, H, K, hd, F, V)`` from the configuration's keys."""
    D, H = config["hidden_size"], config["num_attention_heads"]
    return (config["num_hidden_layers"], D, H,
            config["num_key_value_heads"], config.get("head_dim") or D // H,
            config["intermediate_size"], config["vocab_size"])


def weight_specs(config: dict) -> list[tuple[str, tuple, float]]:
    """Every weight the benchmark draws from N(0, std^2), as ``(name,
    shape, std)``: a projection N(0, 1/fan-in), which keeps the residual
    stream's scale; a norm's offset from 1 and a q, k or v bias with
    spreads of their own (``config["weights"]``), so that leaving one
    out shows."""
    L, D, H, K, hd, F, V = dims(config)
    w = config["weights"]
    norm, bias = w["norm_offset_std"], w["bias_std"]
    specs = [("embed", (V, D), D ** -0.5), ("ln_f", (D,), norm)]
    if not config["tie_word_embeddings"]:
        specs.append(("unembed", (D, V), D ** -0.5))
    for i in range(L):
        p = f"layers.{i}."
        specs += [(p + "ln1", (D,), norm), (p + "ln2", (D,), norm),
                  (p + "attn.wq", (D, H, hd), D ** -0.5),
                  (p + "attn.wk", (D, K, hd), D ** -0.5),
                  (p + "attn.wv", (D, K, hd), D ** -0.5),
                  (p + "attn.wo", (H, hd, D), (H * hd) ** -0.5),
                  (p + "mlp.wg", (D, F), D ** -0.5),
                  (p + "mlp.wu", (D, F), D ** -0.5),
                  (p + "mlp.wd", (F, D), F ** -0.5)]
        if config["qkv_bias"]:
            specs += [(p + "attn.bq", (H, hd), bias),
                      (p + "attn.bk", (K, hd), bias),
                      (p + "attn.bv", (K, hd), bias)]
    return specs


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls in float32: TF32 off for the block."""
    b = torch.backends
    prev = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = prev


def _fp8(x):
    """``x`` rounded to float8_e4m3fn under one scale, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(FP8).float() * scale


def _rms(x, offset, eps):
    w = 1.0 + offset.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope_tables(S, hd, theta, device):
    """cos and sin [S, hd/2] of ``pos * theta^(-2i/hd)``, the angles in
    float64."""
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rope(x, cos, sin):
    """x [S, heads, hd]: the two halves rotated."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _attention(q, k, v, q_block):
    """Causal GQA softmax attention. q [S, H, hd]; k, v [S, K, hd] ->
    [S, H, hd], a key head and ``q_block`` queries at a time."""
    S, H, hd = q.shape
    K = k.shape[1]
    G = H // K
    out = torch.empty_like(q)
    for j in range(K):
        kj, vj = k[:, j], v[:, j]                       # [S, hd]
        qj = q[:, j * G:(j + 1) * G].transpose(0, 1)    # [G, S, hd]
        for a in range(0, S, q_block):
            b = min(a + q_block, S)
            s = qj[:, a:b] @ kj[:b].T * hd ** -0.5      # [G, b-a, b]
            qp = torch.arange(a, b, device=q.device)[:, None]
            kp = torch.arange(b, device=q.device)[None, :]
            s = s.masked_fill(kp > qp, -math.inf)
            w = torch.softmax(s, dim=-1)
            out[a:b, j * G:(j + 1) * G] = (w @ vj[:b]).transpose(0, 1)
    return out


@torch.no_grad()
def forward_rows(config: dict, weights: dict, tokens, rows, *,
                 precision: str = "float32", q_block: int = 1024):
    """The logits [len(rows), V] in float32 at positions ``rows`` of one
    prompt ``tokens`` [S]; ``weights`` name -> tensor as
    ``weight_specs`` names them."""
    if precision not in ("float32", "float8_e4m3fn"):
        raise ValueError(f"no precision {precision!r}")
    L, D, H, K, hd, F, V = dims(config)
    eps = config["rms_norm_eps"]
    S = tokens.shape[0]
    q8 = _fp8 if precision == "float8_e4m3fn" else (lambda t: t)

    def lin(x, name, shape):
        return q8(x) @ q8(weights[name].float().reshape(shape))

    with no_tf32():
        x = weights["embed"][tokens.long()].float()
        cos, sin = _rope_tables(S, hd, config["rope_theta"], x.device)
        for i in range(L):
            p = f"layers.{i}."
            h = _rms(x, weights[p + "ln1"], eps)
            q = lin(h, p + "attn.wq", (D, H * hd)).view(S, H, hd)
            k = lin(h, p + "attn.wk", (D, K * hd)).view(S, K, hd)
            v = lin(h, p + "attn.wv", (D, K * hd)).view(S, K, hd)
            if config["qkv_bias"]:
                q = q + weights[p + "attn.bq"].float()
                k = k + weights[p + "attn.bk"].float()
                v = v + weights[p + "attn.bv"].float()
            a = _attention(_rope(q, cos, sin), _rope(k, cos, sin), v,
                           q_block)
            x = x + lin(a.reshape(S, H * hd), p + "attn.wo", (H * hd, D))
            h = _rms(x, weights[p + "ln2"], eps)
            g = torch.nn.functional.silu(lin(h, p + "mlp.wg", (D, F)))
            x = x + lin(g * lin(h, p + "mlp.wu", (D, F)), p + "mlp.wd",
                        (F, D))
        h = _rms(x[rows.long()], weights["ln_f"], eps)
        if config["tie_word_embeddings"]:
            return h @ weights["embed"].float().T
        return h @ weights["unembed"].float()
