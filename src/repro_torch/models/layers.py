"""Core transformer layers, in PyTorch: the port of
``repro/models/layers.py``.

Shapes and parameter layouts are the JAX package's: B=batch, S=sequence,
D=d_model, H=query heads, K=kv heads, h=head_dim; ``wq`` is [D,H,h] and
``wo`` is [H,h,D], so weights carry across unchanged.

Self-attention on a CUDA tensor goes through the flash-attention kernel
(``kernels/flash_attention/ops.py::attention_op``) at every sequence length
and every per-layer window: the port runs its layers in a Python loop, so a
layer's window is a plain int, and the CUDA kernel masks its own ragged
edge. On the CPU it takes the masked-softmax path ``_sdpa``, as the JAX
package does off the TPU. Both compute the same function.

``attention_decode`` (one token against a preallocated cache) goes through
the flash-decode kernel (``kernels/flash_decode/ops.py::decode_attention_op``)
for a CUDA tensor, at every cache length and window, and through ``_sdpa``
with the reference's mask on the CPU.

``cross_attention`` (decoder to encoder memory, and the encoder's
bidirectional self-attention) and DeepSeek-V2's MLA (``mla_attention``,
the expanded prefill form, and ``mla_attention_decode``, the absorbed form
against the latent cache) are plain torch on every device, as they are
plain jnp in the reference: no kernel computes them. ``cross_attention``
takes an empty memory (zero frames) and gives zeros, as jnp does. The JAX
package's ``set_attention_q_sharding`` hint is a GSPMD sharding
constraint with no counterpart on one card, so it is left out.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.flash_decode.ops import decode_attention_op

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, n_heads, head_dim]; positions: [..., S] int32. Rotates
    the two halves of the head dim (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # [hd/2]
    angles = positions[..., None].float() * freqs         # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                 # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def causal_window_mask(q_pos, k_pos, window: int):
    """[..., Sq, Sk] additive f32 mask; window -1 = global."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = diff >= 0
    if window >= 0:
        ok &= diff < max(window, 1)
    return torch.where(ok, 0.0, NEG_INF).float()


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    attn_softcap: float = 0.0


def normal_init(gen, shape, scale, dtype, device):
    """N(0, scale²) drawn in f32 from ``gen`` on the generator's device,
    then moved to ``device`` in ``dtype``. On the ``meta`` device nothing
    is drawn (``gen`` may be None): an empty tensor of the shape."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return x.to(device=device, dtype=dtype)


def init_attention(gen, d_model, dims: AttnDims, qkv_bias=False,
                   dtype=torch.bfloat16, device=None) -> dict:
    H, K, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    s = d_model ** -0.5

    def draw(shape, scale):
        return normal_init(gen, shape, scale, dtype, device)

    p = {
        "wq": draw((d_model, H, hd), s),
        "wk": draw((d_model, K, hd), s),
        "wv": draw((d_model, K, hd), s),
        "wo": draw((H, hd, d_model), (H * hd) ** -0.5),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((K, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((K, hd), dtype=dtype, device=device)
    return p


def _qkv(p, x, dims: AttnDims, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, dims.rope_theta)
    k = apply_rope(k, positions, dims.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, dims: AttnDims):
    """q: [B,Sq,H,h]; k,v: [B,Sk,K,h]; mask: [B?,Sq,Sk] additive."""
    H, K = dims.n_heads, dims.n_kv_heads
    G = H // K
    B, Sq = q.shape[:2]
    q = q.reshape(B, Sq, K, G, dims.head_dim)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    scores = scores * dims.head_dim ** -0.5
    scores = softcap(scores, dims.attn_softcap)
    scores = scores + mask[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, dims.head_dim)


def attention(p, x, dims: AttnDims, positions, window: int = -1,
              backend: str = "auto"):
    """Full (prefill) causal self-attention with a sliding window
    (``window`` -1 = global).

    A CUDA tensor goes through ``attention_op`` (``backend`` "auto" or
    "kernel": the CUDA kernel; "ref": its plain version); a CPU tensor
    through ``_sdpa``."""
    q, k, v = _qkv(p, x, dims, positions)
    if x.is_cuda:
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out = attention_op(
            qh, kh, vh, causal=True, window=max(window, 0),
            softcap=dims.attn_softcap, backend=backend,
        ).transpose(1, 2)
    else:
        mask = causal_window_mask(positions, positions, window)
        out = _sdpa(q, k, v, mask, dims)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def attention_decode(p, x, dims: AttnDims, cache_k, cache_v, pos,
                     window: int = -1, backend: str = "auto"):
    """One-token decode against a preallocated cache.

    x: [B,1,D]; cache_k, cache_v: [B,S,K,h]; pos: [B] int32, the write
    index (``0 <= pos < S``). The new k and v (RoPE at ``pos``) are written
    into the caches **in place** at ``pos``, and the token attends to
    ``cache[: pos+1]`` (and to the last ``window`` keys when ``window`` > 0).
    The JAX package updates the caches functionally; a copy of a full cache
    each step would dominate the step here. Returns (out [B,1,D], cache_k,
    cache_v), the caches being the tensors passed in.

    A CUDA tensor goes through ``decode_attention_op`` (``backend`` "auto"
    or "kernel": the CUDA kernel, reading the caches in their own layout;
    "ref": its plain version); a CPU tensor through ``_sdpa`` with the
    reference's mask."""
    B, S = cache_k.shape[:2]
    q, k, v = _qkv(p, x, dims, pos[:, None])
    rows = torch.arange(B, device=x.device)
    cache_k[rows, pos.long()] = k[:, 0]
    cache_v[rows, pos.long()] = v[:, 0]
    if x.is_cuda:
        out = decode_attention_op(
            q[:, 0].contiguous(), cache_k, cache_v, pos,
            softcap=dims.attn_softcap, window=max(window, 0),
            backend=backend,
        )[:, None]                                        # [B,1,H,h]
    else:
        k_pos = torch.arange(S, dtype=torch.int32, device=x.device)
        diff = pos[:, None] - k_pos[None, :]
        ok = diff >= 0
        if window >= 0:
            ok &= diff < max(window, 1)
        mask = torch.where(ok, 0.0, NEG_INF).float()[:, None, :]
        out = _sdpa(q, cache_k, cache_v, mask, dims)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v


def cross_attention(p, x, memory, dims: AttnDims):
    """Decoder->encoder attention (no rope on memory keys, no mask).
    x: [B,Sq,D]; memory: [B,Sk,D], Sk may be 0."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", memory, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, p["wv"])
    B, Sq, Sk = x.shape[0], x.shape[1], memory.shape[1]
    mask = torch.zeros((B, Sq, Sk), dtype=torch.float32, device=x.device)
    out = _sdpa(q, k, v, mask, dims)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MLADims:
    n_heads: int
    head_dim: int            # per-head nope dim
    kv_lora_rank: int
    q_lora_rank: int
    rope_head_dim: int
    rope_theta: float = 1e4


def init_mla(gen, d_model, dims: MLADims, dtype=torch.bfloat16,
             device=None) -> dict:
    H, hd = dims.n_heads, dims.head_dim
    r, qr, rh = dims.kv_lora_rank, dims.q_lora_rank or d_model, \
        dims.rope_head_dim
    s = d_model ** -0.5

    def draw(shape, scale):
        return normal_init(gen, shape, scale, dtype, device)

    return {
        "wq_a": draw((d_model, qr), s),
        "wq_b": draw((qr, H, hd + rh), qr ** -0.5),
        "wkv_a": draw((d_model, r + rh), s),
        "wkv_b": draw((r, H, 2 * hd), r ** -0.5),
        "wo": draw((H, hd, d_model), (H * hd) ** -0.5),
        "q_norm": torch.zeros((qr,), dtype=dtype, device=device),
        "kv_norm": torch.zeros((r,), dtype=dtype, device=device),
    }


def _mla_qkv(p, x, dims: MLADims, positions):
    hd = dims.head_dim
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, dims.rope_theta)
    ckv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv, k_rope = ckv[..., :dims.kv_lora_rank], ckv[..., dims.kv_lora_rank:]
    c_kv = rms_norm(c_kv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        dims.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, mask, dims: MLADims):
    """Latent-space attention: queries are absorbed into the compressed KV
    (the memory-bound decode form that makes MLA's cache small)."""
    hd = dims.head_dim
    wk_b, wv_b = p["wkv_b"][..., :hd], p["wkv_b"][..., hd:]
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk_b)      # [B,Sq,H,r]
    scores = torch.einsum("bshr,btr->bhst", q_lat, c_kv).float()
    scores += torch.einsum("bshk,btk->bhst", q_rope, k_rope).float()
    scores *= (hd + dims.rope_head_dim) ** -0.5
    scores += mask[:, None, :, :]
    w = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    out_lat = torch.einsum("bhst,btr->bshr", w, c_kv)
    out = torch.einsum("bshr,rhk->bshk", out_lat, wv_b)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def mla_attention(p, x, dims: MLADims, positions):
    """Full-sequence causal MLA in the *expanded* form: latents are
    up-projected to per-head k/v before the S×S contraction. No window."""
    hd = dims.head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, dims, positions)
    wk_b, wv_b = p["wkv_b"][..., :hd], p["wkv_b"][..., hd:]
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, wk_b)
    v = torch.einsum("bsr,rhk->bshk", c_kv, wv_b)
    scores = torch.einsum("bqhk,bshk->bhqs", q_nope, k_nope).float()
    scores += torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope).float()
    scores *= (hd + dims.rope_head_dim) ** -0.5
    scores += causal_window_mask(positions, positions, -1)[:, None, :, :]
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    out = torch.einsum("bhqs,bshk->bqhk", w, v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def mla_attention_decode(p, x, dims: MLADims, cache, pos):
    """One token against the latent cache. x: [B,1,D]; cache: [B,S,r+rh],
    the compressed latents and the rope key of every position; pos: [B]
    int32. The token's ``[c_kv, k_rope]`` is written into ``cache`` **in
    place** at ``pos`` (the reference updates it functionally), and the
    token attends to ``cache[: pos+1]``. Returns (out [B,1,D], cache)."""
    B, S = cache.shape[:2]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, dims, pos[:, None])
    rows = torch.arange(B, device=x.device)
    cache[rows, pos.long()] = torch.cat([c_kv, k_rope], dim=-1)[:, 0]
    c_kv_all = cache[..., :dims.kv_lora_rank]
    k_rope_all = cache[..., dims.kv_lora_rank:]
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    mask = torch.where(pos[:, None] - k_pos[None, :] >= 0, 0.0,
                       NEG_INF).float()[:, None, :]
    out = _mla_attend(p, q_nope, q_rope, c_kv_all, k_rope_all, mask, dims)
    return out, cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model, d_ff, dtype=torch.bfloat16, device=None) -> dict:
    def draw(shape, scale):
        return normal_init(gen, shape, scale, dtype, device)

    return {
        "wg": draw((d_model, d_ff), d_model ** -0.5),
        "wu": draw((d_model, d_ff), d_model ** -0.5),
        "wd": draw((d_ff, d_model), d_ff ** -0.5),
    }


def mlp(p, x, act="silu"):
    g = act_fn(act)(torch.einsum("bsd,df->bsf", x, p["wg"]))
    u = torch.einsum("bsd,df->bsf", x, p["wu"])
    return torch.einsum("bsf,fd->bsd", g * u, p["wd"])
