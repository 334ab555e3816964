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
takes an empty memory (zero frames) and gives zeros, as jnp does.

On a mesh (DTensor weights, ``launch/sharding.py``) the attention core
runs through ``spmd.attend``, on the local q heads (or batch rows) and the
kv heads they read; ``set_attention_q_sharding`` is the reference's hint
that shards q's sequence over ``model`` when the heads do not divide it.
A decode step writes its k and v into a sharded cache through
``spmd.local`` (``write_rows``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import spmd
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.flash_decode.ops import decode_attention_op

NEG_INF = -1e30

#: The mesh axis that shards q's sequence in train and prefill when the
#: heads do not divide it, set by ``launch/sharding.py::
#: configure_attention_sharding``; None: q follows its weights.
_ATTN_Q_SHARDING = None


def set_attention_q_sharding(axis) -> None:
    """``axis``: a mesh axis name (q [B, S, H, hd] sequence-sharded over
    it, the batch kept as it is), or None."""
    global _ATTN_Q_SHARDING
    _ATTN_Q_SHARDING = axis


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    if spmd.is_dtensor(xf) and spmd.Shard(xf.ndim - 1) in xf.placements:
        # over a sharded last dim the sum is partial: all-reduce it here
        # (left to DTensor it may reduce-scatter it on S, and then gather x)
        var = spmd.settle(xf.square().sum(dim=-1, keepdim=True)) \
            / xf.shape[-1]
    else:
        var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_exact": F.gelu,
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
    freqs = spmd.like(rope_freqs(hd, theta, x.device), positions)
    angles = positions[..., None].float() * freqs         # [..., S, hd/2]
    cos = spmd.like(torch.cos(angles)[..., None, :], x)   # [..., S, 1, hd/2]
    sin = spmd.like(torch.sin(angles)[..., None, :], x)
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
    scale: float | None = None    # of the scores; None -> head_dim ** -0.5

    @property
    def score_scale(self) -> float:
        return self.head_dim ** -0.5 if self.scale is None else self.scale


#: set by ``drawing``: takes each weight ``normal_init`` draws and gives
#: what the model keeps in its place
_KEEP = None


@contextlib.contextmanager
def drawing(keep):
    """While the block runs, every weight ``normal_init`` draws (whole, in
    its dtype on its device) is passed through ``keep``, and the model
    holds what ``keep`` returns: ``transformer.Model.on_mesh`` keeps a
    rank's shard of each as it is drawn."""
    global _KEEP
    prev, _KEEP = _KEEP, keep
    try:
        yield
    finally:
        _KEEP = prev


def normal_init(gen, shape, scale, dtype, device):
    """N(0, scale²) drawn in f32 from ``gen`` on the generator's device,
    then moved to ``device`` in ``dtype``. On the ``meta`` device nothing
    is drawn (``gen`` may be None): an empty tensor of the shape."""
    if device is not None and torch.device(device).type == "meta":
        x = torch.empty(shape, dtype=dtype, device=device)
    else:
        # scaled in place: a weight drawn whole takes 4 + itemsize bytes
        # an element at its peak, not 8 + itemsize
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device).mul_(scale).to(device=device,
                                                         dtype=dtype)
    return x if _KEEP is None else _KEEP(x)


def init_attention(gen, d_model, dims: AttnDims, qkv_bias=False,
                   dtype=torch.bfloat16, device=None, d_out=None) -> dict:
    """q, k and v from ``d_model`` wide inputs; the output ``d_out`` wide
    (``d_model`` where None)."""
    H, K, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    s = d_model ** -0.5

    def draw(shape, scale):
        return normal_init(gen, shape, scale, dtype, device)

    p = {
        "wq": draw((d_model, H, hd), s),
        "wk": draw((d_model, K, hd), s),
        "wv": draw((d_model, K, hd), s),
        "wo": draw((H, hd, d_model if d_out is None else d_out),
                   (H * hd) ** -0.5),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((K, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((K, hd), dtype=dtype, device=device)
    return p


def _qkv(p, x, dims: AttnDims, positions, xq=None):
    """q (from ``xq`` when given: x's rows placed otherwise), k, v."""
    q = torch.einsum("bsd,dhk->bshk", x if xq is None else xq, p["wq"])
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
    scores = scores * dims.score_scale
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
    if spmd.is_dtensor(x):
        return _attention_on_mesh(p, x, dims, positions, window, backend)
    q, k, v = _qkv(p, x, dims, positions)
    if x.is_cuda:
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out = attention_op(
            qh, kh, vh, causal=True, window=max(window, 0),
            softcap=dims.attn_softcap, scale=dims.scale,
            backend=backend,
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
    write_rows(cache_k, pos, k[:, 0])
    write_rows(cache_v, pos, v[:, 0])

    def plain(q, k, v, pos, dims):
        k_pos = spmd.like(torch.arange(S, dtype=torch.int32,
                                       device=x.device), pos)
        diff = pos[:, None] - k_pos[None, :]
        ok = diff >= 0
        if window >= 0:
            ok &= diff < max(window, 1)
        mask = torch.where(ok, 0.0, NEG_INF).float()[:, None, :]
        return _sdpa(q, k, v, mask, dims)

    if x.is_cuda:
        out = decode_attention_op(
            q[:, 0].contiguous(), cache_k, cache_v, pos,
            softcap=dims.attn_softcap, window=max(window, 0),
            backend=backend,
        )[:, None]                                        # [B,1,H,h]
    elif spmd.is_dtensor(cache_k) and \
            spmd.Shard(1) not in cache_k.placements:
        # the heads or rows of a rank are local, as on the kernel's route
        out = spmd.attend(
            lambda ql, kl, vl, pl, _: plain(ql, kl, vl, pl,
                                            _local_dims(dims, ql, kl)),
            q, cache_k, cache_v, pos, q_heads=2, kv_heads=2)
    else:
        if spmd.is_dtensor(q):
            # a cache sharded on S: DTensor propagates the plain ops, as
            # GSPMD does (the softmax over S gathers the scores), with q's
            # heads whole: its kv heads are not sharded
            q = q.redistribute(q.device_mesh, [
                spmd.Replicate() if p == spmd.Shard(2) else p
                for p in spmd.settle(q).placements])
        out = plain(q, cache_k, cache_v, pos, dims)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v


def _local_dims(dims: AttnDims, q, k) -> AttnDims:
    """``dims`` with the head counts of a rank's local q [B,S,H,h] and
    k [B,S,K,h]."""
    return dataclasses.replace(dims, n_heads=q.shape[2],
                               n_kv_heads=k.shape[2])


def _attention_on_mesh(p, x, dims: AttnDims, positions, window: int,
                       backend: str):
    """``attention`` of DTensors: q sequence-sharded where the hint asks
    (the q projection then reads only the local rows of x), the core
    through ``spmd.attend`` on local shards: the CUDA kernel's route for a
    CUDA tensor (a rank's rows at their offset against every key),
    ``_sdpa`` with the mask of the local rows otherwise. The positions
    are the model's, 0 .. S-1."""
    del positions
    xq = x
    if _ATTN_Q_SHARDING is not None and x.shape[1] > 1:
        mesh = x.device_mesh
        i = mesh.mesh_dim_names.index(_ATTN_Q_SHARDING)
        pl = list(spmd.settle(x).placements)
        pl[i] = spmd.Shard(1)
        xq = x.redistribute(mesh, pl)
    S = x.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q, k, v = _qkv(p, x, dims, pos, xq)
    if x.is_cuda:
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out = attention_op(
            qh, kh, vh, causal=True, window=max(window, 0),
            softcap=dims.attn_softcap, scale=dims.scale,
            backend=backend,
        ).transpose(1, 2)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    def core(ql, kl, vl, s0):
        Sq = ql.shape[1]
        qp = torch.arange(s0, s0 + Sq, dtype=torch.int32,
                          device=ql.device)[None]
        kp = torch.arange(S, dtype=torch.int32, device=ql.device)[None]
        mask = causal_window_mask(qp, kp, window)
        return _sdpa(ql, kl, vl, mask, _local_dims(dims, ql, kl))

    out = spmd.attend(core, q, k, v, q_heads=2, kv_heads=2, q_seq=1)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def write_rows(cache, pos, val) -> None:
    """``cache[b, pos[b]] = val[b]`` in place. cache: [B,S,...]; pos: [B]
    int32; val: [B,...]. A DTensor cache is written through
    ``spmd.local``, since DTensor has no rule for a per-row index into a
    sharded dim: each rank writes the rows whose position falls in its
    slice of S (a rank rewrites its own value elsewhere)."""
    if not spmd.is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos.long()] = val
        return
    s0 = spmd.offset(cache, 1)
    dims = {0: 0, **{d: d - 1 for d in range(2, cache.ndim)}}

    def fn(c, p, v):
        idx = p.long() - s0
        ok = (idx >= 0) & (idx < c.shape[1])
        idx = idx.clamp(0, c.shape[1] - 1)
        rows = torch.arange(c.shape[0], device=c.device)
        keep = ok.view(-1, *[1] * (v.ndim - 1))
        c[rows, idx] = torch.where(keep, v.to(c.dtype), c[rows, idx])
        return c

    spmd.local(fn, cache.device_mesh, (cache, pos, val),
               (cache.placements, spmd.follow(cache.placements, {0: 0}),
                spmd.follow(cache.placements, dims)), cache.placements)


def cross_attention(p, x, memory, dims: AttnDims):
    """Decoder->encoder attention (no rope on memory keys, no mask).
    x: [B,Sq,D]; memory: [B,Sk,D], Sk may be 0."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", memory, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, p["wv"])
    B, Sq, Sk = x.shape[0], x.shape[1], memory.shape[1]
    mask = spmd.like(torch.zeros((B, Sq, Sk), dtype=torch.float32,
                                 device=x.device), q)
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
    # wq_a shards the latent, wq_b the heads: gather the latent, else
    # DTensor reshards wq_b on the latent and sums every head's q
    q = torch.einsum("bsr,rhk->bshk", spmd.unshard(cq, 2), p["wq_b"])
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
    if spmd.is_dtensor(q_nope):
        out = _mla_core_on_mesh(q_nope, q_rope, k_nope, k_rope, v, dims)
    else:
        out = _mla_core(q_nope, q_rope, k_nope, k_rope, v, dims, positions)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _mla_core(q_nope, q_rope, k_nope, k_rope, v, dims: MLADims, positions):
    """The S x S part of the expanded MLA: [B,S,H,hd] out."""
    hd = dims.head_dim
    scores = torch.einsum("bqhk,bshk->bhqs", q_nope, k_nope).float()
    scores += torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope).float()
    scores *= (hd + dims.rope_head_dim) ** -0.5
    scores += spmd.like(causal_window_mask(positions, positions, -1),
                        scores)[:, None, :, :]
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    return torch.einsum("bhqs,bshk->bqhk", w, v)


def _mla_core_on_mesh(q_nope, q_rope, k_nope, k_rope, v, dims: MLADims):
    """``_mla_core`` of DTensors through ``spmd.local``: each head's
    scores are local to its shard (DTensor's propagation gathers the
    S x S scores in the backward); the rope key, shared by the heads,
    follows the batch only. Positions 0 .. S-1."""
    q_nope = spmd.settle(q_nope)
    pl = q_nope.placements
    if any(p.is_shard() and p.dim not in (0, 2) for p in pl):
        raise NotImplementedError(f"MLA with q placed {pl}")
    heads = spmd.follow(pl, {0: 0, 2: 2})
    rows = spmd.follow(pl, {0: 0})

    def fn(qn, qr, kn, kr, v_):
        S = qn.shape[1]
        pos = torch.arange(S, dtype=torch.int32, device=qn.device)[None]
        return _mla_core(qn, qr, kn, kr, v_, dims, pos)

    return spmd.local(fn, q_nope.device_mesh,
                      (q_nope, q_rope, k_nope, k_rope, v),
                      (heads, heads, heads, rows, heads), heads)


def mla_attention_decode(p, x, dims: MLADims, cache, pos):
    """One token against the latent cache. x: [B,1,D]; cache: [B,S,r+rh],
    the compressed latents and the rope key of every position; pos: [B]
    int32. The token's ``[c_kv, k_rope]`` is written into ``cache`` **in
    place** at ``pos`` (the reference updates it functionally), and the
    token attends to ``cache[: pos+1]``. Returns (out [B,1,D], cache)."""
    B, S = cache.shape[:2]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, dims, pos[:, None])
    write_rows(cache, pos, torch.cat([c_kv, k_rope], dim=-1)[:, 0])
    c_kv_all = cache[..., :dims.kv_lora_rank]
    k_rope_all = cache[..., dims.kv_lora_rank:]
    k_pos = spmd.like(torch.arange(S, dtype=torch.int32, device=x.device),
                      pos)
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


def init_adapter(gen, d_model, d_ff, rank, dtype=torch.bfloat16,
                 device=None) -> dict:
    """A rank-``rank`` adapter of a gated MLP's gate and up projections:
    ``wa`` [D, r], then ``wg`` and ``wu`` [r, F]."""
    def draw(shape, scale):
        return normal_init(gen, shape, scale, dtype, device)

    return {"wa": draw((d_model, rank), d_model ** -0.5),
            "wg": draw((rank, d_ff), rank ** -0.5),
            "wu": draw((rank, d_ff), rank ** -0.5)}


def adapted_mlp(p, adapter, x, act):
    """``mlp`` with ``adapter``'s low-rank terms added to the gate and up
    projections before the activation (Zamba2's shared MLP, whose adapter
    belongs to the call)."""
    a = torch.einsum("bsd,dr->bsr", x, adapter["wa"])
    g = torch.einsum("bsd,df->bsf", x, p["wg"]) \
        + torch.einsum("bsr,rf->bsf", a, adapter["wg"])
    u = torch.einsum("bsd,df->bsf", x, p["wu"]) \
        + torch.einsum("bsr,rf->bsf", a, adapter["wu"])
    return torch.einsum("bsf,fd->bsd", act_fn(act)(g) * u, p["wd"])
