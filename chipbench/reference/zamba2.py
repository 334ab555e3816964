"""Plain float32 reference of Zamba2 (hf:Zyphra/Zamba2-7B-Instruct), the
layer equations of transformers' ``modeling_zamba2.py``, read from the
configuration's own keys. Plain ``torch`` operations on whatever device
the weights are on, with TF32 off; it imports nothing of the program.

The model: ``e = E[tokens]``, ``x = e``; for each of the
``num_hidden_layers`` layers i, a Mamba-2 layer
``x += mixer(n_i(x + t_i))``, where ``t_i`` is 0 unless i is the k-th
entry of ``hybrid_layer_ids``; then ``t_i = linear_k(block_{k mod
num_mem_blocks}(x, e, adapter_k))``, the block being

    h = n1([x, e])                          (attention_hidden_size wide)
    a = o(attn(rope(q(h)), rope(k(h)), v(h)))   back to hidden_size
    m = n2(a)
    g = m wg + (m wa) ag,  u = m wu + (m wa) au
    block = (gelu(g) * u) wd                (exact GELU; no residual)

with causal softmax attention over ``q k^T * (attention_head_dim / 2)^-0.5``
(``Zamba2Attention.scaling``), rope over the whole head (``rotate_half``)
at ``pos * rope_theta^(-2i/hd)``. The mixer (``Zamba2MambaMixer``):
``[z, xBC, dt] = in_proj(n)``; ``xBC = silu(conv(xBC) + b)`` (causal,
``mamba_d_conv`` taps, over x, B and C); ``[x, B, C] = xBC`` with B and C
in ``mamba_ngroups`` groups of ``mamba_d_state``; ``dt = softplus(dt +
dt_bias)``, ``A = -exp(A_log)``; the SSD ``h_t = exp(dt_t A) h_{t-1} +
dt_t B_t x_t``, ``y_t = C_t h_t + D x_t`` per head, head h reading group
``h // (heads / groups)``, computed in its chunked form (``chunk_size``
steps a chunk); ``y = gated_norm(y * silu(z))``, an RMS norm over each
group's ``intermediate / groups`` channels; ``out_proj(y)``. The logits are
``n_f(x) E^T``, the embedding tied. ``n`` is the RMS norm ``x /
sqrt(mean(x^2) + eps) * w``.

The weights are the benchmark's (``weight_specs`` and ``other_weights``),
in the layout the port loads (a projection [in, out]; ``wq`` [A, H, hd],
``wo`` [H, hd, D]), in bfloat16 but for the mixers' ``dt_bias``, ``A_log``
and ``D_head`` (float32, the published init); they are upcast to float32 a
layer at a time. A norm's weight is held as its offset from 1, as the
port keeps it. Attention runs a block of queries at a time, the SSD a
chunk at a time, so that 4,096 positions fit.

``precision="float8_e4m3fn"`` is the control: every projection of the
layers (the mixers' in and out projections, q, k, v, o, the MLPs' and
adapters' and each call's ``linear``) takes both operands rounded to
``float8_e4m3fn`` with one scale a tensor, the step below the
configuration's bfloat16; the rest stays float32.
"""

from __future__ import annotations

import math

import torch

from chipbench.reference.dense_decoder import _fp8, _rope, _rope_tables, \
    no_tf32


def dims(config: dict) -> dict:
    """The sizes the model needs, from the configuration's keys."""
    D = config["hidden_size"]
    di = config["mamba_expand"] * D
    G, N = config["mamba_ngroups"], config["mamba_d_state"]
    return {
        "L": config["num_hidden_layers"], "D": D, "di": di,
        "H_ssm": config["n_mamba_heads"], "P": config["mamba_headdim"],
        "N": N, "G": G, "conv": di + 2 * G * N, "K_conv":
        config["mamba_d_conv"], "Q": config["chunk_size"],
        "A": config["attention_hidden_size"],
        "H": config["num_attention_heads"],
        "K": config["num_key_value_heads"],
        "hd": config["attention_head_dim"], "F": config["intermediate_size"],
        "r": config["adapter_rank"], "blocks": config["num_mem_blocks"],
        "calls": list(config["hybrid_layer_ids"]), "V": config["vocab_size"],
    }


def weight_specs(config: dict) -> list[tuple[str, tuple, float]]:
    """Every weight the benchmark draws from N(0, std^2), as ``(name,
    shape, std)``: a projection N(0, 1/fan-in); the embedding, a norm's
    offset from 1 and the conv's bias with spreads of their own
    (``config["weights"]``), so that leaving one out shows."""
    d = dims(config)
    w = config["weights"]
    D, di, norm = d["D"], d["di"], w["norm_offset_std"]
    specs = [("embed", (d["V"], D), w["embed_std"]), ("ln_f", (D,), norm)]
    for i in range(d["L"]):
        p = f"mamba_layers.{i}."
        specs += [
            (p + "ln", (D,), norm),
            (p + "ssm.in_proj", (D, di + d["conv"] + d["H_ssm"]), D ** -0.5),
            (p + "ssm.conv_w", (d["K_conv"], d["conv"]), d["K_conv"] ** -0.5),
            (p + "ssm.conv_b", (d["conv"],), w["bias_std"]),
            (p + "ssm.norm_scale", (di,), norm),
            (p + "ssm.out_proj", (di, D), di ** -0.5)]
    A, H, K, hd, F = d["A"], d["H"], d["K"], d["hd"], d["F"]
    for b in range(d["blocks"]):
        p = f"shared.{b}."
        specs += [(p + "ln1", (A,), norm), (p + "ln2", (D,), norm),
                  (p + "attn.wq", (A, H, hd), A ** -0.5),
                  (p + "attn.wk", (A, K, hd), A ** -0.5),
                  (p + "attn.wv", (A, K, hd), A ** -0.5),
                  (p + "attn.wo", (H, hd, D), (H * hd) ** -0.5),
                  (p + "mlp.wg", (D, F), D ** -0.5),
                  (p + "mlp.wu", (D, F), D ** -0.5),
                  (p + "mlp.wd", (F, D), F ** -0.5)]
    for k in range(len(d["calls"])):
        specs += [(f"adapters.{k}.wa", (D, d["r"]), D ** -0.5),
                  (f"adapters.{k}.wg", (d["r"], F), d["r"] ** -0.5),
                  (f"adapters.{k}.wu", (d["r"], F), d["r"] ** -0.5),
                  (f"hybrid_linear.{k}", (D, D), D ** -0.5)]
    return specs


def other_weights(config: dict, device, gen) -> dict:
    """The mixers' float32 weights at the published init
    (``Zamba2PreTrainedModel._init_weights``): ``dt_bias`` the inverse
    softplus of dt drawn log-uniform on [time_step_min, time_step_max] and
    floored at time_step_floor, from ``gen``; ``A_log`` log(1 .. heads);
    ``D_head`` ones."""
    d = dims(config)
    H = d["H_ssm"]
    lo = math.log(config["time_step_min"])
    hi = math.log(config["time_step_max"])
    u = torch.rand((d["L"], H), generator=gen, device=device)
    dt = torch.exp(u * (hi - lo) + lo).clamp(min=config["time_step_floor"])
    inv_dt = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                   device=device))
    out = {}
    for i in range(d["L"]):
        p = f"mamba_layers.{i}.ssm."
        out[p + "dt_bias"] = inv_dt[i].contiguous()
        out[p + "A_log"] = a_log.clone()
        out[p + "D_head"] = torch.ones(H, device=device)
    return out


def _rms(x, offset, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + offset.float())


def _conv(x, w, b):
    """Causal depthwise conv: x [S, C], w [taps, C] (tap taps-1 the
    newest), b [C]."""
    K, S = w.shape[0], x.shape[0]
    pad = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    return sum(pad[i:i + S] * w[i] for i in range(K)) + b


def _ssd(x, dt, A, B, C, Q):
    """The SSD in its chunked form. x [S, H, P]; dt [S, H]; A [H]; B, C
    [S, G, N] -> y [S, H, P]; S a multiple of Q."""
    S, H, P = x.shape
    G, N = B.shape[1:]
    grp = torch.arange(H, device=x.device) // (H // G)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    h = torch.zeros(H, P, N, device=x.device)
    y = torch.empty_like(x)
    for a in range(0, S, Q):
        xc, dc, Bc, Cc = x[a:a + Q], dt[a:a + Q], B[a:a + Q], C[a:a + Q]
        L = torch.cumsum(dc * A, dim=0)                        # [Q, H]
        Bh, Ch = Bc[:, grp], Cc[:, grp]                        # [Q, H, N]
        Gm = torch.einsum("thn,shn->hts", Ch, Bh)
        decay = torch.exp(torch.where(
            tri[None], L.T[:, :, None] - L.T[:, None, :], -math.inf))
        W = Gm * decay * dc.T[:, None, :]                      # [H, t, s]
        y[a:a + Q] = (torch.einsum("hts,shp->thp", W, xc)
                      + torch.einsum("thn,hpn->thp", Ch, h)
                      * torch.exp(L)[:, :, None])
        w_end = torch.exp(L[-1] - L) * dc                      # [Q, H]
        h = torch.exp(L[-1])[:, None, None] * h + torch.einsum(
            "sh,shp,shn->hpn", w_end, xc, Bh)
    return y


def _attention(q, k, v, scale, q_block):
    """Causal softmax attention, query head h reading key head h // (H /
    K). q [S, H, hd]; k, v [S, K, hd] -> [S, H, hd], ``q_block`` queries
    at a time."""
    S, H, hd = q.shape
    rep = H // k.shape[1]
    k, v = (t.repeat_interleave(rep, dim=1).transpose(0, 1) for t in (k, v))
    qh = q.transpose(0, 1)                                     # [H, S, hd]
    out = torch.empty_like(q)
    for a in range(0, S, q_block):
        b = min(a + q_block, S)
        s = qh[:, a:b] @ k[:, :b].transpose(1, 2) * scale      # [H, b-a, b]
        qp = torch.arange(a, b, device=q.device)[:, None]
        kp = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(kp > qp, -math.inf)
        out[a:b] = (torch.softmax(s, dim=-1) @ v[:, :b]).transpose(0, 1)
    return out


@torch.no_grad()
def forward_rows(config: dict, weights: dict, tokens, rows, *,
                 precision: str = "float32", q_block: int = 512):
    """The logits [len(rows), V] in float32 at positions ``rows`` of one
    prompt ``tokens`` [S] (S a multiple of ``chunk_size``); ``weights``
    name -> tensor as ``weight_specs`` and ``other_weights`` name them."""
    if precision not in ("float32", "float8_e4m3fn"):
        raise ValueError(f"no precision {precision!r}")
    d = dims(config)
    eps = config["rms_norm_eps"]
    D, di, G, N, P = d["D"], d["di"], d["G"], d["N"], d["P"]
    Hs, H, K, hd = d["H_ssm"], d["H"], d["K"], d["hd"]
    scale = (hd / 2) ** -0.5
    S = tokens.shape[0]
    q8 = _fp8 if precision == "float8_e4m3fn" else (lambda t: t)

    def wt(name):
        return weights[name].float()

    def lin(x, name, shape=None):
        w = wt(name)
        return q8(x) @ q8(w if shape is None else w.reshape(shape))

    def block(b, k, x, e, cos, sin):
        p = f"shared.{b}."
        h = _rms(torch.cat([x, e], dim=-1), weights[p + "ln1"], eps)
        q = _rope(lin(h, p + "attn.wq", (d["A"], H * hd)).view(S, H, hd),
                  cos, sin)
        kk = _rope(lin(h, p + "attn.wk", (d["A"], K * hd)).view(S, K, hd),
                   cos, sin)
        v = lin(h, p + "attn.wv", (d["A"], K * hd)).view(S, K, hd)
        a = _attention(q, kk, v, scale, q_block).reshape(S, H * hd)
        m = _rms(lin(a, p + "attn.wo", (H * hd, D)), weights[p + "ln2"], eps)
        ad = lin(m, f"adapters.{k}.wa")
        g = lin(m, p + "mlp.wg") + lin(ad, f"adapters.{k}.wg")
        u = lin(m, p + "mlp.wu") + lin(ad, f"adapters.{k}.wu")
        out = lin(torch.nn.functional.gelu(g) * u, p + "mlp.wd")
        return lin(out, f"hybrid_linear.{k}")

    def mixer(i, n):
        p = f"mamba_layers.{i}.ssm."
        z, xbc, dt = torch.split(lin(n, p + "in_proj"),
                                 [di, d["conv"], Hs], dim=-1)
        xbc = torch.nn.functional.silu(_conv(xbc, wt(p + "conv_w"),
                                             wt(p + "conv_b")))
        xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
        dt = torch.nn.functional.softplus(dt + wt(p + "dt_bias"))
        A = -torch.exp(wt(p + "A_log"))
        xs = xs.reshape(S, Hs, P)
        y = _ssd(xs, dt, A, Bm.reshape(S, G, N), Cm.reshape(S, G, N), d["Q"])
        y = (y + xs * wt(p + "D_head")[:, None]).reshape(S, di)
        y = (y * torch.nn.functional.silu(z)).reshape(S, G, di // G)
        y = (y * torch.rsqrt(y.square().mean(-1, keepdim=True) + eps)
             ).reshape(S, di) * (1.0 + wt(p + "norm_scale"))
        return lin(y, p + "out_proj")

    with no_tf32():
        e = weights["embed"][tokens.long()].float()
        cos, sin = _rope_tables(S, hd, config["rope_theta"], e.device)
        x = e
        call = {layer: k for k, layer in enumerate(d["calls"])}
        for i in range(d["L"]):
            h = x
            if i in call:
                k = call[i]
                h = x + block(k % d["blocks"], k, x, e, cos, sin)
            x = x + mixer(i, _rms(h, weights[f"mamba_layers.{i}.ln"], eps))
        h = _rms(x[rows.long()], weights["ln_f"], eps)
        return h @ weights["embed"].float().T
