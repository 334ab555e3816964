"""Model assembly in PyTorch: the port of ``repro/models/transformer.py``
for every family the JAX package runs: the dense and VLM decoders
(waste-pipeline, qwen2.5-3b, granite-8b, gemma2-2b, llava-next-34b), the
MoE decoders (moonshot-v1-16b-a3b and kimi-k2-1t-a32b: leading dense-FFN
layers, then MoE layers; deepseek-v2-236b the same with MLA attention),
the encoder-decoder (seamless-m4t-medium: a bidirectional encoder over
``batch["media"]``, a causal decoder with cross-attention to its output),
the SSM family (falcon-mamba-7b: Mamba-1 blocks) and the hybrid family
(zamba2-7b: groups of Mamba-2 blocks, each group followed by one shared
attention block), with the full-sequence forward and single-token decode;
and, with no JAX counterpart, the published Zamba2 layout
(zamba2-7b-instruct, ``models/zamba2_layout.py``), forward only.

The JAX package stacks its layer parameters on leading axes and scans
them; the port keeps one module per layer in ``nn.ModuleList``s and runs
them in a Python loop, so each layer's sliding window
(``ModelConfig.window_for_layer``) is a plain int. Parameter names mirror
the JAX leaves, with each stacked axis as a list index: ``embed``, ``ln_f``,
``unembed``; per decoder layer ``layers.<i>.ln1``, ``ln2``,
``attn.wq/wk/wv/wo[/bq/bk/bv]`` (MLA: ``attn.wq_a/wq_b/wkv_a/wkv_b/wo/
q_norm/kv_norm``) and ``mlp.wg/wu/wd`` or ``moe.router/wg/wu/wd[/shared.
wg/wu/wd]`` (the JAX ``stack``); a MoE model's leading dense layers
``dense_layers.<i>.…`` (``dense_stack``); the encoder-decoder's
``enc_layers.<i>.…`` and ``dec_layers.<i>.…`` (``enc_stack``,
``dec_stack``), a decoder layer with ``xattn.wq/wk/wv/wo`` and ``ln_x``;
per SSM block ``ssm_stack.<i>.ln`` and ``ssm_stack.<i>.ssm.<leaf>``; for
the hybrid ``groups.<g>.<j>.…``, ``tail.<r>.…`` and ``shared_attn.…``;
the published Zamba2 layout ``mamba_layers.<i>.ln`` and ``.ssm.<leaf>``
(the grouped mixer), ``shared.<b>.ln1`` (over [x, embedding]),
``attn.wq/wk/wv/wo``, ``ln2`` and ``mlp.wg/wu/wd``, per call
``adapters.<k>.wa/wg/wu`` and ``hybrid_linear.<k>``.

The published layout's forward keeps spans (``obs/profile.py``):
``model/mamba2`` around each Mamba-2 layer (its norm, mixer and residual)
and ``model/shared_block`` around each call's shared block and its
``linear``; with no timer active a span is one list check.

Causal self-attention goes through the flash-attention kernel and its
decode through the flash-decode kernel on the card; MLA, the encoder's
bidirectional attention, cross-attention and the MoE are plain torch, as
they are plain jnp in the reference. Decode updates the state's caches and
recurrent states in place (``decode_step``); the encoder-decoder's decode
attends to ``state["memory"]``, which ``init_decode_state`` zeroes and
nothing fills, as in the reference.

``loss`` is the reference's training loss, with ``forward(remat=True)``
recomputing the blocks the reference's ``jax.checkpoint`` recomputes.
Parameters are built with ``requires_grad=False`` for serving;
``launch/train.py`` turns them on.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import spmd
from repro_torch._device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    AttnDims,
    MLADims,
    adapted_mlp,
    attention,
    attention_decode,
    cross_attention,
    drawing,
    init_adapter,
    init_attention,
    init_mla,
    init_mlp,
    mla_attention,
    mla_attention_decode,
    mlp,
    normal_init,
    rms_norm,
    softcap,
)
from repro_torch.models.moe import MoE
from repro_torch.models.zamba2_layout import is_published, mamba_ngroups
from repro_torch.obs.profile import span
from repro_torch.models.ssm import (
    SSMDims,
    init_ssm,
    mamba1_decode,
    mamba1_forward,
    mamba2_decode,
    mamba2_forward,
)

#: why the published Zamba2 layout does not decode
_NO_PUBLISHED_DECODE = ("decode of the published Zamba2 layout: flash_decode "
                        "at head dim 224 and a grouped Mamba-2 decode are "
                        "not written")


def _attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        attn_softcap=cfg.attn_logit_softcap,
        # Zamba2Attention's scale in the published layout
        scale=(cfg.head_dim / 2) ** -0.5 if is_published(cfg) else None,
    )


def _mla_dims(cfg: ModelConfig) -> MLADims:
    return MLADims(
        n_heads=cfg.n_heads,
        head_dim=cfg.head_dim,
        kv_lora_rank=cfg.kv_lora_rank,
        q_lora_rank=cfg.q_lora_rank,
        rope_head_dim=cfg.rope_head_dim,
        rope_theta=cfg.rope_theta,
    )


def _ssm_dims(cfg: ModelConfig, version: int | None = None) -> SSMDims:
    return SSMDims(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        d_conv=cfg.ssm_conv,
        expand=cfg.ssm_expand,
        version=cfg.mamba_version if version is None else version,
        head_dim=cfg.ssm_head_dim,
        chunk=cfg.ssm_chunk,
        ngroups=mamba_ngroups(cfg),
        norm_eps=cfg.norm_eps,
    )


def _generator(init_device, seed: int, device: torch.device):
    """The seeded generator the weights are drawn from; None for a model
    on ``meta``, which draws nothing."""
    if device.type == "meta":
        return None
    return torch.Generator(init_device).manual_seed(seed)


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()})


def _zeros_param(n: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=dtype, device=device),
                        requires_grad=False)


def embed_lookup(embed, tokens):
    """``embed[tokens]``. A DTensor table goes through ``spmd.local``:
    DTensor has no rule for a lookup into a vocabulary-sharded table, and
    its propagation of one leaves a mask that later ops cannot reduce on
    ``meta``. Each rank looks up the tokens in its slice of the vocabulary,
    zeros elsewhere, and the rows come out partial over the vocabulary
    shards."""
    if not spmd.is_dtensor(embed):
        return embed[tokens.long()]
    mesh = embed.device_mesh
    tok_pl = spmd.settle(tokens).placements if spmd.is_dtensor(tokens) \
        else (spmd.Replicate(),) * mesh.ndim
    v0 = spmd.offset(embed, 0)
    sharded = spmd.Shard(0) in embed.placements
    out_pl = tuple(spmd.Partial() if pe == spmd.Shard(0) else pt
                   for pe, pt in zip(embed.placements, tok_pl))

    def fn(e, t):
        if not sharded:
            return e[t.long()]
        t = t.long() - v0
        ok = (t >= 0) & (t < e.shape[0])
        rows = e[t.clamp(0, e.shape[0] - 1)]
        return torch.where(ok[..., None], rows, rows.new_zeros(()))

    return spmd.settle(spmd.local(fn, mesh, (embed, tokens),
                                  (embed.placements, tok_pl), out_pl))


def _label_logprob_on_mesh(logits, labels):
    """``log_softmax(logits)`` at ``labels`` (clamped to 0) for DTensor
    logits [B,S,V]. Where V is sharded, each rank reduces its slice
    through ``spmd.local`` (the max, the sum of exponentials, the label's
    logit when it is in the slice) and DTensor all-reduces the [B,S]
    partials, as GSPMD does, instead of gathering the logits."""
    logits = spmd.settle(logits)
    mesh = logits.device_mesh
    pl = logits.placements
    rows = spmd.follow(pl, {0: 0, 1: 1})
    if spmd.Shard(2) not in pl:
        # local too: DTensor's backward of the gather would scatter into a
        # replicated zero tensor of the global logits' shape
        return spmd.local(
            lambda lg, lab: torch.gather(torch.log_softmax(lg, dim=-1), -1,
                                         lab.clamp_min(0)[..., None])[..., 0],
            mesh, (logits, labels), (pl, rows), rows)
    v0 = spmd.offset(logits, 2)
    vocab = [p == spmd.Shard(2) for p in pl]
    mx = spmd.local(lambda lg: lg.detach().amax(-1), mesh, (logits,), (pl,),
                    tuple(spmd.Partial("max") if v else r
                          for v, r in zip(vocab, rows)))
    mx = spmd.settle(mx)

    def part(lg, m, lab):
        lab = lab.long() - v0
        ok = (lab >= 0) & (lab < lg.shape[-1])
        picked = torch.gather(lg, -1, lab.clamp(0, lg.shape[-1] - 1)[..., None])
        picked = torch.where(ok, picked[..., 0], 0.0)
        return torch.exp(lg - m[..., None]).sum(-1), picked

    out = tuple(spmd.Partial() if v else r for v, r in zip(vocab, rows))
    sumexp, picked = spmd.local(part, mesh, (logits, mx, labels),
                                (pl, rows, rows), (out, out))
    return picked - (mx + torch.log(sumexp))


class DecoderBlock(nn.Module):
    """Pre-norm attention (GQA or MLA), optional cross-attention to an
    encoder memory (``cross``), and a gated MLP or a MoE FFN (``moe``): one
    layer of a stack."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device, *,
                 moe: bool = False, cross: bool = False):
        super().__init__()
        D = cfg.d_model
        self.ln1 = _zeros_param(D, dtype, device)
        self.ln2 = _zeros_param(D, dtype, device)
        if cfg.use_mla:
            self.attn = _params(init_mla(gen, D, _mla_dims(cfg), dtype,
                                         device))
        else:
            self.attn = _params(init_attention(gen, D, _attn_dims(cfg),
                                               cfg.qkv_bias, dtype, device))
        if cross:
            self.xattn = _params(init_attention(gen, D, _attn_dims(cfg),
                                                False, dtype, device))
            self.ln_x = _zeros_param(D, dtype, device)
        self.is_moe = moe
        if moe:
            self.moe = MoE(gen, D, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff,
                           cfg.n_shared_experts, dtype, device)
        else:
            self.mlp = _params(init_mlp(gen, D, cfg.d_ff, dtype, device))

    def _cross_and_ffn(self, x, cfg: ModelConfig, memory):
        """The layer after its self-attention: cross-attention to
        ``memory`` (when given) and the FFN. Returns (x, aux), aux None
        without MoE (no device op for a constant 0)."""
        if memory is not None:
            h = spmd.settle_grad(rms_norm(x, self.ln_x, cfg.norm_eps))
            x = x + spmd.settle(cross_attention(self.xattn, h, memory,
                                                _attn_dims(cfg)))
        h = spmd.settle_grad(rms_norm(x, self.ln2, cfg.norm_eps))
        if self.is_moe:
            h, aux = self.moe(h, cfg.top_k, cfg.capacity_factor, cfg.act)
        else:
            h, aux = mlp(self.mlp, h, cfg.act), None
        return x + spmd.settle(h), aux

    def forward(self, x, cfg: ModelConfig, positions, window: int,
                backend: str, memory=None, causal: bool = True):
        """Returns (x, aux): aux the MoE's load-balance loss, else None.
        ``causal`` False is the encoder's bidirectional self-attention."""
        h = spmd.settle_grad(rms_norm(x, self.ln1, cfg.norm_eps))
        if cfg.use_mla:
            h = mla_attention(self.attn, h, _mla_dims(cfg), positions)
        elif causal:
            h = attention(self.attn, h, _attn_dims(cfg), positions, window,
                          backend)
        else:
            h = cross_attention(self.attn, h, h, _attn_dims(cfg))
        return self._cross_and_ffn(x + spmd.settle(h), cfg, memory)

    def decode(self, x, cfg: ModelConfig, cache: dict, pos, window: int,
               backend: str, memory=None):
        """One token; writes its k and v (MLA: its latent ``ckv``) into the
        caches of ``cache`` in place."""
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if cfg.use_mla:
            h, _ = mla_attention_decode(self.attn, h, _mla_dims(cfg),
                                        cache["ckv"], pos)
        else:
            h, _, _ = attention_decode(self.attn, h, _attn_dims(cfg),
                                       cache["k"], cache["v"], pos, window,
                                       backend)
        return self._cross_and_ffn(x + spmd.settle(h), cfg, memory)[0]


class SSMBlock(nn.Module):
    """Pre-norm Mamba-1 or Mamba-2 block with a residual."""

    def __init__(self, cfg: ModelConfig, version: int, gen, dtype, device):
        super().__init__()
        self.dims = _ssm_dims(cfg, version)
        self.ln = _zeros_param(cfg.d_model, dtype, device)
        self.ssm = _params(init_ssm(gen, self.dims, dtype, device))

    def forward(self, x, cfg: ModelConfig, backend: str, add=None):
        """``add`` (a hybrid call's output) joins the mixer's input, not
        the residual."""
        h = x if add is None else x + add
        h = spmd.settle_grad(rms_norm(h, self.ln, cfg.norm_eps))
        fwd = mamba1_forward if self.dims.version == 1 else mamba2_forward
        return x + spmd.settle(fwd(self.ssm, h, self.dims, backend))

    def decode(self, x, cfg: ModelConfig, h_state, conv_buf):
        """One token; writes the new recurrent state and conv buffer into
        ``h_state`` and ``conv_buf`` in place."""
        h = rms_norm(x, self.ln, cfg.norm_eps)
        dec = mamba1_decode if self.dims.version == 1 else mamba2_decode
        out, h_new, conv_new = dec(self.ssm, h, self.dims, h_state,
                                   conv_buf)
        h_state.copy_(h_new)
        conv_buf.copy_(conv_new)
        return x + spmd.settle(out)


class SharedBlock(nn.Module):
    """One shared block of the published Zamba2 layout: the RMS norm of
    [x, embedding] (``attention_hidden_size`` wide), attention back to
    ``d_model``, an RMS norm, and the gated MLP with the call's adapter;
    no residual."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        D = cfg.d_model
        self.ln1 = _zeros_param(cfg.attention_hidden_size, dtype, device)
        self.attn = _params(init_attention(
            gen, cfg.attention_hidden_size, _attn_dims(cfg), False, dtype,
            device, d_out=D))
        self.ln2 = _zeros_param(D, dtype, device)
        self.mlp = _params(init_mlp(gen, D, cfg.d_ff, dtype, device))

    def forward(self, x, emb, adapter, cfg: ModelConfig, positions,
                backend: str):
        h = rms_norm(torch.cat([x, emb], dim=-1), self.ln1, cfg.norm_eps)
        h = attention(self.attn, h, _attn_dims(cfg), positions, -1, backend)
        h = rms_norm(h, self.ln2, cfg.norm_eps)
        return adapted_mlp(self.mlp, adapter, h, cfg.act)


class Model(nn.Module):
    """Model of every family: dense, VLM, MoE (with or without MLA),
    encoder-decoder, SSM and hybrid: forward, loss and decode.

    ``device`` None -> CUDA (raises without it). ``backend`` is passed to
    every kernel dispatcher for CUDA tensors ("auto"/"kernel": the CUDA
    kernels — flash attention, flash decode, the SSM and SSD scans; "ref":
    their plain versions). Weights are drawn from ``seed`` with a
    ``torch.Generator`` on ``init_device`` (``init``) or loaded with
    ``load_state_dict`` (``carry.py``). The default, the CPU, gives the
    same weights for a seed on every device; drawing on the card
    (``init_device=device``) builds a 7 B model in a fraction of a second,
    with other weights for the same seed. On ``meta`` (the dry run,
    ``launch/dryrun.py``) nothing is drawn: every parameter is an empty
    tensor of its shape.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None,
                 backend: str = "auto", init_device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.backend = backend
        device = resolve_device(device)
        self._build(_generator(init_device, seed, device), device)

    def _build(self, gen, device) -> None:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(
            normal_init(gen, (V, D), D ** -0.5, dt, device),
            requires_grad=False)
        self.ln_f = _zeros_param(D, dt, device)
        self.unembed = None
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                normal_init(gen, (D, V), D ** -0.5, dt, device),
                requires_grad=False)
        if cfg.arch_type == "ssm":
            self.ssm_stack = nn.ModuleList(
                SSMBlock(cfg, cfg.mamba_version, gen, dt, device)
                for _ in range(cfg.n_layers))
        elif is_published(cfg):
            self.mamba_layers = nn.ModuleList(
                SSMBlock(cfg, 2, gen, dt, device)
                for _ in range(cfg.n_layers))
            self.shared = nn.ModuleList(
                SharedBlock(cfg, gen, dt, device)
                for _ in range(cfg.num_mem_blocks))
            calls = len(cfg.hybrid_layer_ids)
            self.adapters = nn.ModuleList(
                _params(init_adapter(gen, D, cfg.d_ff, cfg.adapter_rank, dt,
                                     device)) for _ in range(calls))
            self.hybrid_linear = nn.ParameterList(
                nn.Parameter(normal_init(gen, (D, D), D ** -0.5, dt, device),
                             requires_grad=False) for _ in range(calls))
        elif cfg.arch_type == "hybrid":
            g = cfg.shared_attn_every
            n_groups, rem = divmod(cfg.n_layers, g)
            self.groups = nn.ModuleList(
                nn.ModuleList(SSMBlock(cfg, 2, gen, dt, device)
                              for _ in range(g))
                for _ in range(n_groups))
            self.tail = nn.ModuleList(
                SSMBlock(cfg, 2, gen, dt, device) for _ in range(rem))
            self.shared_attn = DecoderBlock(cfg, gen, dt, device)
        elif cfg.is_encoder_decoder:
            self.enc_layers = nn.ModuleList(
                DecoderBlock(cfg, gen, dt, device)
                for _ in range(cfg.n_encoder_layers))
            self.dec_layers = nn.ModuleList(
                DecoderBlock(cfg, gen, dt, device, cross=True)
                for _ in range(cfg.n_layers))
        else:
            nd = cfg.first_dense_layers if cfg.uses_moe else 0
            self.dense_layers = nn.ModuleList(
                DecoderBlock(cfg, gen, dt, device) for _ in range(nd))
            self.layers = nn.ModuleList(
                DecoderBlock(cfg, gen, dt, device, moe=cfg.uses_moe)
                for _ in range(cfg.n_layers - nd))

    @classmethod
    def on_mesh(cls, cfg: ModelConfig, mesh, specs: dict, *, seed: int = 0,
                device=None, backend: str = "auto",
                init_device="cpu") -> "Model":
        """``Model(cfg, seed=seed, device=device, backend=backend,
        init_device=init_device)`` with every parameter a DTensor on
        ``mesh`` placed by ``specs`` (name -> spec, as
        ``launch/sharding.py::param_specs`` gives): the same weights, but
        each is cut to this rank's shard as soon as it is drawn, so a rank
        holds its shards and one whole weight (in f32 on ``init_device``
        and in its dtype on ``device``) at most, never the whole model."""
        order = iter(cls.draw_order(cfg))
        with drawing(lambda t: spmd.distribute(t, mesh, specs[next(order)])):
            model = cls(cfg, seed=seed, device=device, backend=backend,
                        init_device=init_device)
        # the rest (norms, biases, the SSMs' A_log, D, dt_bias) is made
        # whole, each of a size of the width
        return spmd.distribute_model(model, mesh, specs)

    @classmethod
    def draw_order(cls, cfg: ModelConfig) -> list:
        """The names of the parameters that ``normal_init`` draws, in the
        order it draws them from the seed."""
        seen = []
        with drawing(lambda t: seen.append(t.untyped_storage()._cdata)
                     or t):
            meta = cls(cfg, device="meta")
        name = {p.untyped_storage()._cdata: k
                for k, p in meta.named_parameters()}
        return [name[c] for c in seen]

    def init(self, seed: int, init_device="cpu") -> "Model":
        """Redraw every weight from ``seed`` with an explicit
        ``torch.Generator`` on ``init_device``, then move it to the model's
        device."""
        self._build(_generator(init_device, seed, self.embed.device),
                    self.embed.device)
        return self

    def _logits(self, x):
        cfg = self.cfg
        x = spmd.settle_grad(rms_norm(x, self.ln_f, cfg.norm_eps))
        unembed = self.embed.T if cfg.tie_embeddings else self.unembed
        logits = torch.einsum("bsd,dv->bsv", x, unembed)
        return softcap(logits, cfg.final_logit_softcap)

    def forward(self, batch: dict, remat: bool = False):
        """Returns (logits [B,S,V], aux_loss): aux the sum of the MoE
        layers' load-balance losses (f32, 0 without MoE). ``batch`` carries
        ``tokens`` [B,S_text] and ``media`` [B,S_media,D]: VLM patch
        embeddings, placed before the text (optional), or the
        encoder-decoder's audio frames, which the encoder runs over
        (required; S_media may be 0). An SSM or hybrid sequence must be a
        multiple of ``cfg.ssm_chunk``.

        ``remat`` recomputes in the backward what the reference's
        ``jax.checkpoint`` recomputes, and nothing else: each block of the
        SSM stack, the encoder, the decoder and the main stack, and each
        hybrid group together with its shared-attention call, run under
        ``torch.utils.checkpoint``; the hybrid's tail blocks and a MoE
        model's leading dense layers do not. A recomputed block launches
        its kernels again."""
        cfg, backend = self.cfg, self.backend

        def run(fn, *args, **kw):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False, **kw)
            return fn(*args, **kw)

        x = embed_lookup(self.embed, batch["tokens"])
        if cfg.frontend == "vision" and "media" in batch:
            x = torch.cat([batch["media"].to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        aux_total = spmd.like(torch.zeros((), dtype=torch.float32,
                                          device=x.device), x)
        if cfg.arch_type == "ssm":
            for block in self.ssm_stack:
                x = run(block, x, cfg, backend)
        elif is_published(cfg):
            x = self._published_hybrid(x, positions, run)
        elif cfg.arch_type == "hybrid":
            def group_body(h, group):
                for block in group:
                    h = block(h, cfg, backend)
                return self.shared_attn(h, cfg, positions, -1, backend)[0]

            for group in self.groups:
                x = run(group_body, x, group)
            for block in self.tail:
                x = block(x, cfg, backend)
        elif cfg.is_encoder_decoder:
            mem = batch["media"].to(x.dtype)
            mem_pos = torch.arange(mem.shape[1], dtype=torch.int32,
                                   device=x.device).expand(mem.shape[:2])
            for block in self.enc_layers:
                mem, _ = run(block, mem, cfg, mem_pos, -1, backend,
                             causal=False)
            for block in self.dec_layers:
                x, _ = run(block, x, cfg, positions, -1, backend, memory=mem)
        else:
            # the dense layers global; the stack's windows from its index
            # 0, as in the reference's forward (its decode counts from the
            # first dense layer)
            for block in self.dense_layers:
                x, _ = block(x, cfg, positions, -1, backend)
            for i, block in enumerate(self.layers):
                x, aux = run(block, x, cfg, positions,
                             cfg.window_for_layer(i), backend)
                if aux is not None:
                    aux_total = aux_total + aux
        return self._logits(x), aux_total

    def _published_hybrid(self, x, positions, run):
        """The Mamba-2 layers in order; before layer ``hybrid_layer_ids[k]``
        shared block ``k % num_mem_blocks`` runs over [x, the embedding]
        with adapter k, and its output through ``hybrid_linear[k]`` joins
        that layer's mixer input."""
        cfg, backend = self.cfg, self.backend
        emb = x
        call = {layer: k for k, layer in enumerate(cfg.hybrid_layer_ids)}
        for i, block in enumerate(self.mamba_layers):
            add = None
            if i in call:
                k = call[i]
                with span("model/shared_block", device=x.device):
                    t = run(self.shared[k % cfg.num_mem_blocks], x, emb,
                            self.adapters[k], cfg, positions, backend)
                    add = torch.einsum("bsd,de->bse", t,
                                       self.hybrid_linear[k])
            with span("model/mamba2", device=x.device):
                x = run(block, x, cfg, backend, add=add)
        return x

    # -- loss -----------------------------------------------------------------

    def loss(self, batch: dict, remat: bool = True):
        """The reference's training loss: the mean cross-entropy of the
        text positions (a media prefix carries no labels) against
        ``batch["labels"]`` [B,S_text], labels < 0 masked out, in f32, plus
        ``router_aux_weight`` times the MoE aux loss.

        The reference gathers at label -1 with ``jnp.take_along_axis``,
        which wraps it to the last class before the mask zeroes the term;
        ``torch.gather`` refuses it, so the labels are clamped to 0 for the
        gather, under the same mask."""
        cfg = self.cfg
        logits, aux = self.forward(batch, remat=remat)
        labels = batch["labels"].long()
        logits_txt = logits[:, logits.shape[1] - labels.shape[1]:, :]
        if spmd.is_dtensor(logits_txt):
            ll = _label_logprob_on_mesh(logits_txt.float(), labels)
        else:
            logp = torch.log_softmax(logits_txt.float(), dim=-1)
            ll = torch.gather(logp, -1,
                              labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        ce = -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        return ce + cfg.router_aux_weight * aux

    # -- decode ---------------------------------------------------------------

    def init_decode_state(self, batch: int, seq_len: int) -> dict:
        """The reference's decode state for a ``seq_len`` context, zeroed on
        the model's device: ``pos`` [B] int32; for the SSM family ``h``
        [L,B,di,N] f32 and ``conv`` [L,B,d_conv-1,di]; for the hybrid ``h``
        [n_groups,g,B,H,P,N] f32, ``conv`` [n_groups,g,B,d_conv-1,di],
        ``h_tail`` and ``conv_tail`` for the tail blocks, and the shared
        block's caches ``k``, ``v`` [n_groups,B,S,K,hd]; with MLA the
        latent cache ``ckv`` [L,B,S,r+rh]; for the other families ``k``,
        ``v`` [L,B,S,K,hd], and for the encoder-decoder the encoder
        ``memory`` [B,S//4,D]. Caches in the model dtype."""
        cfg = self.cfg
        if is_published(cfg):
            raise NotImplementedError(_NO_PUBLISHED_DECODE)
        dev = self.embed.device
        dt = getattr(torch, cfg.dtype)
        B, S = batch, seq_len
        K, hd = cfg.n_kv_heads, cfg.head_dim
        state = {"pos": torch.zeros((B,), dtype=torch.int32, device=dev)}

        def zeros(shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        dims = _ssm_dims(cfg)
        conv = (dims.d_conv - 1, dims.d_inner)
        if cfg.arch_type == "ssm":
            L = cfg.n_layers
            state["h"] = zeros((L, B, dims.d_inner, dims.d_state),
                               torch.float32)
            state["conv"] = zeros((L, B, *conv))
        elif cfg.arch_type == "hybrid":
            g = cfg.shared_attn_every
            n_groups, rem = divmod(cfg.n_layers, g)
            hs = (dims.n_heads, dims.head_dim, dims.d_state)
            state["h"] = zeros((n_groups, g, B, *hs), torch.float32)
            state["conv"] = zeros((n_groups, g, B, *conv))
            if rem:
                state["h_tail"] = zeros((rem, B, *hs), torch.float32)
                state["conv_tail"] = zeros((rem, B, *conv))
            state["k"] = zeros((n_groups, B, S, K, hd))
            state["v"] = zeros((n_groups, B, S, K, hd))
        elif cfg.use_mla:
            state["ckv"] = zeros((cfg.n_layers, B, S,
                                  cfg.kv_lora_rank + cfg.rope_head_dim))
        else:
            L = cfg.n_layers
            state["k"] = zeros((L, B, S, K, hd))
            state["v"] = zeros((L, B, S, K, hd))
            if cfg.is_encoder_decoder:
                state["memory"] = zeros((B, S // 4, cfg.d_model))
        return state

    def decode_step(self, state: dict, tokens):
        """tokens: [B] -> (logits [B,V], state). One generated token against
        the current state, written at ``state["pos"]``.

        The caches, recurrent states and conv buffers of ``state`` are
        updated **in place**, and ``memory`` is only read (the JAX package
        returns new ones; a copy of a multi-GB cache per step would
        dominate the step); ``pos`` is replaced by ``pos + 1``. The returned dict holds the same tensors."""
        cfg, backend = self.cfg, self.backend
        if is_published(cfg):
            raise NotImplementedError(_NO_PUBLISHED_DECODE)
        pos = state["pos"]
        x = embed_lookup(self.embed, tokens)[:, None, :]   # [B,1,D]
        if cfg.arch_type == "ssm":
            for i, block in enumerate(self.ssm_stack):
                x = block.decode(x, cfg, state["h"][i], state["conv"][i])
        elif cfg.arch_type == "hybrid":
            for gi, group in enumerate(self.groups):
                for j, block in enumerate(group):
                    x = block.decode(x, cfg, state["h"][gi, j],
                                     state["conv"][gi, j])
                x = self.shared_attn.decode(
                    x, cfg, {"k": state["k"][gi], "v": state["v"][gi]}, pos,
                    -1, backend)
            for r, block in enumerate(self.tail):
                x = block.decode(x, cfg, state["h_tail"][r],
                                 state["conv_tail"][r])
        elif cfg.use_mla:
            for i, block in enumerate([*self.dense_layers, *self.layers]):
                x = block.decode(x, cfg, {"ckv": state["ckv"][i]}, pos, -1,
                                 backend)
        else:
            blocks = (self.dec_layers if cfg.is_encoder_decoder
                      else [*self.dense_layers, *self.layers])
            for i, block in enumerate(blocks):
                x = block.decode(x, cfg, {"k": state["k"][i],
                                          "v": state["v"][i]}, pos,
                                 cfg.window_for_layer(i), backend,
                                 memory=state.get("memory"))
        state["pos"] = pos + 1
        return self._logits(x)[:, 0], state

