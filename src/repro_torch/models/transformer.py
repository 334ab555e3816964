"""Model assembly in PyTorch: the port of ``repro/models/transformer.py``
for the dense and VLM decoder families without MoE or MLA (waste-pipeline,
qwen2.5-3b, granite-8b, gemma2-2b, llava-next-34b), the SSM family
(falcon-mamba-7b: Mamba-1 blocks) and the hybrid family (zamba2-7b: groups
of Mamba-2 blocks, each group followed by one shared attention block), with
the full-sequence forward and single-token decode.

The JAX package stacks its layer parameters on leading axes and scans
them; the port keeps one module per layer in ``nn.ModuleList``s and runs
them in a Python loop, so each layer's sliding window
(``ModelConfig.window_for_layer``) is a plain int. Parameter names mirror
the JAX leaves, with each stacked axis as a list index: ``embed``, ``ln_f``,
``unembed``; per dense layer ``layers.<i>.ln1``, ``ln2``,
``attn.wq/wk/wv/wo[/bq/bk/bv]`` and ``mlp.wg/wu/wd`` (the JAX ``stack``);
per SSM block ``ssm_stack.<i>.ln`` and ``ssm_stack.<i>.ssm.<leaf>``; for
the hybrid ``groups.<g>.<j>.…``, ``tail.<r>.…`` and ``shared_attn.…``.

Decode updates the state's caches and recurrent states in place
(``decode_step``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    AttnDims,
    attention,
    attention_decode,
    init_attention,
    init_mlp,
    mlp,
    normal_init,
    rms_norm,
    softcap,
)
from repro_torch.models.ssm import (
    SSMDims,
    init_ssm,
    mamba1_decode,
    mamba1_forward,
    mamba2_decode,
    mamba2_forward,
)

_LATER = "ROADMAP.md queue 1 item 1 (MoE, MLA and encoder-decoder families)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family this port does not run
    yet: MoE, MLA and the encoder-decoder family."""
    if cfg.uses_moe or cfg.use_mla or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.arch_type}) is not ported yet: see {_LATER}")


def _attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        attn_softcap=cfg.attn_logit_softcap,
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
    )


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()})


def _zeros_param(n: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderBlock(nn.Module):
    """Pre-norm attention + gated MLP, one layer of the stack."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        D = cfg.d_model
        self.ln1 = _zeros_param(D, dtype, device)
        self.ln2 = _zeros_param(D, dtype, device)
        self.attn = _params(init_attention(gen, D, _attn_dims(cfg),
                                           cfg.qkv_bias, dtype, device))
        self.mlp = _params(init_mlp(gen, D, cfg.d_ff, dtype, device))

    def forward(self, x, cfg: ModelConfig, positions, window: int,
                backend: str):
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        x = x + attention(self.attn, h, _attn_dims(cfg), positions, window,
                          backend)
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        return x + mlp(self.mlp, h, cfg.act)

    def decode(self, x, cfg: ModelConfig, cache_k, cache_v, pos,
               window: int, backend: str):
        """One token; writes its k and v into the caches in place."""
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        h, _, _ = attention_decode(self.attn, h, _attn_dims(cfg), cache_k,
                                   cache_v, pos, window, backend)
        x = x + h
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        return x + mlp(self.mlp, h, cfg.act)


class SSMBlock(nn.Module):
    """Pre-norm Mamba-1 or Mamba-2 block with a residual."""

    def __init__(self, cfg: ModelConfig, version: int, gen, dtype, device):
        super().__init__()
        self.dims = _ssm_dims(cfg, version)
        self.ln = _zeros_param(cfg.d_model, dtype, device)
        self.ssm = _params(init_ssm(gen, self.dims, dtype, device))

    def forward(self, x, cfg: ModelConfig, backend: str):
        h = rms_norm(x, self.ln, cfg.norm_eps)
        fwd = mamba1_forward if self.dims.version == 1 else mamba2_forward
        return x + fwd(self.ssm, h, self.dims, backend)

    def decode(self, x, cfg: ModelConfig, h_state, conv_buf):
        """One token; writes the new recurrent state and conv buffer into
        ``h_state`` and ``conv_buf`` in place."""
        h = rms_norm(x, self.ln, cfg.norm_eps)
        dec = mamba1_decode if self.dims.version == 1 else mamba2_decode
        out, h_new, conv_new = dec(self.ssm, h, self.dims, h_state,
                                   conv_buf)
        h_state.copy_(h_new)
        conv_buf.copy_(conv_new)
        return x + out


class Model(nn.Module):
    """Decoder-only model of the dense, VLM, SSM and hybrid families.

    ``device`` None -> CUDA (raises without it). ``backend`` is passed to
    every kernel dispatcher for CUDA tensors ("auto"/"kernel": the CUDA
    kernels — flash attention, flash decode, the SSM and SSD scans; "ref":
    their plain versions). Weights are drawn from ``seed`` with a
    ``torch.Generator`` on ``init_device`` (``init``) or loaded with
    ``load_state_dict`` (``carry.py``). The default, the CPU, gives the
    same weights for a seed on every device; drawing on the card
    (``init_device=device``) builds a 7 B model in a fraction of a second,
    with other weights for the same seed.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None,
                 backend: str = "auto", init_device="cpu"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.backend = backend
        device = resolve_device(device)
        self._build(torch.Generator(init_device).manual_seed(seed), device)

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
        else:
            self.layers = nn.ModuleList(
                DecoderBlock(cfg, gen, dt, device)
                for _ in range(cfg.n_layers))

    def init(self, seed: int, init_device="cpu") -> "Model":
        """Redraw every weight from ``seed`` with an explicit
        ``torch.Generator`` on ``init_device``, then move it to the model's
        device."""
        self._build(torch.Generator(init_device).manual_seed(seed),
                    self.embed.device)
        return self

    def _logits(self, x):
        cfg = self.cfg
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        unembed = self.embed.T if cfg.tie_embeddings else self.unembed
        logits = torch.einsum("bsd,dv->bsv", x, unembed)
        return softcap(logits, cfg.final_logit_softcap)

    def forward(self, batch: dict):
        """Returns (logits [B,S,V], aux_loss). ``batch`` carries ``tokens``
        [B,S_text] and optionally ``media`` [B,S_media,D] (VLM patch
        embeddings, placed before the text). An SSM or hybrid sequence must
        be a multiple of ``cfg.ssm_chunk``."""
        cfg, backend = self.cfg, self.backend
        x = self.embed[batch["tokens"].long()]
        if cfg.frontend == "vision" and "media" in batch:
            x = torch.cat([batch["media"].to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        if cfg.arch_type == "ssm":
            for block in self.ssm_stack:
                x = block(x, cfg, backend)
        elif cfg.arch_type == "hybrid":
            for group in self.groups:
                for block in group:
                    x = block(x, cfg, backend)
                x = self.shared_attn(x, cfg, positions, -1, backend)
            for block in self.tail:
                x = block(x, cfg, backend)
        else:
            for i, block in enumerate(self.layers):
                x = block(x, cfg, positions, cfg.window_for_layer(i),
                          backend)
        return self._logits(x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)

    # -- decode ---------------------------------------------------------------

    def init_decode_state(self, batch: int, seq_len: int) -> dict:
        """The reference's decode state for a ``seq_len`` context, zeroed on
        the model's device: ``pos`` [B] int32; for the SSM family ``h``
        [L,B,di,N] f32 and ``conv`` [L,B,d_conv-1,di]; for the hybrid ``h``
        [n_groups,g,B,H,P,N] f32, ``conv`` [n_groups,g,B,d_conv-1,di],
        ``h_tail`` and ``conv_tail`` for the tail blocks, and the shared
        block's caches ``k``, ``v`` [n_groups,B,S,K,hd]; for the dense
        family ``k``, ``v`` [L,B,S,K,hd]. Caches in the model dtype."""
        cfg = self.cfg
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
        else:
            L = cfg.n_layers
            state["k"] = zeros((L, B, S, K, hd))
            state["v"] = zeros((L, B, S, K, hd))
        return state

    def decode_step(self, state: dict, tokens):
        """tokens: [B] -> (logits [B,V], state). One generated token against
        the current state, written at ``state["pos"]``.

        The caches, recurrent states and conv buffers of ``state`` are
        updated **in place** (the JAX package returns new ones; a copy of a
        multi-GB cache per step would dominate the step); ``pos`` is
        replaced by ``pos + 1``. The returned dict holds the same tensors."""
        cfg, backend = self.cfg, self.backend
        pos = state["pos"]
        x = self.embed[tokens.long()][:, None, :]          # [B,1,D]
        if cfg.arch_type == "ssm":
            for i, block in enumerate(self.ssm_stack):
                x = block.decode(x, cfg, state["h"][i], state["conv"][i])
        elif cfg.arch_type == "hybrid":
            for gi, group in enumerate(self.groups):
                for j, block in enumerate(group):
                    x = block.decode(x, cfg, state["h"][gi, j],
                                     state["conv"][gi, j])
                x = self.shared_attn.decode(x, cfg, state["k"][gi],
                                            state["v"][gi], pos, -1,
                                            backend)
            for r, block in enumerate(self.tail):
                x = block.decode(x, cfg, state["h_tail"][r],
                                 state["conv_tail"][r])
        else:
            for i, block in enumerate(self.layers):
                x = block.decode(x, cfg, state["k"][i], state["v"][i], pos,
                                 cfg.window_for_layer(i), backend)
        state["pos"] = pos + 1
        return self._logits(x)[:, 0], state

