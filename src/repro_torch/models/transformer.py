"""Model assembly in PyTorch: the port of ``repro/models/transformer.py``
for the dense and VLM decoder families without MoE or MLA (waste-pipeline,
qwen2.5-3b, granite-8b, gemma2-2b, llava-next-34b).

The JAX package stacks its layer parameters on a leading axis and scans
them; the port keeps one block per layer in an ``nn.ModuleList`` and runs
them in a Python loop, so each layer's sliding window
(``ModelConfig.window_for_layer``) is a plain int. Parameter names mirror
the JAX leaves: ``embed``, ``ln_f``, ``unembed`` and, per layer,
``layers.<i>.ln1``, ``ln2``, ``attn.wq/wk/wv/wo[/bq/bk/bv]`` and
``mlp.wg/wu/wd``, each with the JAX leaf's shape.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    AttnDims,
    normal_init,
    attention,
    init_attention,
    init_mlp,
    mlp,
    rms_norm,
    softcap,
)

#: families of ``repro`` not ported yet, and the ROADMAP item that ports them
_LATER = {
    "hybrid": "ROADMAP.md Next item 1 (hybrid zamba2-7b)",
    "ssm": "ROADMAP.md Next item 2 (falcon-mamba-7b)",
    "moe": "ROADMAP.md Next item 8 (MoE, MLA and encoder-decoder families)",
    "audio": "ROADMAP.md Next item 8 (MoE, MLA and encoder-decoder families)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family this slice does not port."""
    if cfg.arch_type in ("dense", "vlm") and not (cfg.uses_moe or cfg.use_mla
                                                  or cfg.is_encoder_decoder):
        return
    item = _LATER.get(cfg.arch_type, _LATER["moe"])
    raise NotImplementedError(
        f"{cfg.name} ({cfg.arch_type}) is not ported yet: see {item}")


def _attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        attn_softcap=cfg.attn_logit_softcap,
    )


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()})


class DecoderBlock(nn.Module):
    """Pre-norm attention + gated MLP, one layer of the stack."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        D = cfg.d_model
        self.ln1 = nn.Parameter(torch.zeros(D, dtype=dtype, device=device),
                                requires_grad=False)
        self.ln2 = nn.Parameter(torch.zeros(D, dtype=dtype, device=device),
                                requires_grad=False)
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


class Model(nn.Module):
    """Decoder-only model of the dense and VLM families.

    ``device`` None -> CUDA (raises without it). ``attn_backend`` is passed
    to ``attention_op`` for CUDA tensors ("auto"/"kernel": the flash-attention
    kernel; "ref": its plain version). Weights are drawn from ``seed``
    (``init``) or loaded with ``load_state_dict`` (``carry.py``).
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None,
                 attn_backend: str = "auto"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.attn_backend = attn_backend
        device = resolve_device(device)
        self._build(torch.Generator().manual_seed(seed), device)

    def _build(self, gen, device) -> None:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(
            normal_init(gen, (V, D), D ** -0.5, dt, device),
            requires_grad=False)
        self.ln_f = nn.Parameter(torch.zeros(D, dtype=dt, device=device),
                                 requires_grad=False)
        self.unembed = None
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                normal_init(gen, (D, V), D ** -0.5, dt, device),
                requires_grad=False)
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, gen, dt, device) for _ in range(cfg.n_layers))

    def init(self, seed: int) -> "Model":
        """Redraw every weight from ``seed`` with an explicit
        ``torch.Generator`` (on the CPU, then moved to the model's device)."""
        self._build(torch.Generator().manual_seed(seed), self.embed.device)
        return self

    def forward(self, batch: dict):
        """Returns (logits [B,S,V], aux_loss). ``batch`` carries ``tokens``
        [B,S_text] and optionally ``media`` [B,S_media,D] (VLM patch
        embeddings, placed before the text)."""
        cfg = self.cfg
        x = self.embed[batch["tokens"].long()]
        if cfg.frontend == "vision" and "media" in batch:
            x = torch.cat([batch["media"].to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        for i, block in enumerate(self.layers):
            x = block(x, cfg, positions, cfg.window_for_layer(i),
                      self.attn_backend)
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        unembed = self.embed.T if cfg.tie_embeddings else self.unembed
        logits = torch.einsum("bsd,dv->bsv", x, unembed)
        logits = softcap(logits, cfg.final_logit_softcap)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)
