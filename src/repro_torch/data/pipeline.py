"""Deterministic synthetic data pipeline: the port of
``repro/data/pipeline.py``. ``SyntheticCorpus`` is the same numpy code, so
that a seed gives the reference's batches bit for bit; its batches are
numpy, and ``launch/train.py`` moves them to the device.
``make_batch_specs`` gives the dry run's inputs as ``meta`` tensors, the
counterparts of the reference's ``jax.ShapeDtypeStruct`` stand-ins.

Generates Zipf-distributed token "documents" with induced bigram structure
(so perplexity can actually fall during the example training runs),
packed into fixed-length training batches; media-carrying archs get
matching synthetic patch/frame embeddings.  Everything is seeded and
stateless-resumable (step index -> batch), which is what checkpoint
restore needs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import InputShape, ModelConfig


@dataclasses.dataclass
class SyntheticCorpus:
    cfg: ModelConfig
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.3

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.cfg.vocab_size
        # induced bigram structure: each token prefers a successor
        self._succ = rng.integers(0, V, size=V)
        self._media_rng = np.random.default_rng(self.seed + 1)

    def batch(self, step: int) -> dict:
        """Stateless: batch for global step ``step``."""
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.batch_size, self.seq_len, self.cfg.vocab_size
        toks = np.minimum(rng.zipf(self.zipf_a, size=(B, S)) - 1, V - 1)
        # with p=0.5 follow the bigram successor of the previous token
        follow = rng.random((B, S)) < 0.5
        for t in range(1, S):
            toks[:, t] = np.where(
                follow[:, t], self._succ[toks[:, t - 1]], toks[:, t]
            )
        batch = {
            "tokens": toks.astype(np.int32),
            "labels": np.roll(toks, -1, axis=1).astype(np.int32),
        }
        batch["labels"][:, -1] = -1  # no target for the final position
        if self.cfg.frontend == "vision":
            batch["media"] = rng.standard_normal(
                (B, self.cfg.n_media_tokens, self.cfg.d_model), np.float32
            )
        elif self.cfg.frontend == "audio":
            batch["media"] = rng.standard_normal(
                (B, S // 4, self.cfg.d_model), np.float32
            )
        return batch


def make_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Stand-ins on ``meta`` (no allocation) for every model input of
    (cfg, shape): the dry run's inputs, with the reference's keys, shapes
    and dtypes. int32 ``tokens`` (and ``labels`` to train)
    [B, S] with a vision config's ``n_media_tokens`` taken off the text;
    bf16 ``media``, the vision patches or S // 4 audio frames; a decode
    step's ``tokens`` [B]."""
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((B,))}
    text_len = S - (cfg.n_media_tokens if cfg.frontend == "vision" else 0)
    specs = {"tokens": spec((B, text_len))}
    if shape.kind == "train":
        specs["labels"] = spec((B, text_len))
    if cfg.frontend == "vision":
        specs["media"] = spec((B, cfg.n_media_tokens, cfg.d_model),
                              torch.bfloat16)
    elif cfg.frontend == "audio":
        specs["media"] = spec((B, S // 4, cfg.d_model), torch.bfloat16)
    return specs
