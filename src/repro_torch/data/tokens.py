"""Synthetic token and multimodal-embedding batches (a copy of
``repro.data.tokens``): numpy only, deterministic from their seeds, so the
port and the reference draw the same prompts and batches.

``token_batch_shapes`` / ``make_batch`` give the audio archs' ``[B, K, S]``
codebook tokens and the vision archs' ``[B, n_vision_tokens, d_model]``
prefix beside their text tokens; ``MarkovTokenSource`` repeats its stream
over the codebooks for audio.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig


def token_batch_shapes(cfg: ModelConfig, batch: int, seq: int,
                       kind: str) -> Dict[str, tuple]:
    """Shape dict for one batch (decode kinds use seq=1 new token)."""
    s = 1 if kind == "decode" else seq
    if cfg.frontend == "audio":
        shapes = {"tokens": (batch, cfg.n_codebooks, s),
                  "labels": (batch, cfg.n_codebooks, s)}
    elif cfg.frontend == "vision" and kind != "decode":
        text = max(s - cfg.n_vision_tokens, 1)
        shapes = {"tokens": (batch, text), "labels": (batch, text),
                  "embeddings": (batch, cfg.n_vision_tokens, cfg.d_model)}
    else:
        shapes = {"tokens": (batch, s), "labels": (batch, s)}
    return shapes


def make_batch(cfg: ModelConfig, batch: int, seq: int, kind: str = "train",
               step: int = 0, seed: int = 0) -> Dict[str, np.ndarray]:
    """Materialize one deterministic batch matching ``token_batch_shapes``
    (the vision prefix as float32 normals, tokens uniform over the vocab)."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    out: Dict[str, np.ndarray] = {}
    for name, shape in token_batch_shapes(cfg, batch, seq, kind).items():
        if name == "embeddings":
            out[name] = rng.normal(0, 1, shape).astype(np.float32)
        else:
            out[name] = rng.integers(0, cfg.vocab_size, shape,
                                     dtype=np.int32)
    return out


class MarkovTokenSource:
    """Slightly-structured synthetic LM stream (order-1 Markov over a small
    alphabet embedded in the full vocab) so training losses actually go down
    in the end-to-end examples instead of sitting at log V."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, alphabet: int = 256):
        self.cfg = cfg
        self.alphabet = min(alphabet, cfg.vocab_size)
        rng = np.random.default_rng(seed)
        logits = rng.normal(0, 1.5, (self.alphabet, self.alphabet))
        p = np.exp(logits - logits.max(1, keepdims=True))
        self.trans = p / p.sum(1, keepdims=True)

    def batch(self, batch: int, seq: int, step: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(step + 17)
        toks = np.zeros((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.alphabet, batch)
        u = rng.random((batch, seq))
        cum = np.cumsum(self.trans, axis=1)
        for t in range(seq):
            toks[:, t + 1] = (u[:, t, None]
                              < cum[toks[:, t]]).argmax(axis=1)
        if self.cfg.frontend == "audio":
            k = self.cfg.n_codebooks
            return {"tokens": np.repeat(toks[:, None, :-1], k, 1),
                    "labels": np.repeat(toks[:, None, 1:], k, 1)}
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
