"""Synthetic token stream for the serving entry points (a copy of
``repro.data.tokens.MarkovTokenSource``): numpy only, deterministic from
its seed, so the port and the reference serve the same prompts."""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig


class MarkovTokenSource:
    """Slightly-structured synthetic LM stream (order-1 Markov over a small
    alphabet embedded in the full vocab)."""

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
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
