"""Synchronous batched serving engine with split-mode support (mirrors
``repro.serving.engine``).

This is the static-batch engine: one batch of aligned sequences, one
orchestrator-chosen mode per token applied to the whole batch, the
simplest runnable loop. ``prefill`` runs the whole prompt in one batched
forward (``T.prefill``) from a fresh state, and falls back to the per-token
decode loop for a mid-stream continuation (``pos > 0``). ``decode_tokens``
then decodes with the orchestrator's mode for each token, through the
fused decode tail, and accounts the bytes that cross the UE -> edge
boundary.

The decode state lives on the parameters' device and updates in place.
The steps are eager (the reference jits them), cached per mode; the tokens
of a decode run stay on the device until it ends.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bottleneck
from repro_torch.core import split as SP
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.models import transformer as T
from repro_torch.serving.telemetry import Telemetry, block, now as _now


def make_serve_step(cfg: ModelConfig, *, mode: Optional[int] = None,
                    return_tokens: bool = False):
    """serve_step(params, token, states, cur_pos) -> (logits, states).

    mode None: the monolithic model; mode int: the split model with
    bottleneck mode m crossing the simulated link. With ``return_tokens``
    the decode tail returns argmax int32 tokens shaped like ``token``
    ([B, 1], or [B, K, 1] audio) instead of the logits."""
    if mode is None:
        def step(params, token, states, cur_pos):
            return T.decode_step(params, token, states, cur_pos, cfg,
                                 return_tokens=return_tokens)
        return step

    def step(params, token, states, cur_pos):
        out, states, _ = SP.split_decode_step(
            params, token, states, cur_pos, cfg, mode=mode,
            return_tokens=return_tokens)
        return out, states
    return step


@dataclass
class GenStats:
    tokens: int = 0
    wire_bytes: int = 0
    mode_counts: Dict[int, int] = field(default_factory=dict)


class ServingEngine:
    """Static-batch split serving on one device, on a prepared view of
    ``params`` (``T.prepare_params``). ``telemetry=`` observes the
    reference's ``engine_sync.*`` histograms and counters (each decode
    step then waits for its token, so the inter-token time is the
    device's); ``mesh=`` is not ported yet and raises."""

    def __init__(self, params, cfg: ModelConfig, *, cache_len: int = 512,
                 batch: int = 1,
                 orchestrator: Optional[Orchestrator] = None,
                 mesh=None, telemetry: Optional[Telemetry] = None):
        if mesh is not None:
            raise NotImplementedError(
                "repro_torch serves on one device: the serving mesh "
                "(mesh=) is not ported yet (ROADMAP Queue 1 item 7)")
        self._tel = telemetry
        self.params = T.prepare_params(params, cfg)
        self.cfg = cfg
        self.cache_len = cache_len
        self.batch = batch
        self.orch = orchestrator
        self.device = params["embed"]["table"].device
        self._steps: Dict[Tuple[Optional[int], bool], Callable] = {}
        self.reset()

    def _step(self, mode: Optional[int], return_tokens: bool = False):
        key = (mode, return_tokens)
        if key not in self._steps:
            self._steps[key] = make_serve_step(self.cfg, mode=mode,
                                               return_tokens=return_tokens)
        return self._steps[key]

    def reset(self):
        self.states = T.init_decode_state(self.cfg, self.batch,
                                          self.cache_len, device=self.device)
        self.pos = 0
        self.stats = GenStats()

    def prefill(self, tokens) -> torch.Tensor:
        """tokens: [B, S] ([B, K, S] audio). Returns the last position's
        logits [B, 1, V] ([B, K, 1, V] audio).

        From a fresh state this is one batched full-sequence forward; a
        mid-stream continuation (``pos > 0``) keeps the per-token decode
        path."""
        tokens = torch.as_tensor(tokens, device=self.device)
        S = tokens.shape[-1]
        T.check_cache_capacity(self.cfg, self.pos, S, self.cache_len,
                               what="prompt")
        if self.pos == 0:
            t0 = _now()
            logits, self.states = T.prefill(self.params, tokens, self.cfg,
                                            self.states)
            if self._tel is not None:
                block(logits)
                self._tel.observe("engine_sync.prefill_s", _now() - t0)
            self.pos = S
            return logits
        step = self._step(None)
        logits = None
        for t in range(S):
            logits, self.states = step(self.params, tokens[..., t:t + 1],
                                       self.states, self.pos)
            self.pos += 1
        return logits

    def decode_tokens(self, first_token, n_steps: int, *,
                      capacity_bps_fn=None) -> np.ndarray:
        """Generate ``n_steps`` tokens per row from ``first_token`` [B, 1]
        ([B, K, 1] audio); for each token the orchestrator picks the
        transmit mode from the live channel capacity. Returns int32
        [B, n_steps] ([B, K, n_steps] audio)."""
        T.check_cache_capacity(self.cfg, self.pos, n_steps, self.cache_len,
                               what="decode")
        tok = torch.as_tensor(first_token, device=self.device)
        out = []
        t0 = _now()
        for _ in range(n_steps):
            mode: Optional[int] = None
            if self.orch is not None:
                if capacity_bps_fn is not None:
                    self.orch.observe_capacity(capacity_bps_fn())
                mode = self.orch.choose_mode()
            # argmax is fused into the step's tail; wire bytes are host-side
            # static accounting
            tok, self.states = self._step(mode, True)(
                self.params, tok, self.states, self.pos)
            pb = (bottleneck.mode_payload_bytes(self.cfg, tok.shape[0], 1,
                                                mode)
                  if mode is not None else 0)
            self.pos += 1
            out.append(tok)
            self.stats.tokens += tok.numel()
            self.stats.wire_bytes += int(pb)
            key = mode if mode is not None else -1
            self.stats.mode_counts[key] = \
                self.stats.mode_counts.get(key, 0) + 1
            if self._tel is not None:
                block(tok)
                t1 = _now()
                self._tel.observe("engine_sync.intertoken_s", t1 - t0)
                self._tel.inc("engine_sync.decode_wire_bytes", int(pb))
                self._tel.inc("engine_sync.decode_tokens", tok.numel())
                t0 = t1
        return torch.cat(out, dim=-1).cpu().numpy()
