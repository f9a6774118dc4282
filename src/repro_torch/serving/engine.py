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

The decode state lives on the parameters' device and updates in place
(``reset`` too, so its tensors keep their addresses). On one device
``decode_tokens`` runs each token step through one graph per mode
(``serving/graphs.py``: a CUDA graph on the card, the counterpart of the
reference's jitted ``_tok_step``; uncaptured on the CPU) over static
buffers: the token, and the positions as a [B] device tensor that the
step advances. The host's checks (cache capacity, the mode, the wire
bytes) stay before each step. The tokens of a decode run stay on the
device until it ends. ``decode_static`` (the static policies' logits +
argmax chain, an oracle) and every step on a mesh run eagerly.

``mesh=`` (a ``models.sharding.serving_mesh``): the batch over dp and the
layers over mp. Every rank runs the whole batch, as one device does (a
GEMM's sums on the card depend on its row count: ``sharding``), and its
dense state holds every row; each row's tokens are taken from the dp rank
that holds it, through one exchange at the end of a decode run, so the
mesh gives the one-device tokens. The orchestrator's per-token mode is the
leader's (one broadcast a token).
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
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.telemetry import Telemetry, block, now as _now


def make_serve_step(cfg: ModelConfig, *, mode: Optional[int] = None,
                    return_tokens: bool = False, plan=None):
    """serve_step(params, token, states, cur_pos) -> (logits, states).

    mode None: the monolithic model; mode int: the split model with
    bottleneck mode m crossing the simulated link. With ``return_tokens``
    the decode tail returns argmax int32 tokens shaped like ``token``
    ([B, 1], or [B, K, 1] audio) instead of the logits. ``plan``: a serving
    mesh's ``RankPlan`` (``cfg`` the rank's config)."""
    if mode is None:
        def step(params, token, states, cur_pos):
            return T.decode_step(params, token, states, cur_pos, cfg,
                                 return_tokens=return_tokens, plan=plan)
        return step

    def step(params, token, states, cur_pos):
        out, states, _ = SP.split_decode_step(
            params, token, states, cur_pos, cfg, mode=mode,
            return_tokens=return_tokens, plan=plan)
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
    device's); ``mesh=``: the batch over dp, the layers over mp (see the
    module docstring)."""

    def __init__(self, params, cfg: ModelConfig, *, cache_len: int = 512,
                 batch: int = 1,
                 orchestrator: Optional[Orchestrator] = None,
                 mesh=None, telemetry: Optional[Telemetry] = None):
        self._tel = telemetry
        self.mesh = mesh
        self.cfg = cfg
        self.run_cfg = cfg
        self.plan = None
        self.device = params["embed"]["table"].device
        if mesh is not None:
            self.run_cfg = mesh.local_cfg(cfg)
            self.device = mesh.device
            self.plan = mesh.rank_plan(cfg)
            params = T.tree_map(lambda a: a.to(self.device),
                                sharding.shard_params(params, mesh, cfg=cfg))
        self.params = T.prepare_params(params, self.run_cfg)
        self.cache_len = cache_len
        self.batch = batch
        self.orch = orchestrator
        self._steps: Dict[Tuple[Optional[int], bool], Callable] = {}
        #: the token steps' static buffers: the token fed to the next step
        #: ([B, 1], [B, K, 1] audio) and the rows' positions
        self._tok = torch.zeros(
            (batch,) + ((cfg.n_codebooks, 1) if T.multi_codebook(cfg)
                        else (1,)), dtype=torch.int32, device=self.device)
        self._pos = torch.zeros(batch, dtype=torch.int32, device=self.device)
        #: the token step graphs, one a mode (eager steps on a mesh)
        self.graphs = StepGraphs(self.device)
        self.states = None
        self.reset()

    def _step(self, mode: Optional[int], return_tokens: bool = False):
        key = (mode, return_tokens)
        if key not in self._steps:
            self._steps[key] = make_serve_step(self.run_cfg, mode=mode,
                                               return_tokens=return_tokens,
                                               plan=self.plan)
        return self._steps[key]

    def reset(self):
        fresh = T.init_decode_state(
            self.cfg, self.batch, self.cache_len, device=self.device,
            mp=self.mesh.mp if self.mesh is not None else 1)
        if self.states is None:
            self.states = fresh
        else:                 # in place: the step graphs read these tensors
            for a, b in zip(T.tree_leaves(self.states),
                            T.tree_leaves(fresh)):
                a.copy_(b)
        self.pos = 0
        self.stats = GenStats()

    def _gather(self, t):
        """Every row of an int32 batch tensor, each from the dp rank that
        holds it, on every rank (one exchange); as it is without a mesh."""
        if self.mesh is None:
            return t
        lo, hi = self.mesh.slot_rows(self.batch)
        return self.mesh.exchange(t[lo:hi].to(torch.int32), self.batch,
                                  axis=0)

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
            logits, self.states = T.prefill(self.params, tokens,
                                            self.run_cfg, self.states,
                                            plan=self.plan)
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
        self._tok.copy_(torch.as_tensor(first_token).reshape(
            self._tok.shape))
        self._pos.fill_(self.pos)
        out = []
        t0 = _now()
        for _ in range(n_steps):
            mode: Optional[int] = None
            if self.orch is not None:
                if capacity_bps_fn is not None:
                    self.orch.observe_capacity(capacity_bps_fn())
                mode = self.orch.choose_mode()
                if self.mesh is not None:      # the leader's mode
                    self.mesh.agree([mode], "decode mode")
            # argmax is fused into the step's tail; wire bytes are host-side
            # static accounting
            if self.mesh is None:
                self.graphs.run(mode, self._tok_body(mode))
            else:
                self._tok_body(mode)()
            tok = self._tok.clone()
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
        return self._gather(torch.cat(out, dim=-1)).cpu().numpy()

    def _tok_body(self, mode: Optional[int]):
        """One token step on ``mode`` over the static buffers: the step
        ending in the fused tail decodes ``_tok`` at ``_pos``, its token
        replaces ``_tok`` and the positions advance, in place."""
        step = self._step(mode, True)

        def body():
            nxt, _ = step(self.params, self._tok, self.states, self._pos)
            self._tok.copy_(nxt.reshape(self._tok.shape))
            self._pos.add_(1)
        return body

    def decode_static(self, first_token, n_steps: int, mode: int
                      ) -> Tuple[np.ndarray, int]:
        """Generate ``n_steps`` tokens per row on one bottleneck ``mode``
        through the logits + argmax chain (the static policies). Returns
        (int32 [B, n_steps] ([B, K, n_steps] audio), wire bytes)."""
        T.check_cache_capacity(self.cfg, self.pos, n_steps, self.cache_len,
                               what="decode")
        tok = torch.as_tensor(first_token, device=self.device)
        out, wire = [], 0
        for _ in range(n_steps):
            logits, self.states, _ = SP.split_decode_step(
                self.params, tok, self.states, self.pos, self.run_cfg,
                mode=mode, plan=self.plan)
            self.pos += 1
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
            wire += int(bottleneck.mode_payload_bytes(self.cfg, self.batch,
                                                      1, mode))
        return self._gather(torch.cat(out, dim=-1)).cpu().numpy(), wire
