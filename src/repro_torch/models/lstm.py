"""The paper's proof-of-concept model (Fig. 6): LSTM encoder +
time-distributed Dense decoder, with the phase-2 bottleneck LSTM and decoder
adapter layer of Algorithm 1 (mirrors ``repro.models.lstm``).

Mode 0 ("z"):  x -> LSTM1 -> LSTM2 -> z = H_T^(2) -> Decoder1
Mode 1 ("z'"): x -> LSTM1 -> LSTM2 -> LSTM3(bottleneck) -> z' = H_T^(3)
               -> adapter (layer B) -> Decoder1

The decoder tiles the received latent across T timesteps and applies
time-distributed dense layers producing a per-timestep throughput class
(tanh hidden activation).

Parameters are plain dicts of float32 tensors: ``enc`` and ``dec`` are
sequences of layers (lists here, tuples when carried across from the JAX
package by ``repro_torch.convert``; either is accepted), beside
``dec_out``, ``bneck`` and ``adapter``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LSTMConfig
from repro_torch.models.layers import dense_apply, dense_init
from repro_torch.models.transformer import tree_map

# ---------------------------------------------------------------------------
# LSTM cell / layer
# ---------------------------------------------------------------------------


def lstm_layer_init(gen, d_in: int, d_hidden: int, dtype=torch.float32):
    return {
        "wx": dense_init(gen, d_in, 4 * d_hidden, bias=True, dtype=dtype),
        "wh": dense_init(gen, d_hidden, 4 * d_hidden, dtype=dtype),
    }


def lstm_layer_apply(p, x):
    """x: [B, S, d_in] -> every step's hidden state [B, S, d_hidden].

    The reference's order of arithmetic: the input projection (bias
    included) once for all steps, then per step ``z = xw_t + h @ wh`` split
    as i, f, g, o. A loop over time in plain tensor ops (one cell step a
    few kernels), differentiated by autograd."""
    B, S, _ = x.shape
    wh = p["wh"]["w"]
    dh = wh.shape[0]
    xw = dense_apply(p["wx"], x)                   # [B, S, 4dh]
    h = x.new_zeros((B, dh))
    c = x.new_zeros((B, dh))
    hs = []
    for t in range(S):
        z = xw[:, t] + h @ wh
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)                  # [B, S, dh]


# ---------------------------------------------------------------------------
# paper model
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: LSTMConfig) -> Dict:
    """Random float32 parameters on ``gen.device``."""
    params: Dict = {"enc": [], "dec": []}
    d_in = cfg.n_features
    for n in cfg.enc_cells:
        params["enc"].append(lstm_layer_init(gen, d_in, n))
        d_in = n
    z_dim = cfg.enc_cells[-1]
    d = z_dim
    for n in cfg.dec_hidden:
        params["dec"].append(dense_init(gen, d, n, bias=True,
                                        dtype=torch.float32))
        d = n
    params["dec_out"] = dense_init(gen, d, cfg.n_classes, bias=True,
                                   dtype=torch.float32)
    # phase-2 additions (Algorithm 1 lines 3-4): bottleneck LSTM (layer A)
    # + decoder adapter (layer B) mapping z' back to Decoder1's input width
    params["bneck"] = lstm_layer_init(gen, z_dim, cfg.bottleneck_cells)
    params["adapter"] = dense_init(gen, cfg.bottleneck_cells, z_dim,
                                   bias=True, dtype=torch.float32)
    return params


def encoder_apply(params, x, mode: int) -> Tuple[torch.Tensor, Dict]:
    """Returns (latent code [B, z_dim], activations dict for IB analysis)."""
    acts = {}
    h = x
    for i, layer in enumerate(params["enc"]):
        h = lstm_layer_apply(layer, h)
        acts[f"H{i + 1}"] = h                      # [B, S, cells]
    z = h[:, -1, :]                                # H_T^(2)
    if mode == 0:
        return z, acts
    h3 = lstm_layer_apply(params["bneck"], h)
    acts["H3"] = h3
    return h3[:, -1, :], acts                      # z' = H_T^(3)


def decoder_apply(params, latent, seq_len: int, mode: int) -> torch.Tensor:
    """latent: mode 0 -> z [B, z_dim]; mode 1 -> z' [B, bneck]."""
    if mode == 1:
        latent = torch.tanh(dense_apply(params["adapter"], latent))  # layer B
    h = latent[:, None, :].expand(-1, seq_len, -1)                # tile T
    for layer in params["dec"]:
        h = torch.tanh(dense_apply(layer, h))
    return dense_apply(params["dec_out"], h)       # [B, S, n_classes]


def forward(params, x, cfg: LSTMConfig, mode: int = 0):
    z, acts = encoder_apply(params, x, mode)
    logits = decoder_apply(params, z, cfg.seq_len, mode)
    acts["latent"] = z
    acts["logits"] = logits
    return logits, acts


def loss_fn(params, batch, cfg: LSTMConfig, mode: int = 0):
    """Mean per-timestep cross-entropy and accuracy (0-d tensors on the
    batch's device; nothing read to the host)."""
    logits, _ = forward(params, batch["x"], cfg, mode)
    labels = batch["y"].long()                     # [B, S]
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return torch.mean(nll), {"acc": acc}


# Algorithm 1 freeze partition: phase 1 trains enc/dec/dec_out;
# phase 2 trains ONLY bneck + adapter.
PHASE1_KEYS = ("enc", "dec", "dec_out")
PHASE2_KEYS = ("bneck", "adapter")


def phase_mask(params, phase: int):
    """The parameter tree with a bool at each leaf: True = trainable in
    this phase."""
    keys = PHASE1_KEYS if phase == 1 else PHASE2_KEYS
    return {k: tree_map(lambda _, t=k in keys: t, v)
            for k, v in params.items()}
