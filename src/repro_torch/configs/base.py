"""Model / shape / split-learning configuration dataclasses.

Every assigned architecture gets a ``ModelConfig`` in its own module; the
paper's LSTM proof-of-concept uses ``LSTMConfig``. Configs are frozen
dataclasses so they can be closed over by jitted functions safely.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class SplitConfig:
    """The paper's technique: where to cut the model and how to compress the
    boundary latent.

    ``split_at``       cut after this many blocks (encoder = blocks[:split_at]).
    ``d_bottleneck``   width of the phase-2 bottleneck code z' (0 disables).
    ``quant_bits``     transmitted-code quantization (8 or 4; 0 = bf16 as-is).
    ``modes``          named (layer, width) exits; mode 0 is always the
                       full-width phase-1 code z.
    """
    split_at: int = 0
    d_bottleneck: int = 0
    quant_bits: int = 8
    # Each extra mode adds a cascade phase: (bottleneck_width, quant_bits).
    extra_modes: Tuple[Tuple[int, int], ...] = ()

    @property
    def n_modes(self) -> int:
        return 1 + (1 if self.d_bottleneck else 0) + len(self.extra_modes)


def slstm_up_width(d_model: int) -> int:
    """The sLSTM block's up / gate width (its post-cell MLP): 4/3 of
    ``d_model``, truncated, as the reference's ``slstm_init`` makes it."""
    return int(4.0 / 3.0 * d_model)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    # --- attention details ---
    qkv_bias: bool = False
    sliding_window: int = 0   # 0 = full attention
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    act: str = "silu"         # silu | gelu  (gated MLP)
    tie_embeddings: bool = False
    # --- heterogeneous block pattern, cycled over layers ---
    # entries: "attn" | "rglru" | "slstm" | "mlstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    d_rnn: int = 0            # RG-LRU width (lru_width)
    local_window: int = 0     # local attention window for hybrid archs
    # --- modality frontend stubs (embeddings provided by input_specs) ---
    frontend: str = "none"    # none | audio | vision
    n_codebooks: int = 0      # musicgen EnCodec streams
    n_vision_tokens: int = 0  # llava anyres patch-embedding prefix length
    # --- split-learning (the paper's technique) ---
    split: SplitConfig = field(default_factory=SplitConfig)
    # --- numerics ---
    dtype: str = "bfloat16"
    # provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.split.split_at == 0:
            object.__setattr__(
                self, "split",
                dataclasses.replace(self.split, split_at=self.n_layers // 2))

    # ---- derived quantities -------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    @property
    def homogeneous(self) -> bool:
        return len(set(self.block_pattern)) == 1 and self.block_pattern[0] == "attn"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode over very long contexts is O(window) / O(1)-state."""
        attn_layers = [k for k in self.block_pattern if k == "attn"]
        if not attn_layers:
            return True  # pure recurrent
        if self.sliding_window or self.local_window:
            return True
        return len(set(self.block_pattern)) > 1 and self.local_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline, not allocation)."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.frontend == "audio" and self.n_codebooks > 1:
            total += (self.n_codebooks - 1) * self.vocab_size * d
        for layer in range(self.n_layers):
            kind = self.block_kind(layer)
            total += 2 * d  # two norms per block
            if kind == "attn":
                total += d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                if self.qkv_bias:
                    total += (n_q + 2 * n_kv) * hd
            elif kind == "rglru":
                dr = self.d_rnn or d
                # linear in/out + gates (recurrence + input) + conv1d(4) + a-param
                total += 2 * d * dr + 2 * dr * dr + 4 * dr + dr
            elif kind in ("slstm", "mlstm"):
                # 4 gates projections + output
                total += 4 * d * d + d * d
            if kind in ("attn", "rglru"):  # blocks followed by an MLP
                if self.is_moe:
                    total += self.n_experts * 3 * d * self.d_ff + d * self.n_experts
                elif self.d_ff:
                    total += 3 * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses experts_per_tok of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * self.d_ff
        return dense + self.n_layers * self.experts_per_tok * 3 * d * self.d_ff


@dataclass(frozen=True)
class LSTMConfig:
    """The paper's proof-of-concept model (Fig. 6)."""
    name: str = "lumos5g-lstm"
    n_features: int = 11          # Lumos5G features [6, Table 1]
    seq_len: int = 20             # T = 20 timesteps
    n_classes: int = 3            # throughput class (low/med/high), per Lumos5G
    enc_cells: Tuple[int, ...] = (128, 128)   # phase-1 encoder LSTMs
    bottleneck_cells: int = 32    # phase-2 added LSTM layer (layer A)
    dec_hidden: Tuple[int, ...] = (64,)       # time-distributed dense decoder
    learning_rate: float = 1e-2   # paper Sec. VI
    batch_size: int = 256         # paper Sec. VI
    dtype: str = "float32"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
