"""Synthetic Lumos5G twin (a copy of ``repro.data.lumos5g``: the same numpy
generator, so the same seed gives the same arrays in both packages;
``stacked_batches`` is the port's own).

The real dataset [Narayanan et al., IMC 2020] is not available offline
(repro gate noted in DESIGN.md §2). This generator reproduces its published
schema and qualitative structure: ~70k timestamped samples collected while
walking/driving a 1300 m loop in downtown Minneapolis, 11 features
(longitude, latitude, moving speed, compass direction, and six LTE/NR signal
strength measurements), and a perceived mmWave throughput target that
correlates with position on the loop (beam coverage zones), mobility, and
radio measurements, with abrupt blockage events — the variability that
motivates the paper's adaptive encoding.

Throughput is discretized into ``n_classes`` balanced classes (the paper's
decoder "provides a classification for 20 timesteps").
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

LOOP_METERS = 1300.0
N_FEATURES = 11
SAMPLE_SECONDS = 1.0     # dataset sampling interval (~1 Hz in Lumos5G)


@dataclass
class Lumos5GConfig:
    n_samples: int = 70_000
    seq_len: int = 20
    n_classes: int = 3
    seed: int = 0
    test_frac: float = 0.10      # paper Sec. VI: 10% test split


def _smooth_field(n_knots: int, length: int, rng, amp: float = 1.0):
    """Periodic smooth random field over the loop (beam coverage zones)."""
    knots = rng.normal(0, amp, n_knots)
    xs = np.linspace(0, 1, length, endpoint=False)
    field = np.zeros(length)
    for k, a in enumerate(knots):
        field += a * np.cos(2 * np.pi * (k + 1) * xs + rng.uniform(0, 2 * np.pi))
    return field / np.sqrt(n_knots)


def generate(cfg: Optional[Lumos5GConfig] = None) -> Dict[str, np.ndarray]:
    """Returns dict with x [N,T,11] float32, y [N,T] int32 class labels,
    tput [N,T] float32 raw Mbps."""
    # NOTE: the default must be constructed per call — a dataclass instance
    # in the signature would be shared and mutable across all callers.
    cfg = cfg if cfg is not None else Lumos5GConfig()
    rng = np.random.default_rng(cfg.seed)
    total_ticks = cfg.n_samples + cfg.seq_len + 1

    # --- trajectory along the loop (1 m/s avg walk with speed variation) ---
    speed = np.clip(1.4 + 0.6 * _smooth_field(8, total_ticks, rng)
                    + 0.2 * rng.normal(0, 1, total_ticks), 0.0, 4.0)
    pos = np.cumsum(speed) % LOOP_METERS
    frac = pos / LOOP_METERS
    # Minneapolis-ish loop coordinates (rectangle-ish loop)
    theta = 2 * np.pi * frac
    lon = -93.273 + 0.0018 * np.cos(theta) + 1e-5 * rng.normal(0, 1, total_ticks)
    lat = 44.977 + 0.0012 * np.sin(theta) + 1e-5 * rng.normal(0, 1, total_ticks)
    compass = (np.degrees(theta) + 90.0) % 360.0

    # --- radio environment: spatial beam field + LoS/NLoS blockage chain ---
    beam = _smooth_field(12, 4096, rng, amp=1.2)       # field over loop bins
    beam_at = beam[(frac * 4096).astype(int) % 4096]
    blocked = np.zeros(total_ticks, bool)
    b = False
    for t in range(total_ticks):
        b = (rng.random() < 0.25) if b else (rng.random() < 0.02)
        blocked[t] = b
    nr_rsrp = -85 + 12 * beam_at - 25 * blocked + rng.normal(0, 2, total_ticks)
    nr_rsrq = -10 + 3 * beam_at - 6 * blocked + rng.normal(0, 1, total_ticks)
    nr_snr = 18 + 8 * beam_at - 18 * blocked + rng.normal(0, 1.5, total_ticks)
    lte_rsrp = -95 + 4 * _smooth_field(6, total_ticks, rng) \
        + rng.normal(0, 2, total_ticks)
    lte_rsrq = -11 + 1.5 * _smooth_field(6, total_ticks, rng) \
        + rng.normal(0, 1, total_ticks)
    lte_snr = 12 + 4 * _smooth_field(6, total_ticks, rng) \
        + rng.normal(0, 1.5, total_ticks)

    # --- perceived throughput (Mbps): beam-dependent, mobility-penalized ---
    tput = np.clip(
        900 + 550 * beam_at - 820 * blocked - 60 * (speed - 1.4)
        + 12 * (nr_snr - 18) + 80 * rng.normal(0, 1, total_ticks),
        1.0, 2200.0)
    # AR(1) smoothing (TCP ramp dynamics)
    for t in range(1, total_ticks):
        tput[t] = 0.7 * tput[t - 1] + 0.3 * tput[t]

    feats = np.stack([lon, lat, speed, compass, lte_rsrp, lte_rsrq, lte_snr,
                      nr_rsrp, nr_rsrq, nr_snr,
                      blocked.astype(float)], axis=1)   # 11 features
    # normalize features
    feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-9)

    # class labels by global terciles (balanced classes)
    edges = np.quantile(tput, np.linspace(0, 1, cfg.n_classes + 1)[1:-1])
    labels = np.digitize(tput, edges).astype(np.int32)

    # sliding windows
    idx = np.arange(cfg.n_samples)[:, None] + np.arange(cfg.seq_len)[None, :]
    return {
        "x": feats[idx].astype(np.float32),            # [N,T,11]
        "y": labels[idx],                              # [N,T]
        "tput": tput[idx].astype(np.float32),
    }


def throughput_series_mbps(n_seconds: int, seed: int = 0) -> np.ndarray:
    """Raw perceived-throughput walk [n_seconds] in Mbps at ~1 Hz.

    This is the un-windowed time series behind ``generate()["tput"]`` —
    the channel-facing view of the dataset (signal features dropped).
    """
    if n_seconds < 1:
        raise ValueError("n_seconds must be >= 1")
    data = generate(Lumos5GConfig(n_samples=n_seconds, seq_len=1, seed=seed))
    return data["tput"][:, 0].astype(np.float64)


def capacity_traces_bps(n_ues: int, n_ticks: int, *,
                        tick_seconds: float = 0.1,
                        seed: int = 0,
                        stagger_seconds: float = 30.0) -> np.ndarray:
    """Per-UE link-capacity traces [n_ues, n_ticks] in **bytes/second**,
    resampled from the 1 Hz Lumos5G throughput walk to channel ticks.

    Each UE replays a window of one long walk of the loop, offset by a
    random start time (UEs traverse the same city at different times), so
    one O(seconds) generation pass serves an arbitrarily large fleet.
    Linear interpolation bridges the 1 Hz samples down to ``tick_seconds``;
    Mbps converts to bytes/s via *1e6/8.
    """
    if n_ues < 1 or n_ticks < 1:
        raise ValueError("n_ues and n_ticks must be >= 1")
    if tick_seconds <= 0:
        raise ValueError("tick_seconds must be > 0")
    span_s = n_ticks * tick_seconds
    need = int(np.ceil(span_s / SAMPLE_SECONDS)) + 2
    total = max(2 * need, int(np.ceil(stagger_seconds / SAMPLE_SECONDS))
                * min(n_ues, 128) + need)
    series = throughput_series_mbps(total, seed=seed)
    rng = np.random.default_rng(seed + 1)
    offsets = rng.uniform(0.0, (total - need) * SAMPLE_SECONDS, size=n_ues)
    # shared source series: one flattened interp covers the whole fleet
    t = offsets[:, None] + np.arange(n_ticks) * tick_seconds       # seconds
    sample_t = np.arange(total) * SAMPLE_SECONDS
    mbps = np.interp(t.ravel(), sample_t, series).reshape(n_ues, n_ticks)
    return mbps * 1e6 / 8.0


def train_test_split(data: Dict[str, np.ndarray], cfg: Lumos5GConfig):
    n = data["x"].shape[0]
    n_test = int(n * cfg.test_frac)
    rng = np.random.default_rng(cfg.seed + 1)
    perm = rng.permutation(n)
    te, tr = perm[:n_test], perm[n_test:]
    split = lambda ix: {k: v[ix] for k, v in data.items()}
    return split(tr), split(te)


def batch_iterator(data: Dict[str, np.ndarray], batch_size: int,
                   seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = data["x"].shape[0]
    while True:
        ix = rng.choice(n, batch_size, replace=False)
        yield {"x": data["x"][ix], "y": data["y"][ix]}


def stacked_batches(data: Dict[str, np.ndarray], batch_size: int, n: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """The first ``n`` batches of ``batch_iterator(data, batch_size,
    seed)`` stacked: {"x": [n, B, T, 11], "y": [n, B, T]} (the port
    uploads a run's batches to the device at once)."""
    it = batch_iterator(data, batch_size, seed)
    bs = [next(it) for _ in range(n)]
    return {k: np.stack([b[k] for b in bs]) for k in ("x", "y")}
