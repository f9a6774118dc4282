"""UE <-> edge link simulation (a copy of the parts of
``repro.core.channel`` the serving engine uses: ``Channel``,
``ChannelConfig``, ``channel_fleet`` and ``tx_seconds``).

The paper's orchestrator reacts to time-varying network conditions; this
module provides (i) a Gauss-Markov (AR(1)) capacity trace calibrated to
mmWave-like variability, (ii) a two-state (LoS/NLoS) Markov blockage overlay
— mmWave beams are highly directional and blockage-prone (paper Sec. V) —
and (iii) byte/latency accounting for latent-code transfers.

Deterministic given a seed: tests and the orchestrator bench replay traces.

Randomness is *counter-based*: every draw is a pure hash of
``(per-link key, tick, draw site)`` (splitmix64 finalizer, Box-Muller for
normals), so a link's stream depends only on its own key and matches the
reference's draw for draw.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

#: Default request/response round-trip added to every boundary transfer.
#: ``Orchestrator.choose_modes`` and ``tx_seconds`` must use the same value
#: or the vectorized and scalar feasibility paths would disagree.
RTT_SECONDS = 0.004


# -- counter-based RNG primitives ---------------------------------------------
# Draws are pure functions of (key, tick, salt): uint64 mixing constants from
# splitmix64 [Steele et al. 2014]. Vectorized over numpy uint64 arrays (which
# wrap silently on overflow — exactly the arithmetic we want); scalar callers
# go through 0-d arrays so no overflow warnings fire.

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
#: draw-site salts — each (key, tick) supports several independent draws
_SALT_FADE_A = np.uint64(0xA5A5A5A5A5A5A5A5)   # Box-Muller radius uniform
_SALT_FADE_B = np.uint64(0x5A5A5A5A5A5A5A5A)   # Box-Muller angle uniform
_SALT_BLOCK = np.uint64(0xC3C3C3C3C3C3C3C3)    # blockage Markov uniform
_U53 = 1.0 / float(1 << 53)


def _finalize(x: np.ndarray) -> np.ndarray:
    """splitmix64 output mixer (bijective on uint64)."""
    x = x ^ (x >> np.uint64(30))
    x = x * _MIX1
    x = x ^ (x >> np.uint64(27))
    x = x * _MIX2
    return x ^ (x >> np.uint64(31))


def _counter_hash(keys, ticks, salt: np.uint64) -> np.ndarray:
    """uint64 hash of ``(key, tick, draw site)`` — the one RNG primitive
    both the scalar and the fleet channel draw through (broadcasts).
    Everything runs as (at least 1-d) uint64 ARRAYS: array ops wrap
    silently on overflow, which is the modular arithmetic we want (scalar
    numpy ops would emit overflow warnings)."""
    k = np.atleast_1d(np.asarray(keys, np.uint64))
    t = np.atleast_1d(np.asarray(ticks, np.uint64))
    return _finalize(_finalize((k * _MIX2) ^ salt) + t * _GAMMA)


def _u01(keys, ticks, salt: np.uint64) -> np.ndarray:
    """Uniform [0, 1) float64 draws (53 mantissa bits of the hash)."""
    return (_counter_hash(keys, ticks, salt) >> np.uint64(11)).astype(
        np.float64) * _U53


def _std_normal(keys, ticks) -> np.ndarray:
    """Standard-normal draws via Box-Muller over two salted uniforms."""
    u1 = _u01(keys, ticks, _SALT_FADE_A)
    u2 = _u01(keys, ticks, _SALT_FADE_B)
    # 1 - u1 in (0, 1] keeps the log finite; u1 == 0 maps to z == 0
    return np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)


def _key_of(seed: int) -> np.uint64:
    return np.uint64(int(seed) & 0xFFFFFFFFFFFFFFFF)


@dataclass
class ChannelConfig:
    mean_mbps: float = 800.0       # mmWave-grade uplink
    std_mbps: float = 350.0
    corr: float = 0.95             # AR(1) coefficient per tick
    blockage_prob: float = 0.03    # P(LoS -> NLoS) per tick
    recovery_prob: float = 0.25    # P(NLoS -> LoS) per tick
    nlos_factor: float = 0.08      # capacity multiplier when blocked
    min_mbps: float = 5.0
    tick_seconds: float = 0.1
    seed: int = 0


class Channel:
    """Stateful simulated link; ``step()`` advances one tick and returns the
    current capacity in bytes/second.

    ``cfg`` defaults to a *fresh* ``ChannelConfig`` per instance — a shared
    default-argument instance would alias the (mutable) config across every
    default-constructed channel.

    Draws are counter-based (see module docstring): tick ``t``'s innovation
    and blockage uniforms are pure hashes of ``(seed, t)``.
    """

    def __init__(self, cfg: Optional[ChannelConfig] = None):
        self.cfg = cfg if cfg is not None else ChannelConfig()
        self._key = _key_of(self.cfg.seed)
        self._tick = 0             # counter-RNG tick index
        self._x = 0.0              # AR(1) state (zero-mean)
        self.blocked = False
        self.t = 0.0

    def step(self) -> float:
        """Advance the live channel state by ONE tick (AR(1) fade + blockage
        Markov chain) and return the new capacity in bytes/second. Every call
        mutates ``self`` — replaying a tick is not possible; reconstruct the
        channel from the same config/seed instead."""
        c = self.cfg
        z = float(_std_normal(self._key, self._tick)[0])
        u = float(_u01(self._key, self._tick, _SALT_BLOCK)[0])
        self._tick += 1
        self._x = c.corr * self._x + \
            np.sqrt(1 - c.corr ** 2) * c.std_mbps * z
        if self.blocked:
            if u < c.recovery_prob:
                self.blocked = False
        else:
            if u < c.blockage_prob:
                self.blocked = True
        mbps = max(c.mean_mbps + self._x, c.min_mbps)
        if self.blocked:
            mbps = max(mbps * c.nlos_factor, c.min_mbps)
        self.t += c.tick_seconds
        return mbps * 1e6 / 8.0    # bytes/s

    def trace(self, n_ticks: int) -> np.ndarray:
        """Capacities (bytes/s) for the next ``n_ticks`` ticks.

        This ADVANCES the live channel state (it calls :meth:`step`
        ``n_ticks`` times): after ``trace(n)`` the channel sits ``n`` ticks
        later, and interleaving ``trace`` with ``step`` continues the same
        realization. For a side-effect-free preview, build a second
        ``Channel`` from the same config (same seed) and trace that."""
        return np.array([self.step() for _ in range(n_ticks)])



def channel_fleet(n: int, cfg: Optional[ChannelConfig] = None, *,
                  seed: int = 0, mean_spread: float = 0.5) -> list:
    """``n`` independent per-user links for continuous-batching serving.

    Each user gets their own AR(1)/blockage process (distinct sub-seed) and a
    mean uplink drawn log-uniformly within ``[1-mean_spread, 1+mean_spread]``
    of the base config — cell-edge users coexist with beam-center users, so
    a mixed decode batch genuinely wants mixed bottleneck modes.

    Every fleet member owns a *distinct* ``ChannelConfig``
    (``dataclasses.replace`` of the base), and the caller's ``cfg`` is never
    mutated — mutating one member's config cannot leak into another member
    or into later fleets built from the same base.
    """
    base = cfg if cfg is not None else ChannelConfig()
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        scale = float(np.exp(rng.uniform(np.log(max(1 - mean_spread, 0.05)),
                                         np.log(1 + mean_spread))))
        out.append(Channel(dataclasses.replace(
            base,
            mean_mbps=base.mean_mbps * scale,
            std_mbps=base.std_mbps * scale,
            # scale the capacity floor down with the mean, else the floor
            # clamps every cell-edge user to the same capacity
            min_mbps=base.min_mbps * min(scale, 1.0),
            seed=seed * 1_000_003 + i + 1)))
    return out


def tx_seconds(payload_bytes: int, capacity_bps: float,
               rtt_seconds: float = RTT_SECONDS) -> float:
    """Transfer latency for one boundary payload."""
    return payload_bytes / max(capacity_bps, 1.0) + rtt_seconds
