"""The subtractive-patch workloads of the PE-graph render.

Both builders take a package namespace ``pg`` — ``pygmu2_tpu_torch`` or
the JAX package ``pygmu2_tpu`` — so the same graph can be built from
either and the two renders compared. Both set the sample rate to 44.1 kHz.

- :func:`build_patch`: a mono subtractive voice, the path users take —
  a band-limited saw through a swept Moog ladder, gated by an ADSR, mixed
  with an ADSR-triggered pluck, through a modulated feedback comb.
- :func:`build_bank`: 128 channels through the same ladder → gated ADSR →
  comb chain, so every kernel runs at the full 128-lane width of its TPU
  original. The 128 detuned saws are an ``ArrayPE`` made with numpy from
  ``seed`` (polyBLEP band-limited sawtooths).
"""

from __future__ import annotations

import numpy as np

SR = 44100
BANK_CHANNELS = 128


def _swept(pg, center: float, hz: float, depth: float):
    """``center + depth * sin(2π hz t)`` as a PE."""
    return pg.MixPE(pg.ConstantPE(center), pg.SinePE(hz, amplitude=depth))


def patch_envelopes(pg):
    """The patch's two envelopes: (the lead's gated ADSR, the pluck's
    triggered one)."""
    return (pg.AdsrGatedPE(pg.PeriodicGate(2.0), 0.01, 0.05, 0.6, 0.1),
            pg.AdsrTriggeredPE(pg.PeriodicTrigger(hz=3), 0.01, 0.05, 0.2, 0.6, 0.1))


def build_patch(pg, seconds: float):
    """The mono patch, cropped to ``seconds`` at 44.1 kHz."""
    pg.set_sample_rate(SR)
    gated, triggered = patch_envelopes(pg)
    lead = pg.LadderPE(pg.BlitSawPE(110.0, amplitude=0.8), _swept(pg, 1500.0, 0.25, 1200.0), 0.45)
    lead = pg.GainPE(lead, gated)
    pluck = pg.GainPE(pg.BlitSawPE(220.0), triggered)
    comb = pg.CombPE(pg.MixPE(lead, pluck), _swept(pg, 220.0, 0.5, 20.0), feedback=0.6)
    return pg.CropPE(comb, 0, int(round(seconds * SR)))


def detuned_saws(n: int, seed: int, channels: int = BANK_CHANNELS) -> np.ndarray:
    """(n, channels) float32: polyBLEP sawtooths at 110 Hz detuned by up to
    ±50 cents, random initial phases, amplitude 0.25."""
    rng = np.random.default_rng(seed)
    freqs = 110.0 * 2.0 ** (rng.uniform(-50.0, 50.0, channels) / 1200.0)
    phases = rng.random(channels)
    t = np.arange(n, dtype=np.float64)
    out = np.empty((n, channels), dtype=np.float32)
    for c in range(channels):
        dt = freqs[c] / SR
        p = np.mod(phases[c] + dt * t, 1.0)
        saw = 2.0 * p - 1.0
        lo = p < dt  # just after the wrap
        r = p[lo] / dt
        saw[lo] -= r + r - r * r - 1.0
        hi = p > 1.0 - dt  # just before the wrap
        r = (p[hi] - 1.0) / dt
        saw[hi] -= r * r + r + r + 1.0
        out[:, c] = 0.25 * saw
    return out


def build_bank(pg, seconds: float, seed: int = 0):
    """The 128-channel bank, cropped to ``seconds`` at 44.1 kHz."""
    pg.set_sample_rate(SR)
    n = int(round(seconds * SR))
    saws = pg.ArrayPE(detuned_saws(n, seed))
    bank = pg.LadderPE(saws, _swept(pg, 1500.0, 0.25, 1200.0), 0.45)
    bank = pg.GainPE(bank, pg.AdsrGatedPE(pg.PeriodicGate(4.0), 0.01, 0.05, 0.6, 0.1))
    comb = pg.CombPE(bank, _swept(pg, 220.0, 0.5, 20.0), feedback=0.7)
    return pg.CropPE(comb, 0, n)
