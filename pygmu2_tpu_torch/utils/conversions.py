"""Unit conversions (vectorized, host-side numpy).

Counterpart of ``pygmu2_tpu.utils.conversions``, copied verbatim on the
port's temperament (reference: src/pygmu2/conversions.py:21-281). Pitch conversions are
temperament-aware via the global temperament/reference settings.
"""

from __future__ import annotations

import numpy as np

from pygmu2_tpu_torch.utils.temperament import (
    Temperament,
    get_reference_frequency,
    get_temperament,
)


def pitch_to_freq(
    pitch,
    temperament: Temperament | None = None,
    reference_pitch: float | None = None,
    reference_freq: float | None = None,
) -> np.ndarray:
    """Pitch number(s) → frequency in Hz using the active temperament."""
    temp = temperament if temperament is not None else get_temperament()
    def_freq, def_pitch = get_reference_frequency()
    return temp.pitch_to_freq(
        pitch,
        reference_pitch=def_pitch if reference_pitch is None else reference_pitch,
        reference_freq=def_freq if reference_freq is None else reference_freq,
    )


def freq_to_pitch(
    freq,
    temperament: Temperament | None = None,
    reference_pitch: float | None = None,
    reference_freq: float | None = None,
) -> np.ndarray:
    """Frequency in Hz → pitch number(s) using the active temperament."""
    temp = temperament if temperament is not None else get_temperament()
    def_freq, def_pitch = get_reference_frequency()
    return temp.freq_to_pitch(
        freq,
        reference_pitch=def_pitch if reference_pitch is None else reference_pitch,
        reference_freq=def_freq if reference_freq is None else reference_freq,
    )


def ratio_to_db(ratio) -> np.ndarray:
    """Amplitude ratio → decibels (20·log10)."""
    ratio = np.maximum(np.asarray(ratio, dtype=np.float64), 1e-10)
    return 20.0 * np.log10(ratio)


def db_to_ratio(db) -> np.ndarray:
    """Decibels → amplitude ratio."""
    return 10.0 ** (np.asarray(db, dtype=np.float64) / 20.0)


def semitones_to_ratio(semitones, temperament: Temperament | None = None) -> np.ndarray:
    """Interval in scale degrees → frequency ratio (temperament-aware)."""
    temp = temperament if temperament is not None else get_temperament()
    return temp.interval_to_ratio(semitones)


def ratio_to_semitones(ratio, temperament: Temperament | None = None) -> np.ndarray:
    """Frequency ratio → interval in scale degrees (temperament-aware)."""
    temp = temperament if temperament is not None else get_temperament()
    return temp.ratio_to_interval(ratio)


def samples_to_seconds(samples, sample_rate: float) -> np.ndarray:
    """Sample count(s) → seconds."""
    return np.asarray(samples, dtype=np.float64) / float(sample_rate)


def seconds_to_samples(seconds, sample_rate: float) -> np.ndarray:
    """Seconds → sample count(s), rounded to nearest integer."""
    return np.asarray(
        np.round(np.asarray(seconds, dtype=np.float64) * float(sample_rate)),
        dtype=np.int64,
    )
