"""Musical temperament system.

Counterpart of ``pygmu2_tpu.utils.temperament``, copied verbatim (it is
numpy only) so the port never imports the JAX package (reference:
src/pygmu2/temperament.py:17-667): Temperament ABC, EqualTemperament,
JustIntonation (log-space interpolation of fractional scale degrees),
PythagoreanTuning, CustomTemperament, plus the module-level globals
(default temperament, reference frequency/pitch, historical presets).
The port keeps its own globals: setting them here leaves the JAX
package's untouched, and the other way round.

All math is vectorized numpy float64 (host-side; these feed PE parameters
at graph construction time). Where the reference looped per element
(JI freq→pitch nearest-ratio search), this uses broadcast argmin.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


class Temperament(ABC):
    """Maps pitch numbers ↔ frequencies and intervals ↔ ratios."""

    @abstractmethod
    def pitch_to_freq(self, pitch, reference_pitch: float = 69.0, reference_freq: float = 440.0) -> np.ndarray:
        """Pitch number(s) (fractional OK) → frequency in Hz."""

    @abstractmethod
    def freq_to_pitch(self, freq, reference_pitch: float = 69.0, reference_freq: float = 440.0) -> np.ndarray:
        """Frequency in Hz → pitch number(s)."""

    @abstractmethod
    def interval_to_ratio(self, interval) -> np.ndarray:
        """Interval in scale degrees → frequency ratio."""

    @abstractmethod
    def ratio_to_interval(self, ratio) -> np.ndarray:
        """Frequency ratio → interval in scale degrees."""

    @abstractmethod
    def name(self) -> str:
        """Human-readable name."""


class EqualTemperament(Temperament):
    """N equal divisions of the octave (default 12-ET)."""

    def __init__(self, divisions: int = 12):
        if divisions < 1:
            raise ValueError(f"Divisions must be positive, got {divisions}")
        self._divisions = divisions

    @property
    def divisions(self) -> int:
        return self._divisions

    def pitch_to_freq(self, pitch, reference_pitch=69.0, reference_freq=440.0):
        pitch = np.asarray(pitch, dtype=np.float64)
        return reference_freq * 2.0 ** ((pitch - reference_pitch) / self._divisions)

    def freq_to_pitch(self, freq, reference_pitch=69.0, reference_freq=440.0):
        freq = np.maximum(np.asarray(freq, dtype=np.float64), 1e-10)
        return reference_pitch + self._divisions * np.log2(freq / reference_freq)

    def interval_to_ratio(self, interval):
        return 2.0 ** (np.asarray(interval, dtype=np.float64) / self._divisions)

    def ratio_to_interval(self, ratio):
        ratio = np.maximum(np.asarray(ratio, dtype=np.float64), 1e-10)
        return self._divisions * np.log2(ratio)

    def name(self) -> str:
        return f"{self._divisions}-tone Equal Temperament ({self._divisions}-ET)"

    def __repr__(self) -> str:
        return f"EqualTemperament(divisions={self._divisions})"


# 5-limit just intonation ratio table (major scale, pure 3/2 and 5/4).
_JI_5_LIMIT = (
    1.0, 16 / 15, 9 / 8, 6 / 5, 5 / 4, 4 / 3, 45 / 32, 3 / 2, 8 / 5, 5 / 3, 9 / 5, 15 / 8,
)

# Pythagorean: every interval built from stacked pure 3:2 fifths.
_PYTHAGOREAN = (
    1.0, 256 / 243, 9 / 8, 32 / 27, 81 / 64, 4 / 3, 1024 / 729, 3 / 2, 128 / 81,
    27 / 16, 16 / 9, 243 / 128,
)


class JustIntonation(Temperament):
    """Ratio-table tuning anchored at ``reference_pitch``.

    Fractional pitches/intervals interpolate linearly in log-frequency
    space; octave transposition is exact powers of two.
    """

    def __init__(self, ratios=None, reference_pitch: float = 60.0):
        if ratios is None:
            self._ratios = np.array(_JI_5_LIMIT, dtype=np.float64)
        else:
            self._ratios = np.asarray(ratios, dtype=np.float64)
            if len(self._ratios) < 2:
                raise ValueError("Need at least 2 ratios (including unison)")
            if not np.isclose(self._ratios[0], 1.0):
                raise ValueError("First ratio must be 1.0 (unison)")
        self._reference_pitch = reference_pitch
        self._num_notes = len(self._ratios)

    @property
    def ratios(self) -> np.ndarray:
        return self._ratios.copy()

    @property
    def num_notes(self) -> int:
        return self._num_notes

    def _interp_ratio(self, scale_degrees) -> np.ndarray:
        """Ratio for (possibly fractional) scale degrees in [0, num_notes).

        Shape-preserving: scalar in → 0-d out (so ``float(...)`` on the
        result stays legal under NumPy ≥ 1.25).
        """
        deg = np.asarray(scale_degrees, dtype=np.float64)
        lo = np.floor(deg).astype(int) % self._num_notes
        frac = deg - np.floor(deg)
        hi = (lo + 1) % self._num_notes
        r_lo = self._ratios[lo]
        r_hi = self._ratios[hi]
        # Crossing the octave boundary interpolates toward 2× unison.
        r_hi = np.where((lo == self._num_notes - 1) & (frac > 0), r_hi * 2.0, r_hi)
        return 2.0 ** (np.log2(r_lo) * (1 - frac) + np.log2(r_hi) * frac)

    def _split(self, relative_pitch):
        octaves = np.floor(relative_pitch / self._num_notes)
        return octaves, relative_pitch - octaves * self._num_notes

    def _ratio_from_reference(self, pitch):
        octaves, degree = self._split(np.asarray(pitch, np.float64) - self._reference_pitch)
        return self._interp_ratio(degree) * 2.0 ** octaves

    def pitch_to_freq(self, pitch, reference_pitch=69.0, reference_freq=440.0):
        base_freq = reference_freq / self._ratio_from_reference(reference_pitch)
        return base_freq * self._ratio_from_reference(pitch)

    def freq_to_pitch(self, freq, reference_pitch=69.0, reference_freq=440.0):
        freq = np.maximum(np.asarray(freq, dtype=np.float64), 1e-10)
        base_freq = reference_freq / self._ratio_from_reference(reference_pitch)
        ratio = freq / base_freq
        octaves = np.floor(np.log2(ratio))
        in_octave = ratio / 2.0 ** octaves
        # Nearest table entry (broadcast; the mapping is approximate by design).
        idx = np.argmin(np.abs(self._ratios - in_octave[..., None]), axis=-1)
        return self._reference_pitch + octaves * self._num_notes + idx

    def interval_to_ratio(self, interval):
        octaves, degree = self._split(np.asarray(interval, dtype=np.float64))
        return self._interp_ratio(degree) * 2.0 ** octaves

    def ratio_to_interval(self, ratio):
        ratio = np.maximum(np.asarray(ratio, dtype=np.float64), 1e-10)
        octaves = np.floor(np.log2(ratio))
        in_octave = ratio / 2.0 ** octaves
        idx = np.argmin(np.abs(self._ratios - in_octave[..., None]), axis=-1)
        return octaves * self._num_notes + idx

    def name(self) -> str:
        return f"Just Intonation ({self._num_notes} notes)"

    def __repr__(self) -> str:
        return (
            f"JustIntonation(num_notes={self._num_notes}, "
            f"reference_pitch={self._reference_pitch})"
        )


class PythagoreanTuning(JustIntonation):
    """3-limit tuning: all intervals from stacked pure 3:2 fifths."""

    def __init__(self, reference_pitch: float = 60.0):
        super().__init__(ratios=list(_PYTHAGOREAN), reference_pitch=reference_pitch)

    def name(self) -> str:
        return "Pythagorean Tuning"

    def __repr__(self) -> str:
        return f"PythagoreanTuning(reference_pitch={self._reference_pitch})"


class CustomTemperament(Temperament):
    """User-supplied conversion callables."""

    def __init__(
        self,
        pitch_to_freq_func,
        freq_to_pitch_func,
        interval_to_ratio_func,
        ratio_to_interval_func,
        name: str = "Custom Temperament",
    ):
        self._p2f = pitch_to_freq_func
        self._f2p = freq_to_pitch_func
        self._i2r = interval_to_ratio_func
        self._r2i = ratio_to_interval_func
        self._name = name

    def pitch_to_freq(self, pitch, reference_pitch=69.0, reference_freq=440.0):
        return np.asarray(self._p2f(pitch, reference_pitch, reference_freq), dtype=np.float64)

    def freq_to_pitch(self, freq, reference_pitch=69.0, reference_freq=440.0):
        return np.asarray(self._f2p(freq, reference_pitch, reference_freq), dtype=np.float64)

    def interval_to_ratio(self, interval):
        return np.asarray(self._i2r(interval), dtype=np.float64)

    def ratio_to_interval(self, ratio):
        return np.asarray(self._r2i(ratio), dtype=np.float64)

    def name(self) -> str:
        return self._name

    def __repr__(self) -> str:
        return f"CustomTemperament(name='{self._name}')"


# ---- module-level defaults ---------------------------------------------

_temperament: Temperament = EqualTemperament(12)
_reference_freq: float = 440.0
_reference_pitch: float = 69.0


def set_temperament(temperament: Temperament) -> None:
    """Set the global default temperament."""
    global _temperament
    _temperament = temperament


def get_temperament() -> Temperament:
    """The global default temperament (12-ET unless changed)."""
    return _temperament


def set_reference_frequency(freq: float, pitch: float = 69.0) -> None:
    """Set the global reference frequency (and the pitch it anchors)."""
    global _reference_freq, _reference_pitch
    if freq <= 0:
        raise ValueError(f"Reference frequency must be positive, got {freq}")
    _reference_freq = float(freq)
    _reference_pitch = float(pitch)


def get_reference_frequency() -> tuple[float, float]:
    """(reference_freq, reference_pitch)."""
    return (_reference_freq, _reference_pitch)


def set_concert_pitch() -> None:
    """A4 = 440 Hz (ISO 16, the default)."""
    set_reference_frequency(440.0, 69.0)


def set_verdi_tuning() -> None:
    """A4 = 432 Hz."""
    set_reference_frequency(432.0, 69.0)


def set_baroque_pitch() -> None:
    """A4 = 415 Hz."""
    set_reference_frequency(415.0, 69.0)
