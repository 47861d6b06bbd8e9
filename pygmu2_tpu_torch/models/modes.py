"""Shared enums for the PE library (a copy of ``pygmu2_tpu.models.modes``).

Collected in one module (the reference scatters them across PE files; the
names and member values match for API parity — e.g. InterpolationMode at
wavetable_pe.py:19, OutOfBoundsMode :25, NoiseMode noise_pe.py:20,
BiquadMode biquad_pe.py:65, DetectionMode envelope_pe.py:19, DynamicsMode
dynamics_pe.py:21, LadderMode ladder_pe.py:210, SlewMode
slew_limiter_pe.py, SequenceMode sequence_pe.py, WindowMode
window_pe.py:18, TransitionType piecewise_pe.py:21).
"""

from __future__ import annotations

import enum


class InterpolationMode(enum.Enum):
    LINEAR = "linear"
    CUBIC = "cubic"


class OutOfBoundsMode(enum.Enum):
    ZERO = "zero"
    CLAMP = "clamp"
    WRAP = "wrap"


class NoiseMode(enum.Enum):
    WHITE = "white"
    PINK = "pink"
    BROWN = "brown"


class BiquadMode(enum.Enum):
    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    NOTCH = "notch"
    ALLPASS = "allpass"
    PEAKING = "peaking"
    LOWSHELF = "lowshelf"
    HIGHSHELF = "highshelf"


class DetectionMode(enum.Enum):
    PEAK = "peak"
    RMS = "rms"


class DynamicsMode(enum.Enum):
    COMPRESS = "compress"
    EXPAND = "expand"
    LIMIT = "limit"
    GATE = "gate"


class LadderMode(enum.Enum):
    LP24 = "lp24"
    LP12 = "lp12"
    BP24 = "bp24"
    BP12 = "bp12"
    HP24 = "hp24"
    HP12 = "hp12"


class SlewMode(enum.Enum):
    LINEAR = "linear"
    EXPONENTIAL = "exponential"


class SequenceMode(enum.Enum):
    OVERLAP = "overlap"
    NON_OVERLAP = "non_overlap"


class WindowMode(enum.Enum):
    MAX = "max"
    MIN = "min"
    MEAN = "mean"
    RMS = "rms"


class TransitionType(enum.Enum):
    STEP = "step"
    LINEAR = "linear"
    EXPONENTIAL = "exponential"
    SIGMOID = "sigmoid"
    CONSTANT_POWER = "constant_power"


class RandomMode(enum.Enum):
    """RandomPE output shaping (see models/random_control.py)."""

    SAMPLE_HOLD = "sample_hold"
    LINEAR = "linear"
    SMOOTH = "smooth"
    WALK = "walk"
