"""Nonlinear sequential DSP: LadderPE, CombPE, KarplusStrongPE.

Counterpart of ``pygmu2_tpu.models.physical``:
- LadderPE (reference: src/pygmu2/ladder_pe.py:31-625) — Moog ladder
  virtual-analog: 4 cascaded one-pole stages with trapezoidal
  0.769/0.231 weighting, tanh feedback saturation, polynomial
  alpha/q_adjust coefficients, 2× oversampling with input interpolation,
  silence state-decay, 6 response modes.
- CombPE   (reference: src/pygmu2/comb_pe.py:26-349) — feedback comb
  ``y[n] = x[n] + fb·y[n−delay]`` with delay = one period of the target
  frequency, one-pole frequency smoothing, fb clamp ±0.995.
- KarplusStrongPE (reference: src/pygmu2/karplus_strong_pe.py:61-220) —
  plucked string: one-period delay line + fractional-delay first-order
  allpass, seeded noise excitation, optional two-phase decay.

The per-sample coefficient math runs as plain tensor ops; the nonlinear
recurrences run in ``ops/ladder.ladder_scan``, ``ops/comb.comb_scan`` and
``ops/ks.ks_scan`` (a hand-written kernel on the card) for every channel
count, modulated or constant parameters alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement, SourcePE
from pygmu2_tpu_torch.models.modes import LadderMode
from pygmu2_tpu_torch.ops import comb as _comb
from pygmu2_tpu_torch.ops import ks as _ks
from pygmu2_tpu_torch.ops import ladder as _ladder

_LADDER_MODE_INDEX = {
    LadderMode.LP24: 0,
    LadderMode.LP12: 1,
    LadderMode.BP24: 2,
    LadderMode.BP12: 3,
    LadderMode.HP24: 4,
    LadderMode.HP12: 5,
}


def rho_for_decay_db(
    seconds: float,
    frequency: float,
    sample_rate: int,
    db: float = -60.0,
) -> float:
    """Feedback gain rho so a Karplus-Strong pluck decays |db| dB over
    ``seconds``. Accounts for the two-point average's cos(π/N) loss at the
    fundamental (reference: karplus_strong_pe.py:22-58)."""
    n = sample_rate / frequency
    target = 10.0 ** (db / (20.0 * seconds * frequency))
    rho = target / math.cos(math.pi / n)
    return min(rho, 1.0)


def _column(values, T: int) -> torch.Tensor:
    """A (T,) contiguous float32 column of per-sample values."""
    return values.to(torch.float32).expand(T).contiguous()


class LadderPE(ProcessingElement):
    """Moog-style ladder filter with tanh feedback and oversampling."""

    def state_decays(self) -> bool:
        return True  # stable nonlinear IIR: state decays by _STATE_DECAY

    _DEFAULT_OVERSAMPLE = 2
    _RESONANCE_MULTIPLIER = 1.8
    _STATE_DECAY = 0.95
    _INPUT_THRESHOLD = 1e-5

    def __init__(
        self,
        source: ProcessingElement,
        frequency,
        resonance=0.0,
        mode: LadderMode = LadderMode.LP24,
        drive=1.0,
        passband_gain: float = 0.5,
        oversample: int = _DEFAULT_OVERSAMPLE,
    ):
        self._source = source
        self._frequency = frequency
        self._resonance = resonance
        self._mode = mode
        self._drive = drive
        self._passband_gain = float(np.clip(passband_gain, 0.0, 0.5))
        self._oversample = max(1, int(oversample))

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def frequency(self):
        return self._frequency

    @property
    def resonance(self):
        return self._resonance

    @property
    def drive(self):
        return self._drive

    @property
    def mode(self) -> LadderMode:
        return self._mode

    @property
    def passband_gain(self) -> float:
        return self._passband_gain

    @property
    def oversample(self) -> int:
        return self._oversample

    def _fills_own_edges(self) -> bool:
        # IIR state rings past the source extent: the reference keeps
        # filtering the zero-padded input through its carried state, so
        # the decay tail is audible. Opt out of the engine's zero-fill.
        return True

    def inputs(self) -> list[ProcessingElement]:
        out = [self._source]
        for p in (self._frequency, self._resonance, self._drive):
            if isinstance(p, ProcessingElement):
                out.append(p)
        return out

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        ext = self._source.extent()
        for p in (self._frequency, self._resonance, self._drive):
            if isinstance(p, ProcessingElement):
                ext = ext.intersection(p.extent()) or ext
        return ext

    def _trace(self, ctx):
        x = ctx.pull(self._source)  # (T, C)
        T, C = x.shape
        sr = float(ctx.sample_rate)
        os_n = self._oversample
        pbg = self._passband_gain

        # --- per-sample coefficients (parallel over T) ---
        freq = ctx.param(self._frequency, dtype=prec.AUDIO)
        nyq = sr / 2.0
        cutoff = freq.clamp(5.0, min(nyq * 0.85, nyq - 1.0))
        wc = cutoff * (2.0 * math.pi) / (sr * os_n)
        wc2 = wc * wc
        alpha = 0.9892 * wc - 0.4324 * wc2 + 0.1381 * wc2 * wc - 0.0202 * wc2 * wc2
        q_adjust = 1.006 + 0.0536 * wc - 0.095 * wc2 - 0.05 * wc2 * wc2

        res = ctx.param(self._resonance, dtype=prec.AUDIO).clamp(0.0, 1.0)
        k = 4.0 * res * self._RESONANCE_MULTIPLIER

        drv = ctx.param(self._drive, dtype=prec.AUDIO).clamp(0.0, 4.0)
        drive_scaled = torch.where(drv > 1.0, 1.0 + (drv - 1.0) * (1.0 - pbg), drv)

        # the JAX package's state layout: per-stage (C,) leaves
        zeros = lambda: torch.zeros((C,), dtype=prec.AUDIO, device=ctx.device)  # noqa: E731
        st, _ = ctx.state(
            self,
            init=lambda: {
                "z0": tuple(zeros() for _ in range(4)),
                "z1": tuple(zeros() for _ in range(4)),
                "old": zeros(),
            },
        )
        st9 = torch.cat([torch.stack(st["z0"]), torch.stack(st["z1"]), st["old"][None]])
        y, new9 = _ladder.ladder_scan(
            x.to(torch.float32), _column(alpha, T), _column(q_adjust, T),
            _column(k, T), _column(drive_scaled, T), st9,
            os_n=os_n, pbg=float(pbg), mode_index=_LADDER_MODE_INDEX[self._mode],
            input_threshold=float(self._INPUT_THRESHOLD),
            state_decay=float(self._STATE_DECAY),
        )
        ctx.set_state(
            self,
            {
                "z0": tuple(new9[i] for i in range(4)),
                "z1": tuple(new9[4 + i] for i in range(4)),
                "old": new9[8],
            },
        )
        return y

    def __repr__(self) -> str:
        return (
            f"LadderPE(source={type(self._source).__name__}, mode={self._mode.value}, "
            f"oversample={self._oversample})"
        )


class CombPE(ProcessingElement):
    """Feedback comb tuned to a (possibly modulated) frequency."""

    def state_decays(self) -> bool:
        return True  # feedback < 1: delay-line contents decay geometrically

    _MAX_FEEDBACK = 0.995

    def __init__(
        self,
        source: ProcessingElement,
        frequency,
        feedback=0.0,
        min_frequency: float = 20.0,
        smoothing_samples: int = 2400,
    ):
        self._source = source
        self._frequency = frequency
        self._feedback = feedback
        self._min_frequency = max(1.0, float(min_frequency))
        self._smoothing_samples = max(1, int(smoothing_samples))

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def frequency(self):
        return self._frequency

    @property
    def feedback(self):
        return self._feedback

    def _fills_own_edges(self) -> bool:
        # IIR state rings past the source extent: the reference keeps
        # filtering the zero-padded input through its carried state, so
        # the decay tail is audible. Opt out of the engine's zero-fill.
        return True

    def inputs(self) -> list[ProcessingElement]:
        out = [self._source]
        for p in (self._frequency, self._feedback):
            if isinstance(p, ProcessingElement):
                out.append(p)
        return out

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        ext = self._source.extent()
        for p in (self._frequency, self._feedback):
            if isinstance(p, ProcessingElement):
                ext = ext.intersection(p.extent()) or ext
        return ext

    def _trace(self, ctx):
        x = ctx.pull(self._source)  # (T, C)
        T, C = x.shape
        sr = float(ctx.sample_rate)
        L = max(2, int(math.ceil(sr / self._min_frequency)) + 1)

        freq = ctx.param(self._frequency, dtype=prec.AUDIO).clamp(min=self._min_frequency)
        fb = torch.nan_to_num(ctx.param(self._feedback, dtype=prec.AUDIO)).clamp(
            -self._MAX_FEEDBACK, self._MAX_FEEDBACK
        )
        st, _ = ctx.state(
            self,
            init=lambda: {
                "buf": torch.zeros((L, C), dtype=prec.AUDIO, device=ctx.device),
                "pos": torch.zeros((), dtype=torch.int32, device=ctx.device),
                "sf": torch.full((), -1.0, dtype=prec.AUDIO, device=ctx.device),
            },
        )
        # A constant frequency takes the same kernel: its smoother is a
        # bitwise fixed point from the first sample, so the JAX package's
        # constant-delay block path (ops/comb_block.py) computes the same.
        y, buf2, pos2, sf2 = _comb.comb_scan(
            x.to(torch.float32), _column(freq, T), _column(fb, T),
            st["buf"], st["pos"], st["sf"],
            L=L, sr=sr, smooth_alpha=1.0 / self._smoothing_samples,
        )
        ctx.set_state(self, {"buf": buf2, "pos": pos2, "sf": sf2})
        return y

    def __repr__(self) -> str:
        return f"CombPE(source={type(self._source).__name__})"


class KarplusStrongPE(SourcePE):
    """Plucked string: noise-filled delay line with averaging feedback and
    a fractional-delay allpass. Extent (0, ∞); crop to taste."""

    def __init__(
        self,
        frequency: float,
        rho: float = 0.996,
        duration: int | None = None,
        rho_damping: float | None = None,
        amplitude: float = 0.3,
        seed: int | None = None,
        channels: int = 1,
    ):
        if frequency <= 0:
            raise ValueError(f"frequency must be positive, got {frequency}")
        if not (0 < rho <= 1.0):
            raise ValueError(f"rho must be in (0, 1], got {rho}")
        if amplitude <= 0:
            raise ValueError(f"amplitude must be positive, got {amplitude}")
        two_phase = duration is not None and rho_damping is not None
        if two_phase:
            if duration < 0:
                raise ValueError(f"duration must be >= 0, got {duration}")
            if not (0 < rho_damping <= 1.0):
                raise ValueError(f"rho_damping must be in (0, 1], got {rho_damping}")
        self._frequency = float(frequency)
        self._rho = float(rho)
        self._duration_param = duration if two_phase else None
        self._rho_damping = float(rho_damping) if two_phase else None
        self._amplitude = float(amplitude)
        self._seed = seed
        self._channels = channels

    @property
    def frequency(self) -> float:
        return self._frequency

    @property
    def rho(self) -> float:
        return self._rho

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int:
        return self._channels

    def _compute_extent(self) -> Extent:
        return Extent(0, None)

    def _excitation(self, delay_len: int) -> np.ndarray:
        rng = np.random.default_rng(self._seed)
        noise = rng.standard_normal(delay_len).astype(np.float32)
        return noise * (self._amplitude / (np.max(np.abs(noise)) + 1e-9))

    def _trace(self, ctx):
        sr = ctx.sample_rate
        delay_float = sr / self._frequency
        delay_len = max(2, int(math.floor(delay_float)))
        frac = min(1.0, max(0.0, delay_float - delay_len))
        allpass_c = (1.0 - frac) / (1.0 + frac)
        dev = ctx.device

        st, _ = ctx.state(
            self,
            init=lambda: {
                # one host-to-card copy, at the first request or a gap only
                "buf": torch.from_numpy(self._excitation(delay_len)).to(dev),
                "r": torch.zeros((), dtype=torch.int32, device=dev),
                "ap_in": torch.zeros((), dtype=torch.float32, device=dev),
                "ap_out": torch.zeros((), dtype=torch.float32, device=dev),
            },
        )
        t = ctx.times()
        if self._duration_param is not None:
            rho_t = torch.where(
                t >= self._duration_param,
                torch.full((), self._rho_damping, dtype=torch.float32, device=dev),
                torch.full((), self._rho, dtype=torch.float32, device=dev),
            )
        else:
            rho_t = torch.full((ctx.duration,), self._rho, dtype=torch.float32, device=dev)
        # A block that starts at t >= 0 is active throughout: with
        # delay_len >= 16 the JAX PE takes its blocked order there
        # (ops/ks_block.py), and so does ks_scan; else the per-sample order.
        y, buf2, r2, ai2, ao2 = _ks.ks_scan(
            rho_t, t >= 0, st["buf"], st["r"], st["ap_in"], st["ap_out"],
            L=delay_len, allpass_c=float(allpass_c), all_active=ctx.start >= 0,
        )
        ctx.set_state(self, {"buf": buf2, "r": r2, "ap_in": ai2, "ap_out": ao2})
        return y[:, None].expand(-1, self._channels)

    def __repr__(self) -> str:
        return (
            f"KarplusStrongPE(frequency={self._frequency}, rho={self._rho}, "
            f"channels={self._channels})"
        )
