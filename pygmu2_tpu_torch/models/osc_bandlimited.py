"""Band-limited oscillators: BlitSawPE, SuperSawPE, AnalogOscPE.

Counterparts of ``pygmu2_tpu.models.osc_bandlimited``:

- BlitSawPE (reference: src/pygmu2/blit_saw_pe.py:25-299): a
  Dirichlet-kernel BLIT integrated by a leaky one-pole. The integrator is
  a linear recurrence, so it runs as the doubling affine scan
  (``ops/linrec.affine_scan_1``), and the phase accumulates by a float64
  prefix sum (``ops/phase.prefix_sum``) — no per-sample loop.
- SuperSawPE (reference: src/pygmu2/super_saw_pe.py:25-342): N detuned
  BLIT saws as one (T, voices) batch: one float64 prefix sum of the base
  increment, scaled by each voice's detune ratio, the integrator scanned
  over (T, V), the voices mixed by their gains.
- AnalogOscPE (reference: src/pygmu2/analog_osc_pe.py:34-267): polyBLEP
  rectangle and duty-morphed saw/triangle (integrated slope with BLEP
  residuals; the integral is a prefix sum). A constant frequency and duty
  make it pure, its phase a function of the absolute sample index; a PE
  parameter makes it stateful, its phase a prefix sum of the increments.
"""

from __future__ import annotations

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.ops.linrec import affine_scan_1
from pygmu2_tpu_torch.ops.phase import prefix_sum
from pygmu2_tpu_torch.ops.trig import dirichlet_blit


def _param_extent(pe, params) -> Extent:
    ext = Extent(None, None)
    for p in params:
        if isinstance(p, ProcessingElement):
            ext = ext.intersection(p.extent())
    return ext


class BlitSawPE(ProcessingElement):
    """Band-limited sawtooth via BLIT + leaky integrator."""

    def __init__(
        self,
        frequency,
        amplitude=1.0,
        initial_phase: float = 0.0,
        m=None,
        leak: float = 0.999,
        channels: int = 1,
    ):
        self._frequency = frequency
        self._amplitude = amplitude
        self._initial_phase = float(np.asarray(initial_phase).reshape(-1)[0]) % 1.0
        self._m = m
        self._leak = leak
        self._channels = channels

    @property
    def frequency(self):
        return self._frequency

    @property
    def amplitude(self):
        return self._amplitude

    @property
    def m(self):
        return self._m

    @property
    def leak(self) -> float:
        return self._leak

    @property
    def initial_phase(self) -> float:
        return self._initial_phase

    def inputs(self) -> list[ProcessingElement]:
        return [
            p
            for p in (self._frequency, self._amplitude, self._m)
            if isinstance(p, ProcessingElement)
        ]

    def is_pure(self) -> bool:
        return False  # integrator state

    def channel_count(self) -> int:
        return self._channels

    def _compute_extent(self) -> Extent:
        return _param_extent(self, (self._frequency, self._amplitude, self._m))

    def _blit(self, ctx, freq, phase):
        """Dirichlet-kernel band-limited impulse train (AC-coupled); the
        folding runs wide, the two sins float32 (ops/trig.py)."""
        sr = ctx.sample_rate
        if self._m is None:
            m = torch.floor(sr / (2.0 * freq.clamp(min=1.0)))
            m = m - (1.0 - torch.remainder(m, 2.0))  # force odd
            m = m.clamp(min=1.0)
        else:
            m_vals = ctx.param(self._m, dtype=prec.WIDE)
            m = torch.floor(m_vals).clamp(min=1.0)
        P = sr / freq.clamp(min=1.0)
        return dirichlet_blit(phase, m, P)

    def _trace(self, ctx):
        freq = ctx.param(self._frequency, dtype=prec.WIDE)
        amp = ctx.param(self._amplitude, dtype=prec.AUDIO)
        inc = freq / ctx.sample_rate

        st, _ = ctx.state(
            self,
            init=lambda: {
                "phase": torch.full((), self._initial_phase, dtype=prec.WIDE, device=ctx.device),
                "integ": torch.zeros((), dtype=prec.AUDIO, device=ctx.device),
            },
        )
        # Phase accumulates wide (drift-free over hours); the leaky
        # integrator runs float32 (leak=0.999 bounds its memory to ~1e3
        # samples).
        phase = torch.remainder(st["phase"] + prefix_sum(inc), 1.0)
        blit_ac = self._blit(ctx, freq, phase)

        # Leaky integrator y[n] = blit[n] + leak·y[n−1] — parallel scan.
        saw = affine_scan_1(torch.full_like(blit_ac, self._leak), blit_ac, st["integ"])
        ctx.set_state(self, {"phase": phase[-1], "integ": saw[-1]})

        samples = (saw * 2.0 * amp).to(prec.AUDIO)[:, None]
        if self._channels > 1:
            samples = samples.repeat(1, self._channels)
        return samples

    def __repr__(self) -> str:
        def s(p):
            return type(p).__name__ if isinstance(p, ProcessingElement) else str(p)

        m = "auto" if self._m is None else s(self._m)
        return (
            f"BlitSawPE(frequency={s(self._frequency)}, amplitude={s(self._amplitude)}, "
            f"m={m}, leak={self._leak}, channels={self._channels})"
        )


class SuperSawPE(ProcessingElement):
    """N detuned BLIT saws, vectorized as one (time, voices) batch."""

    MIX_EQUAL = "equal"
    MIX_CENTER_HEAVY = "center_heavy"
    MIX_LINEAR = "linear"

    def __init__(
        self,
        frequency,
        amplitude=1.0,
        voices: int = 7,
        detune_cents: float = 20.0,
        mix_mode: str = "center_heavy",
        channels: int = 1,
        randomize_phase: bool = True,
        seed: int | None = None,
        leak: float = 0.999,
    ):
        self._frequency = frequency
        self._amplitude = amplitude
        self._voices = max(1, voices)
        self._detune_cents = detune_cents
        self._mix_mode = mix_mode
        self._channels = channels
        self._leak = leak
        self._detune_ratios = self._compute_detune_ratios()
        self._mix_gains = self._compute_mix_gains()
        rng = np.random.default_rng(seed)
        self._init_phases = (
            rng.random(len(self._detune_ratios))
            if randomize_phase
            else np.zeros(len(self._detune_ratios))
        )

    @property
    def frequency(self):
        return self._frequency

    @property
    def amplitude(self):
        return self._amplitude

    @property
    def voices(self) -> int:
        return self._voices

    @property
    def detune_cents(self) -> float:
        return self._detune_cents

    @property
    def mix_mode(self) -> str:
        return self._mix_mode

    def _compute_detune_ratios(self) -> np.ndarray:
        if self._voices == 1 or self._detune_cents == 0:
            return np.array([1.0])
        cents = np.linspace(-self._detune_cents, self._detune_cents, self._voices)
        return 2.0 ** (cents / 1200.0)

    def _compute_mix_gains(self) -> np.ndarray:
        n = len(self._detune_ratios)
        if n == 1:
            return np.array([1.0])
        gains = np.ones(n, dtype=np.float64)
        if self._mix_mode == self.MIX_EQUAL:
            pass
        elif self._mix_mode == self.MIX_LINEAR:
            center = (n - 1) / 2.0
            d = np.abs(np.arange(n) - center)
            gains = 0.5 + 0.5 * (1.0 - d / d.max())
        elif self._mix_mode == self.MIX_CENTER_HEAVY:
            gains[:] = 0.5
            if n % 2 == 1:
                gains[n // 2] = 1.0
            else:
                gains[n // 2 - 1] = 1.0
                gains[n // 2] = 1.0
        else:
            raise ValueError(f"Unknown mix mode: {self._mix_mode}")
        return gains / np.sqrt(np.sum(gains**2))

    def inputs(self) -> list[ProcessingElement]:
        return [
            p
            for p in (self._frequency, self._amplitude)
            if isinstance(p, ProcessingElement)
        ]

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int:
        return self._channels

    def _compute_extent(self) -> Extent:
        return _param_extent(self, (self._frequency, self._amplitude))

    def _tables(self, device):
        """Detune ratios (float64), mix gains (float32) and initial phases
        (float64) on ``device``, copied there once."""
        cache = self.__dict__.setdefault("_on_device", {})
        if device not in cache:
            cache[device] = tuple(
                torch.from_numpy(np.asarray(v, dt)).to(device)
                for v, dt in ((self._detune_ratios, np.float64), (self._mix_gains, np.float32),
                              (self._init_phases, np.float64))
            )
        return cache[device]

    def _trace(self, ctx):
        sr = ctx.sample_rate
        freq = ctx.param(self._frequency, dtype=prec.WIDE)  # (T,)
        amp = ctx.param(self._amplitude, dtype=prec.AUDIO)
        ratios, gains, init_phases = self._tables(ctx.device)
        V = ratios.shape[0]

        st, _ = ctx.state(
            self,
            init=lambda: {
                "phase": init_phases.clone(),
                "integ": torch.zeros((V,), dtype=prec.AUDIO, device=ctx.device),
            },
        )
        # One float64 prefix sum of the base increment; each voice's phase
        # is it scaled by the voice's detune ratio (the sum distributes).
        cum = prefix_sum(freq / sr)  # (T,) f64
        phase = torch.remainder(st["phase"][None, :] + cum[:, None] * ratios[None, :], 1.0)

        # Per-voice BLIT (auto harmonic count, all voices share the rule).
        fv = torch.clamp(freq[:, None] * ratios[None, :], min=1.0)
        m_f = sr / (2.0 * fv)
        m = torch.clamp(torch.floor(m_f) - (1.0 - torch.remainder(torch.floor(m_f), 2.0)),
                        min=1.0)
        P = sr / fv
        blit = dirichlet_blit(phase, m, P)

        saw = affine_scan_1(torch.full_like(blit, self._leak), blit, st["integ"])  # (T, V)
        ctx.set_state(self, {"phase": phase[-1], "integ": saw[-1]})

        mixed = (saw * 2.0) @ gains  # (T,)
        out = (mixed * amp).to(prec.AUDIO)[:, None]
        if self._channels > 1:
            out = out.repeat(1, self._channels)
        return out

    def __repr__(self) -> str:
        return (
            f"SuperSawPE(voices={self._voices}, detune_cents={self._detune_cents}, "
            f"mix_mode={self._mix_mode})"
        )


def _exclusive_prefix_sum(x):
    """``concat([0], cumsum(x[:-1]))``: the sum of the steps before each
    sample, in XLA's prefix-sum order."""
    head = torch.zeros((1,), dtype=x.dtype, device=x.device)
    return torch.cat([head, prefix_sum(x[:-1])]) if x.shape[0] > 1 else head


class AnalogOscPE(ProcessingElement):
    """polyBLEP rectangle / duty-morphed saw-triangle."""

    WAVE_RECTANGLE = "rectangle"
    WAVE_SAWTOOTH = "sawtooth"

    def __init__(
        self,
        frequency=440.0,
        duty_cycle=0.5,
        waveform: str = "rectangle",
        channels: int = 1,
    ):
        self._frequency = frequency
        self._duty_cycle = duty_cycle
        self._waveform = str(waveform).lower()
        self._channels = int(channels)
        if self._waveform not in (self.WAVE_RECTANGLE, self.WAVE_SAWTOOTH):
            raise ValueError(
                f"waveform must be 'rectangle' or 'sawtooth', got {waveform!r}"
            )
        if self._channels < 1:
            raise ValueError(f"channels must be >= 1, got {channels}")

    @property
    def frequency(self):
        return self._frequency

    @property
    def duty_cycle(self):
        return self._duty_cycle

    @property
    def waveform(self) -> str:
        return self._waveform

    def inputs(self) -> list[ProcessingElement]:
        return [
            p
            for p in (self._frequency, self._duty_cycle)
            if isinstance(p, ProcessingElement)
        ]

    def is_pure(self) -> bool:
        return not self.inputs()

    def channel_count(self) -> int:
        return self._channels

    def _compute_extent(self) -> Extent:
        return _param_extent(self, (self._frequency, self._duty_cycle))

    @staticmethod
    def _blep(t, dt):
        """4-point polyBLEP residual for a step at phase 0."""
        dt = torch.clamp(dt, min=1e-12)
        x = t / dt
        u = 2.0 - x
        y = torch.where(t < 2.0 * dt, u**4, 0.0)
        v = 1.0 - x
        y = y - torch.where(t < dt, 4.0 * v**4, 0.0)
        return y / 12.0

    @classmethod
    def _blep_residual(cls, t, dt):
        t = torch.remainder(t, 1.0)
        return cls._blep(t, dt) - cls._blep(1.0 - t, dt)

    @staticmethod
    def _saw_value(phase0, a):
        return torch.where(
            phase0 < a,
            -1.0 + 2.0 * (phase0 / a),
            1.0 - 2.0 * ((phase0 - a) / (1.0 - a)),
        )

    def _trace(self, ctx):
        sr = ctx.sample_rate
        freq = ctx.param(self._frequency, dtype=prec.WIDE)
        duty = ctx.param(self._duty_cycle, dtype=prec.WIDE)
        dt = freq / sr
        dt_blep = torch.clamp(dt.abs(), 1e-12, 0.5)
        edge = torch.clamp(2.0 * dt_blep, min=1e-5)
        duty = torch.minimum(torch.maximum(duty, edge), 1.0 - edge)

        if self.is_pure():
            idx = ctx.times(prec.WIDE)
            phase = torch.remainder(idx * dt[0], 1.0)
            saw0 = None
        else:
            st, _ = ctx.state(
                self,
                init=lambda: {
                    "phase": torch.zeros((), dtype=prec.WIDE, device=ctx.device),
                    "saw": torch.full((), -1.0, dtype=prec.WIDE, device=ctx.device),
                },
            )
            phase = torch.remainder(st["phase"] + _exclusive_prefix_sum(dt), 1.0)
            saw0 = st["saw"]

        if self._waveform == self.WAVE_RECTANGLE:
            base = torch.where(phase < duty, 1.0, -1.0).to(prec.WIDE)
            y = (
                base
                + self._blep_residual(phase, dt_blep)
                - self._blep_residual(phase - duty, dt_blep)
            )
            if not self.is_pure():
                ctx.set_state(
                    self,
                    {"phase": torch.remainder(st["phase"] + dt.sum(), 1.0), "saw": st["saw"]},
                )
        else:
            a = 1.0 - duty
            u1 = 2.0 / a
            u2 = -2.0 / (1.0 - a)
            u = torch.where(phase < a, u1, u2)
            delta = u2 - u1
            u_corr = (
                u
                + (-0.5 * delta) * self._blep_residual(phase, dt_blep)
                + (0.5 * delta) * self._blep_residual(phase - a, dt_blep)
            )
            dy = u_corr * dt
            y0 = self._saw_value(phase[0], a[0]) if self.is_pure() else saw0
            y = y0 + _exclusive_prefix_sum(dy)
            if not self.is_pure():
                ctx.set_state(
                    self,
                    {
                        "phase": torch.remainder(st["phase"] + dt.sum(), 1.0),
                        "saw": y0 + dy.sum(),
                    },
                )

        out = y.to(prec.AUDIO)[:, None]
        if self._channels > 1:
            out = out.repeat(1, self._channels)
        return out

    def __repr__(self) -> str:
        return (
            f"AnalogOscPE(waveform={self._waveform!r}, channels={self._channels})"
        )
