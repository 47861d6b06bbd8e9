"""Oscillators: SinePE, FunctionGenPE.

Counterpart of ``pygmu2_tpu.models.oscillators`` (reference:
src/pygmu2/sine_pe.py:17, function_gen_pe.py:36-210). Phase math runs
in float64 so long timelines hold the ≤1e-4 parity budget; audio output
is float32. BlitSawPE lives in ``pygmu2_tpu_torch.models.osc_bandlimited``.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.ops import xla_math
from pygmu2_tpu_torch.ops.phase import prefix_sum, wrapped_phase_accum

TWO_PI = 6.283185307179586476925287


class SinePE(ProcessingElement):
    """Sine oscillator; frequency/amplitude/phase each scalar-or-PE.

    Pure (all params constant): phase computed in closed form from the
    absolute sample index — stateless.
    Modulated (any param a PE): instantaneous frequency is integrated with
    a cumulative sum and the end-of-block phase is carried as state.
    """

    def __init__(
        self,
        frequency=440.0,
        amplitude=1.0,
        phase=0.0,
        channels: int = 1,
    ):
        self._frequency = frequency
        self._amplitude = amplitude
        self._phase = phase
        self._channels = channels

    @property
    def frequency(self):
        return self._frequency

    @property
    def amplitude(self):
        return self._amplitude

    @property
    def initial_phase(self):
        return self._phase

    def _modulated(self) -> bool:
        return any(
            isinstance(p, ProcessingElement)
            for p in (self._frequency, self._amplitude, self._phase)
        )

    def inputs(self) -> list[ProcessingElement]:
        return [
            p
            for p in (self._frequency, self._amplitude, self._phase)
            if isinstance(p, ProcessingElement)
        ]

    def is_pure(self) -> bool:
        return not self._modulated()

    def channel_count(self) -> int:
        return self._channels

    def _compute_extent(self) -> Extent:
        ext = Extent(None, None)
        for inp in self.inputs():
            ext = ext.intersection(inp.extent())
        return ext

    def _trace(self, ctx):
        sr = ctx.sample_rate
        amp = ctx.param(self._amplitude, dtype=prec.AUDIO)[:, None]

        if not self._modulated():
            # Closed-form wide phase, wrapped before the f32 cast. XLA makes
            # the division by sr a product by 1 / sr and folds (2π f t) / sr
            # into t times one constant.
            t = ctx.times(prec.WIDE)
            phase = float(self._phase) + t * (TWO_PI * float(self._frequency) * (1.0 / sr))
            ph32 = torch.remainder(phase, TWO_PI).to(prec.AUDIO)
        else:
            freq = ctx.param(self._frequency, dtype=prec.WIDE)
            inc = TWO_PI * freq / sr
            # Initial phase: the constant phase offset on the very first
            # block, otherwise the carried end-of-block phase (reference:
            # sine_pe.py:199-232 — the carried value includes phase mod).
            init_phase = (
                float(self._phase)
                if not isinstance(self._phase, ProcessingElement)
                else 0.0
            )
            acc, _ = ctx.state(
                self,
                init=lambda: torch.full((), init_phase, dtype=prec.WIDE, device=ctx.device),
            )
            ph32, final = wrapped_phase_accum(acc, inc, TWO_PI)
            if isinstance(self._phase, ProcessingElement):
                ph_in = ctx.param(self._phase, dtype=prec.WIDE)
                ph32 = torch.remainder(
                    ph32 + torch.remainder(ph_in, TWO_PI).to(prec.AUDIO), TWO_PI
                )
                final = final + ph_in[-1]
            ctx.set_state(self, final)

        # glibc's sinf, as XLA's CPU program calls it for jnp.sin (torch's
        # float32 sin differs from it by an ulp in ~5 % of values)
        sine = xla_math.sincosf(ph32[:, None])[0]
        if self._channels > 1:
            sine = sine.repeat(1, self._channels)
        # a MixPE may add the product unrounded; XLA folds a product by a
        # constant ±1 away
        if isinstance(self._amplitude, ProcessingElement) or abs(float(self._amplitude)) != 1.0:
            ctx.keep_factors(amp, sine)
        return amp * sine

    def __repr__(self) -> str:
        def s(p):
            return type(p).__name__ if isinstance(p, ProcessingElement) else str(p)

        return (
            f"SinePE(frequency={s(self._frequency)}, amplitude={s(self._amplitude)}, "
            f"phase={s(self._phase)}, channels={self._channels})"
        )


class FunctionGenPE(ProcessingElement):
    """Naive (aliasing) rectangle / saw-triangle-morph generator.

    Duty controls pulse width (rectangle) or the saw↔triangle morph. Pure
    when all params are constants (phase from the absolute index);
    modulated parameters integrate frequency with a carried phase, which
    resets to 0 on non-contiguous requests (reference behavior).
    """

    WAVE_RECTANGLE = "rectangle"
    WAVE_SAWTOOTH = "sawtooth"

    def __init__(
        self,
        frequency=1.0,
        duty_cycle=0.5,
        phase=0.0,
        waveform: str = "rectangle",
        channels: int = 1,
    ):
        self._frequency = frequency
        self._duty_cycle = duty_cycle
        self._phase_in = phase
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
    def phase(self):
        return self._phase_in

    @property
    def waveform(self) -> str:
        return self._waveform

    def inputs(self) -> list[ProcessingElement]:
        return [
            p
            for p in (self._frequency, self._duty_cycle, self._phase_in)
            if isinstance(p, ProcessingElement)
        ]

    def is_pure(self) -> bool:
        return not self.inputs()

    def channel_count(self) -> int:
        return self._channels

    def _compute_extent(self) -> Extent:
        ext = Extent(None, None)
        for inp in self.inputs():
            ext = ext.intersection(inp.extent())
        return ext

    @staticmethod
    def _saw_triangle(phase, duty):
        """duty=0 → rising saw, 0.5 → triangle, 1 → falling saw."""
        duty = duty.clamp(0.0, 1.0)
        eps = 1e-12
        a = (1.0 - duty).clamp(eps, 1.0 - eps)
        rising = -1.0 + 2.0 * (phase / a)
        falling = 1.0 - 2.0 * ((phase - a) / (1.0 - a))
        mid = torch.where(phase < a, rising, falling)
        mid = torch.where(duty <= eps, 2.0 * phase - 1.0, mid)
        return torch.where(duty >= 1.0 - eps, 1.0 - 2.0 * phase, mid)

    def _trace(self, ctx):
        sr = ctx.sample_rate
        freq = ctx.param(self._frequency, dtype=prec.WIDE)
        duty = ctx.param(self._duty_cycle, dtype=prec.WIDE)
        ph_in = ctx.param(self._phase_in, dtype=prec.WIDE)
        dt = freq / sr

        if self.is_pure():
            base = torch.remainder(ctx.times(prec.WIDE) * dt[0], 1.0)
        else:
            acc, _ = ctx.state(
                self, init=lambda: torch.zeros((), dtype=prec.WIDE, device=ctx.device)
            )
            # Phase BEFORE each sample's increment (reference convention).
            inc = torch.cat([dt.new_zeros(1), prefix_sum(dt[:-1])])
            base = torch.remainder(acc + inc, 1.0)
            ctx.set_state(self, torch.remainder(acc + dt.sum(), 1.0))

        phase = torch.remainder(base + ph_in, 1.0)
        if self._waveform == self.WAVE_RECTANGLE:
            y = torch.where(phase < duty.clamp(0.0, 1.0), 1.0, -1.0)
        else:
            y = self._saw_triangle(phase, duty)
        out = y.to(prec.AUDIO)[:, None]
        if self._channels > 1:
            out = out.repeat(1, self._channels)
        return out

    def __repr__(self) -> str:
        return (
            f"FunctionGenPE(waveform={self._waveform}, channels={self._channels})"
        )
