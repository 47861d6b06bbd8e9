"""Band-limited oscillators: BlitSawPE.

Counterpart of ``pygmu2_tpu.models.osc_bandlimited`` (reference:
src/pygmu2/blit_saw_pe.py:25-299): a Dirichlet-kernel BLIT integrated by
a leaky one-pole. The integrator is a linear recurrence, so it runs as
the doubling affine scan (``ops/linrec.affine_scan_1``), and the phase
accumulates by a float64 prefix sum (``ops/phase.prefix_sum``) — no
per-sample loop.
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
