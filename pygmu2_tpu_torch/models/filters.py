"""BiquadPE and SVFilterPE — second-order IIR filters.

Counterpart of ``pygmu2_tpu.models.filters``:
- BiquadPE   (reference: src/pygmu2/biquad_pe.py:77-474) — RBJ
  Audio-EQ-Cookbook biquad, 8 modes, frequency/Q each scalar-or-PE.
- SVFilterPE (reference: src/pygmu2/svfilter_pe.py:291-516) —
  Cytomic/Simper trapezoidal state variable filter in state-space
  (A, B, C) form; better behavior under fast modulation.

Both filters are *linear* recurrences even with time-varying
coefficients, so the sample-serial Numba kernels of the reference
(biquad_pe.py:35, svfilter_pe.py:41-106) become parallel-in-time scans
(``ops/linrec.affine_scan_2_seg``, plain PyTorch, segmented for accuracy)
batched over channels, at every width; the JAX package runs the same
segmented scan off the TPU.
"""

from __future__ import annotations

import math

import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.models.modes import BiquadMode
from pygmu2_tpu_torch.ops.linrec import affine_scan_2_seg, biquad_filter


class _FreqQFilterPE(ProcessingElement):
    """Shared plumbing for filters parameterized by (frequency, q)."""

    def __init__(self, source, frequency, q, mode: BiquadMode, gain_db: float):
        self._source = source
        self._frequency = frequency
        self._q = q
        self._mode = mode
        self._gain_db = float(gain_db)
        self._freq_is_pe = isinstance(frequency, ProcessingElement)
        self._q_is_pe = isinstance(q, ProcessingElement)

    def state_decays(self) -> bool:
        return True  # IIR tail: halo warm-up converges to f32 round-off

    def state_affine(self) -> bool:
        # Linear recurrence: output and next state are affine in the
        # carried (x, y) tails; coefficients come from the (freq, q)
        # parameter subgraphs, never from the filter state, so even
        # swept filters stay affine. Init state is zeros.
        return True

    def _fills_own_edges(self) -> bool:
        # IIR state rings past the source extent; the reference keeps
        # filtering the zero-padded input through its carried state
        # instead of clipping at the extent, so the decay tail is
        # audible. Opt out of the engine's central zero-fill.
        return True

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def frequency(self):
        return self._frequency

    @property
    def q(self):
        return self._q

    @property
    def mode(self) -> BiquadMode:
        return self._mode

    @property
    def gain_db(self) -> float:
        return self._gain_db

    def inputs(self) -> list[ProcessingElement]:
        out = [self._source]
        if self._freq_is_pe:
            out.append(self._frequency)
        if self._q_is_pe:
            out.append(self._q)
        return out

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        ext = self._source.extent()
        if self._freq_is_pe:
            ext = ext.intersection(self._frequency.extent()) or ext
        if self._q_is_pe:
            ext = ext.intersection(self._q.extent()) or ext
        return ext

    def _freq_q(self, ctx):
        """(freq, q) as (T,) tensors, clamped to valid ranges."""
        nyquist = ctx.sample_rate / 2.0
        freq = ctx.param(self._frequency, dtype=prec.AUDIO)
        q = ctx.param(self._q, dtype=prec.AUDIO)
        return torch.clamp(freq, 1.0, nyquist * 0.99), torch.clamp(q, 0.01, 100.0)


class BiquadPE(_FreqQFilterPE):
    """RBJ cookbook biquad; the recurrence runs as a parallel scan."""

    def __init__(
        self,
        source: ProcessingElement,
        frequency,
        q,
        mode: BiquadMode = BiquadMode.LOWPASS,
        gain_db: float = 0.0,
    ):
        super().__init__(source, frequency, q, mode, gain_db)

    def _coefficients(self, ctx, freq, q):
        """Normalized (b0, b1, b2, a1, a2), each (T,)."""
        # one rounded multiply, as XLA folds ``2π·f / sr``; sin and cos in
        # float64, rounded: nearer XLA's float32 sin and cos than
        # PyTorch's own (a 1-ulp pole difference moves a resonant output)
        omega = freq * (2.0 * math.pi / ctx.sample_rate)
        sin_w = torch.sin(omega.to(prec.WIDE)).to(omega.dtype)
        cos_w = torch.cos(omega.to(prec.WIDE)).to(omega.dtype)
        alpha = sin_w / (2.0 * q)
        A = 10.0 ** (self._gain_db / 40.0)
        one = torch.ones_like(omega)
        mode = self._mode

        if mode == BiquadMode.LOWPASS:
            b0 = (1.0 - cos_w) / 2.0
            b1 = 1.0 - cos_w
            b2 = b0
            a0 = 1.0 + alpha
            a1 = -2.0 * cos_w
            a2 = 1.0 - alpha
        elif mode == BiquadMode.HIGHPASS:
            b0 = (1.0 + cos_w) / 2.0
            b1 = -(1.0 + cos_w)
            b2 = b0
            a0 = 1.0 + alpha
            a1 = -2.0 * cos_w
            a2 = 1.0 - alpha
        elif mode == BiquadMode.BANDPASS:
            b0 = alpha
            b1 = torch.zeros_like(alpha)
            b2 = -alpha
            a0 = 1.0 + alpha
            a1 = -2.0 * cos_w
            a2 = 1.0 - alpha
        elif mode == BiquadMode.NOTCH:
            b0 = one
            b1 = -2.0 * cos_w
            b2 = one
            a0 = 1.0 + alpha
            a1 = b1
            a2 = 1.0 - alpha
        elif mode == BiquadMode.ALLPASS:
            b0 = 1.0 - alpha
            b1 = -2.0 * cos_w
            b2 = 1.0 + alpha
            a0 = 1.0 + alpha
            a1 = b1
            a2 = 1.0 - alpha
        elif mode == BiquadMode.PEAKING:
            b0 = 1.0 + alpha * A
            b1 = -2.0 * cos_w
            b2 = 1.0 - alpha * A
            a0 = 1.0 + alpha / A
            a1 = b1
            a2 = 1.0 - alpha / A
        elif mode == BiquadMode.LOWSHELF:
            sA = math.sqrt(A)
            b0 = A * ((A + 1.0) - (A - 1.0) * cos_w + 2.0 * sA * alpha)
            b1 = 2.0 * A * ((A - 1.0) - (A + 1.0) * cos_w)
            b2 = A * ((A + 1.0) - (A - 1.0) * cos_w - 2.0 * sA * alpha)
            a0 = (A + 1.0) + (A - 1.0) * cos_w + 2.0 * sA * alpha
            a1 = -2.0 * ((A - 1.0) + (A + 1.0) * cos_w)
            a2 = (A + 1.0) + (A - 1.0) * cos_w - 2.0 * sA * alpha
        elif mode == BiquadMode.HIGHSHELF:
            sA = math.sqrt(A)
            b0 = A * ((A + 1.0) + (A - 1.0) * cos_w + 2.0 * sA * alpha)
            b1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cos_w)
            b2 = A * ((A + 1.0) + (A - 1.0) * cos_w - 2.0 * sA * alpha)
            a0 = (A + 1.0) - (A - 1.0) * cos_w + 2.0 * sA * alpha
            a1 = 2.0 * ((A - 1.0) - (A + 1.0) * cos_w)
            a2 = (A + 1.0) - (A - 1.0) * cos_w - 2.0 * sA * alpha
        else:
            raise ValueError(f"Unknown filter mode: {self._mode}")
        return b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0

    def _trace(self, ctx):
        x = ctx.pull(self._source)
        freq, q = self._freq_q(ctx)
        b0, b1, b2, a1, a2 = self._coefficients(ctx, freq, q)
        zeros = lambda: torch.zeros((2, x.shape[1]), dtype=prec.AUDIO, device=ctx.device)  # noqa: E731
        zi, _ = ctx.state(self, init=lambda: {"x": zeros(), "y": zeros()})
        y, zf = biquad_filter(x, b0, b1, b2, a1, a2, zi)
        ctx.set_state(self, zf)
        return y

    def __repr__(self) -> str:
        return (
            f"BiquadPE(source={type(self._source).__name__}, mode={self._mode.value})"
        )


class SVFilterPE(_FreqQFilterPE):
    """Simper trapezoidal SVF; state-space form drives the same parallel
    affine scan. ALLPASS unsupported (use BiquadPE)."""

    def __init__(
        self,
        source: ProcessingElement,
        frequency,
        q,
        mode: BiquadMode = BiquadMode.LOWPASS,
        gain_db: float = 0.0,
    ):
        if mode == BiquadMode.ALLPASS:
            raise ValueError(
                "SVFilterPE does not support ALLPASS mode. "
                "Use BiquadPE for allpass, or another mode."
            )
        super().__init__(source, frequency, q, mode, gain_db)

    def _state_space(self, ctx, freq, q):
        """(A (T,2,2), B (T,2), C (T,3)) with out = C·[x, s0_prev, s1_prev]."""
        A_lin = 10.0 ** (self._gain_db / 40.0)
        mode = self._mode

        if mode == BiquadMode.PEAKING:
            k = 1.0 / (q * A_lin)
            res = torch.clamp(1.0 - 0.5 * k, 0.0, 0.999)
        else:
            res = torch.clamp(1.0 - 0.5 / q, 0.0, 0.999)
        k = 2.0 - 2.0 * res

        f_norm = freq / ctx.sample_rate
        g = torch.tan(math.pi * f_norm)
        if mode == BiquadMode.LOWSHELF:
            g = g / math.sqrt(A_lin)
        elif mode == BiquadMode.HIGHSHELF:
            g = g * math.sqrt(A_lin)

        a1 = 1.0 / (1.0 + g * (g + k))
        a2 = g * a1
        a3 = g * a2

        A = (2.0 * a1 - 1.0, -2.0 * a2, 2.0 * a2, 1.0 - 2.0 * a3)  # SoA 2×2
        B = (2.0 * a2, 2.0 * a3)

        zero = torch.zeros_like(a1)
        one = torch.ones_like(a1)
        if mode == BiquadMode.LOWPASS:
            m0, m1, m2 = zero, zero, one
        elif mode == BiquadMode.HIGHPASS:
            m0, m1, m2 = one, -k, -one
        elif mode == BiquadMode.BANDPASS:
            m0, m1, m2 = zero, one, zero
        elif mode == BiquadMode.NOTCH:
            m0, m1, m2 = one, -k, zero
        elif mode == BiquadMode.PEAKING:
            m0, m1, m2 = one, k * (A_lin * A_lin - 1.0), zero
        elif mode == BiquadMode.LOWSHELF:
            m0, m1, m2 = one, k * (A_lin - 1.0), (A_lin * A_lin - 1.0) * one
        elif mode == BiquadMode.HIGHSHELF:
            A2 = A_lin * A_lin
            m0, m1, m2 = A2 * one, k * (A_lin - A2), (1.0 - A2) * one
        else:
            raise ValueError(f"Unknown filter mode: {self._mode}")

        # Mix of the per-branch output rows C_v0=[1,0,0], C_v1=[a2,a1,−a2],
        # C_v2=[a3,a2,1−a3] (reference: svfilter_pe.py coefficient batch).
        C = torch.stack(
            [
                m0 + m1 * a2 + m2 * a3,
                m1 * a1 + m2 * a2,
                -m1 * a2 + m2 * (1.0 - a3),
            ],
            dim=-1,
        )  # (T, 3)
        return A, B, C

    def _trace(self, ctx):
        x = ctx.pull(self._source)
        T, Cch = x.shape
        freq, q = self._freq_q(ctx)
        A, B, C = self._state_space(ctx, freq, q)

        s0, _ = ctx.state(
            self, init=lambda: torch.zeros((Cch, 2), dtype=prec.AUDIO, device=ctx.device)
        )
        s1, s2 = affine_scan_2_seg(
            *(a[:, None].expand(T, Cch) for a in A),
            B[0][:, None] * x,
            B[1][:, None] * x,
            s0=(s0[:, 0], s0[:, 1]),
        )
        s1_prev = torch.cat([s0[None, :, 0], s1[:-1]])
        s2_prev = torch.cat([s0[None, :, 1], s2[:-1]])
        y = C[:, None, 0] * x + C[:, None, 1] * s1_prev + C[:, None, 2] * s2_prev
        ctx.set_state(self, torch.stack([s1[-1], s2[-1]], dim=-1))
        return y.to(prec.AUDIO)

    def __repr__(self) -> str:
        return (
            f"SVFilterPE(source={type(self._source).__name__}, mode={self._mode.value})"
        )
