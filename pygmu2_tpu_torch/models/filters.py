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
batched over channels, routed as the JAX package routes them on the TPU
(``ops/linrec.affine_scan_2_auto``): 4 to 128 channels of at least 4096
samples take the chunked scan of TPU kernel ``affine_scan_2_pallas`` (a
hand-written kernel on the card), narrower or shorter blocks the
segmented scan in plain PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.models.modes import BiquadMode
from pygmu2_tpu_torch.ops.linrec import affine_scan_2_auto, biquad_filter
from pygmu2_tpu_torch.ops.xla_math import fmaf, sincosf

# the modes whose a0 is 1 + alpha
_ALPHA_A0_MODES = (BiquadMode.LOWPASS, BiquadMode.HIGHPASS, BiquadMode.BANDPASS,
                   BiquadMode.NOTCH, BiquadMode.ALLPASS)


def _f32(x: float) -> float:
    """``x`` rounded to float32 (a constant XLA folds in float32)."""
    return float(np.float32(x))


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
        """Normalized (b0, b1, b2, a1, a2), each (T,).

        The RBJ formulas as the JAX package's program computes them on
        XLA's CPU backend, op for op (a 1-ulp pole difference moves a
        resonant output): ``2*pi*f/sr`` folded into one multiply, glibc's
        ``sinf``/``cosf`` (:mod:`pygmu2_tpu_torch.ops.xla_math`), a
        division by a constant ``2q`` as a multiply by its float32
        reciprocal, ``b0 = sin/(2q*a0)`` for the band-pass, and one fused
        multiply-add wherever a product's only use within a coefficient is
        a sum (XLA computes each coefficient in a fusion of its own, so
        ``alpha`` fuses into ``a0`` except where that coefficient also
        uses ``alpha`` alone).
        """
        omega = freq * (2.0 * math.pi / ctx.sample_rate)
        sin_w, cos_w = sincosf(omega)
        if self._q_is_pe:  # 2q is traced: a true division
            two_q = 2.0 * q
            alpha = sin_w / two_q

            def alpha_k(k):  # k * alpha
                return alpha * k

            def alpha_fma(k, c):  # k * alpha + c, fused
                return fmaf(alpha, k, c)
        else:  # the constants fold in float32: sin * (k * rq)
            two_q = _f32(2.0 * min(max(_f32(self._q), _f32(0.01)), 100.0))
            rq = _f32(1.0 / two_q)
            alpha = sin_w * rq

            def alpha_k(k):
                return sin_w * _f32(k * rq)

            def alpha_fma(k, c):
                return fmaf(sin_w, _f32(k * rq), c)

        A_wide = 10.0 ** (self._gain_db / 40.0)  # a Python float, as in the JAX source
        A = _f32(A_wide)
        mode = self._mode
        if mode in _ALPHA_A0_MODES:
            a0 = alpha_fma(1.0, 1.0)
            a1 = (cos_w * -2.0) / a0
            a2 = (1.0 - alpha) / (alpha + 1.0)
            if mode == BiquadMode.LOWPASS:
                b0 = ((1.0 - cos_w) * 0.5) / a0
                return b0, (1.0 - cos_w) / a0, b0, a1, a2
            if mode == BiquadMode.HIGHPASS:
                b0 = ((cos_w + 1.0) * 0.5) / a0
                return b0, -(cos_w + 1.0) / a0, b0, a1, a2
            if mode == BiquadMode.BANDPASS:
                b0 = sin_w / (two_q * a0)
                return b0, 0.0 / a0, -alpha / (alpha + 1.0), a1, a2
            if mode == BiquadMode.NOTCH:
                b0 = 1.0 / a0
                return b0, a1, b0, a1, a2
            return a2, a1, a0 / a0, a1, a2  # ALLPASS
        if mode == BiquadMode.PEAKING:
            inv_a = _f32(1.0 / A)  # a division by A is a multiply by f32(1/A)
            a0 = alpha_fma(inv_a, 1.0)
            a1 = (cos_w * -2.0) / a0
            alpha_a = alpha_k(inv_a)
            a2 = (1.0 - alpha_a) / (alpha_a + 1.0)
            # at A = 1, b2's expression is a2's (XLA computes it once)
            b2 = a2 if A == 1.0 else alpha_fma(-A, 1.0) / a0
            return alpha_fma(A, 1.0) / a0, a1, b2, a1, a2
        if mode in (BiquadMode.LOWSHELF, BiquadMode.HIGHSHELF):
            s = 1.0 if mode == BiquadMode.LOWSHELF else -1.0
            k = _f32(2.0 * math.sqrt(A_wide))
            am, ap = _f32(A_wide - 1.0), _f32(A_wide + 1.0)
            m = alpha_k(k)
            base = fmaf(cos_w, s * am, ap)  # (A+1) + s(A-1)cos: a0's and a2's
            a0 = alpha_fma(k, base)
            a1 = fmaf(cos_w, s * ap, am) * (-2.0 * s) / a0
            a2 = (base - m) / (base + m)
            # b0 and b2 share (A-1)cos and k*alpha: neither fuses there
            p = cos_w * am
            b_den = (ap + s * p) + m
            b0 = ((ap - s * p) + m) * A / b_den
            b1 = fmaf(cos_w, -s * ap, am) * (s * _f32(2.0 * A_wide)) / a0
            b2 = ((ap - s * p) - m) * A / b_den
            return b0, b1, b2, a1, a2
        raise ValueError(f"Unknown filter mode: {self._mode}")

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
        s1, s2 = affine_scan_2_auto(
            *(a[:, None] for a in A),  # (T, 1) columns shared by the channels
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
