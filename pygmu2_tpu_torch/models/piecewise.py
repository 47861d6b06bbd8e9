"""PiecewisePE — breakpoint curves.

Counterpart of ``pygmu2_tpu.models.piecewise`` (reference:
src/pygmu2/piecewise_pe.py:47-235): a (sample_index, value) breakpoint
curve with STEP / LINEAR / EXPONENTIAL / SIGMOID / CONSTANT_POWER
transitions and ExtendMode edge behavior.

The JAX package routes by point count, and so does the port, because the
two routes round differently:

- up to ``_MATMUL_MAX_POINTS`` points, block-anchored float32 times: the
  segment of each sample is the count of inner breakpoints at or before
  it (the JAX package picks the segment's payload row with an exact
  one-hot matmul; here it is a gather), and
  ``frac = clip((rel - t0) * inv_len, 0, 1)`` with a host-computed
  float32 ``1/len``;
- beyond, float64 times and a division (``searchsorted`` route).

The transition curves take XLA's CPU arithmetic: a product that feeds a
sum is one fused multiply-add, and ``exp``, ``pow``, ``sin`` and ``cos``
are :mod:`~pygmu2_tpu_torch.ops.xla_math`'s mirrors.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent, ExtendMode
from pygmu2_tpu_torch.core.processing_element import SourcePE
from pygmu2_tpu_torch.models.modes import TransitionType
from pygmu2_tpu_torch.ops import xla_math

# Above this many breakpoints the JAX package leaves its one-hot route for
# searchsorted + gather; the port routes the same way.
_MATMUL_MAX_POINTS = 1024


def _parse_points(points: Sequence[Tuple[int, float]]):
    if not points:
        raise ValueError("PiecewisePE requires at least one point")
    pts = sorted((int(t), float(v)) for t, v in points)
    # Duplicate times: later value wins.
    dedup: dict[int, float] = {}
    for t, v in pts:
        dedup[t] = v
    times = np.array(sorted(dedup), dtype=np.int64)
    values = np.array([dedup[t] for t in sorted(dedup)], dtype=np.float64)
    return times, values


class PiecewisePE(SourcePE):
    """Breakpoint curve source; one fused select over segments."""

    def __init__(
        self,
        points: Sequence[Tuple[int, float]],
        transition_type: TransitionType | str = TransitionType.LINEAR,
        extend_mode: ExtendMode = ExtendMode.ZERO,
        channels: int = 1,
    ):
        self._times, self._values = _parse_points(points)
        self._n = len(self._times)
        if isinstance(transition_type, str):
            try:
                transition_type = TransitionType(transition_type.lower())
            except ValueError:
                transition_type = TransitionType.LINEAR
        self._transition_type = transition_type
        self._extend_mode = extend_mode
        self._channels = int(channels)
        if self._channels < 1:
            raise ValueError(f"channels must be >= 1, got {self._channels}")

    @property
    def points(self) -> List[Tuple[int, float]]:
        return list(zip(self._times.tolist(), self._values.tolist()))

    @property
    def transition_type(self) -> TransitionType:
        return self._transition_type

    @property
    def extend_mode(self) -> ExtendMode:
        return self._extend_mode

    def channel_count(self) -> int:
        return self._channels

    def _compute_extent(self) -> Extent:
        if self._extend_mode != ExtendMode.ZERO:
            return Extent(None, None)
        t0 = int(self._times[0])
        t_last = int(self._times[-1])
        if self._n == 1:
            return Extent(t0, t0 + 1)
        return Extent(t0, t_last)

    def _tables(self, device):
        """The breakpoints on ``device``, copied there once (a copy to the
        card in every block would synchronize the stream): int64 times,
        float32 and float64 values, float32 ``1/len``."""
        cache = self.__dict__.setdefault("_on_device", {})
        if device not in cache:
            inv_len = (1.0 / (self._times[1:] - self._times[:-1])).astype(np.float32)
            cache[device] = (
                torch.from_numpy(self._times).to(device),
                torch.from_numpy(self._values.astype(np.float32)).to(device),
                torch.from_numpy(self._values).to(device),
                torch.from_numpy(inv_len).to(device),
            )
        return cache[device]

    def _curve(self, frac, v0, v1):
        """Transition curve on frac in [0, 1] between v0 and v1 (float32
        in the one-hot route, float64 in the searchsorted route)."""
        mode = self._transition_type
        f32 = frac.dtype == torch.float32
        lerp = (lambda a, b, f: xla_math.fmaf(b - a, f, a)) if f32 else (
            lambda a, b, f: a + (b - a) * f)
        if mode == TransitionType.STEP:
            return v0
        if mode == TransitionType.EXPONENTIAL:
            # Geometric glide only when both endpoints share a positive sign;
            # otherwise fall back to linear (reference rule).
            ok = (v0 > 0) & (v1 > 0)
            safe_v0 = torch.where(ok, v0, 1.0)
            safe_v1 = torch.where(ok, v1, 1.0)
            if f32:
                geo = safe_v0 * xla_math.powf(safe_v1 / safe_v0, frac)
            else:
                geo = safe_v0 * (safe_v1 / safe_v0) ** frac
            return torch.where(ok, geo, lerp(v0, v1, frac))
        if mode == TransitionType.SIGMOID:
            x = (6.0 * (2.0 * frac - 1.0)).clamp(-20.0, 20.0)
            sig = 1.0 / (1.0 + (xla_math.expf(-x) if f32 else torch.exp(-x)))
            return lerp(v0, v1, sig)
        if mode == TransitionType.CONSTANT_POWER:
            # Rising pairs use sin, falling use 1−cos: fade pairs sum to
            # constant power.
            if f32:
                rise, cos = xla_math.sincosf(frac * float(np.float32(0.5 * math.pi)))
            else:
                arg = 0.5 * math.pi * frac
                rise, cos = torch.sin(arg), torch.cos(arg)
            curve = torch.where(v1 >= v0, rise, 1.0 - cos)
            return lerp(v0, v1, curve)
        return lerp(v0, v1, frac)

    def _trace(self, ctx):
        T = ctx.duration
        dev = ctx.device
        times, values32, values64, inv_len = self._tables(dev)
        # Block-anchored times: in-block offsets are small exact f32 ints;
        # breakpoint offsets are exact while within 2^24 of the block.
        rel = torch.arange(T, dtype=torch.float32, device=dev)
        times_rel = (times - ctx.start).to(torch.float32)

        if self._n == 1:
            out = torch.full((T,), float(self._values[0]), dtype=torch.float32, device=dev)
        elif self._n <= _MATMUL_MAX_POINTS:
            out = self._trace_onehot(rel, times_rel, values32, inv_len)
        else:
            out = self._trace_searchsorted(ctx, times, values64)

        hold_first = self._extend_mode in (ExtendMode.HOLD_FIRST, ExtendMode.HOLD_BOTH)
        hold_last = self._extend_mode in (ExtendMode.HOLD_LAST, ExtendMode.HOLD_BOTH)
        before = rel < times_rel[0]
        after = rel > times_rel[-1] if self._n == 1 else rel >= times_rel[-1]
        first = float(np.float32(self._values[0])) if hold_first else 0.0
        last = float(np.float32(self._values[-1])) if hold_last else 0.0
        out = torch.where(before, first, out)
        out = torch.where(after, last, out)

        out = out.to(prec.AUDIO)[:, None]
        if self._channels > 1:
            out = out.repeat(1, self._channels)
        return out

    def _trace_onehot(self, rel, times_rel, values32, inv_len):
        """The JAX package's one-hot route: its matmul picks a payload row
        exactly, so a gather of the segment index gives the same values."""
        if self._n == 2:
            seg = torch.zeros(rel.shape, dtype=torch.int64, device=rel.device)
        else:
            seg = (rel[:, None] >= times_rel[None, 1:-1]).sum(dim=1)
        v0 = values32[seg]
        v1 = values32[seg + 1]
        frac = ((rel - times_rel[seg]) * inv_len[seg]).clamp(0.0, 1.0)
        return self._curve(frac, v0, v1)

    def _trace_searchsorted(self, ctx, times, values):
        """Gather formulation for very large curves (> _MATMUL_MAX_POINTS)."""
        t = ctx.times(prec.WIDE)
        seg = (torch.searchsorted(times.double(), t, right=True) - 1).clamp(0, self._n - 2)
        v0 = values[seg]
        v1 = values[seg + 1]
        seg_t0 = times[seg].double()
        seg_t1 = times[seg + 1].double()
        frac = ((t - seg_t0) / (seg_t1 - seg_t0)).clamp(0.0, 1.0)
        return self._curve(frac, v0, v1).to(torch.float32)

    def __repr__(self) -> str:
        return (
            f"PiecewisePE(n_points={self._n}, "
            f"transition={self._transition_type.value}, "
            f"extend={self._extend_mode.value})"
        )
