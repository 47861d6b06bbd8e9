"""DelayPE — integer, fractional, and modulated delay.

Counterpart of ``pygmu2_tpu.models.delay`` (reference:
src/pygmu2/delay_pe.py:19-231). Three modes:

1. int delay — pure index shift: the engine pulls the source at
   ``start − delay`` (a fixed offset, so it memoizes).
2. float delay — constant fractional delay through the shared
   gather+interpolation primitive.
3. PE delay — per-sample variable delay (vibrato/chorus/flanger).

PE mode pulls a window of ``[start − max_delay − pad, start + duration +
pad)``, ``max_delay`` a constructor hint (default 1 s). Positive delay
looks into the past on all paths.

The window positions are those of XLA's CPU program of the JAX PE: a
constant delay's ``i − d − shift`` is ``i + c`` with the two constants
folded in float32 first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.models.modes import InterpolationMode
from pygmu2_tpu_torch.ops.interp import interp_window


class DelayPE(ProcessingElement):
    """Delay the source by int samples, fractional samples, or a PE."""

    def __init__(
        self,
        source: ProcessingElement,
        delay,
        interpolation: InterpolationMode = InterpolationMode.LINEAR,
        max_delay: float | None = None,
        min_delay: float = 0.0,
    ):
        self._source = source
        self._delay = delay
        self._interpolation = interpolation
        if isinstance(delay, ProcessingElement):
            self._mode = "pe"
            self._max_delay = (
                float(max_delay) if max_delay is not None else float(self.sample_rate)
            )
            self._min_delay = float(min_delay)
        elif isinstance(delay, float) and not delay.is_integer():
            self._mode = "float"
        else:
            self._mode = "int"
            self._delay = int(delay)

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def delay(self):
        return self._delay

    @property
    def interpolation(self) -> InterpolationMode:
        return self._interpolation

    def inputs(self) -> list[ProcessingElement]:
        if self._mode == "pe":
            return [self._source, self._delay]
        return [self._source]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        if self._mode == "pe":
            return self._source.extent().intersection(self._delay.extent())
        ext = self._source.extent()
        d = self._delay
        start = None if ext.start is None else ext.start + d
        end = None if ext.end is None else ext.end + d
        if self._mode == "float":
            start = None if start is None else int(math.floor(start))
            end = None if end is None else int(math.ceil(end))
        return Extent(start, end)

    def _source_valid_mask(self, indices):
        """Zero-mask for lookup indices outside the source extent (the
        reference's rule: valid iff the whole linear stencil lies inside
        the source)."""
        ext = self._source.extent()
        valid = torch.ones(indices.shape, dtype=torch.bool, device=indices.device)
        if ext.start is not None:
            valid &= indices >= ext.start
        if ext.end is not None:
            valid &= indices <= ext.end - 1
        return valid

    def _trace(self, ctx):
        if self._mode == "int":
            return ctx.pull(self._source, shift=-self._delay)

        mode = "cubic" if self._interpolation == InterpolationMode.CUBIC else "linear"
        pad = 2 if mode == "cubic" else 1
        base = torch.arange(ctx.duration, dtype=torch.float32, device=ctx.device)

        if self._mode == "float":
            d = float(self._delay)
            lo = int(math.floor(d))
            win_shift = -(lo + pad)
            win_len = ctx.duration + 2 * pad + 1
            window = ctx.pull(self._source, shift=win_shift, duration=win_len)
            # Row r of the window is absolute index start + win_shift + r.
            pos = base + float(np.float32(-np.float32(d)) + np.float32(-win_shift))
            out = interp_window(window, pos, mode=mode, oob_zero=False)
            valid = self._source_valid_mask(ctx.times(prec.WIDE) - d)
            return torch.where(valid[:, None], out, 0.0)

        # PE-valued delay: a window covering [-max_delay, -min_delay]
        lo = int(math.floor(self._min_delay))
        hi = int(math.ceil(self._max_delay))
        win_shift = -(hi + pad)
        win_len = ctx.duration + (hi - lo) + 2 * pad + 1
        window = ctx.pull(self._source, shift=win_shift, duration=win_len)
        dvals = ctx.param(self._delay, dtype=torch.float32)
        pos = (base - dvals) + float(-win_shift)
        out = interp_window(window, pos, mode=mode, oob_zero=True)
        valid = self._source_valid_mask(ctx.times(prec.WIDE) - dvals.to(prec.WIDE))
        return torch.where(valid[:, None], out, 0.0)

    def __repr__(self) -> str:
        d = (
            type(self._delay).__name__
            if isinstance(self._delay, ProcessingElement)
            else self._delay
        )
        return f"DelayPE(source={type(self._source).__name__}, delay={d})"
