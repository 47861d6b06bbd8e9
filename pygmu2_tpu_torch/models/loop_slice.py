"""LoopPE, SlicePE, SequencePE — time-rearranging transforms.

Counterpart of ``pygmu2_tpu.models.loop_slice``:
- LoopPE     (reference: src/pygmu2/loop_pe.py:17-252) — repeats a loop
  region, optional linear crossfade at the seam; the loop body is pulled
  once per block at a fixed index and replayed by a modulo gather (the
  seam's blend fuses its product of the loop's start into the sum, as
  XLA's CPU program does: read from its object code).
- SlicePE    (reference: src/pygmu2/slice_pe.py:32-132) — composite:
  crop → shift-to-zero → optional fade envelope.
- SequencePE (reference: src/pygmu2/sequence_pe.py:27-131) — composite:
  per-item delay (+ crop in NON_OVERLAP mode), merged with a MixPE. The
  engine prunes items that can't sound in a block.
"""

from __future__ import annotations

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.models.basic import ArrayPE, GainPE, MixPE
from pygmu2_tpu_torch.models.delay import DelayPE
from pygmu2_tpu_torch.models.modes import SequenceMode
from pygmu2_tpu_torch.models.window import CropPE
from pygmu2_tpu_torch.ops.xla_math import fmaf


class LoopPE(ProcessingElement):
    """Repeat ``[loop_start, loop_end)`` of the source ``count`` times
    (None = forever), starting at t=0."""

    def __init__(
        self,
        source: ProcessingElement,
        loop_start: int | None = None,
        loop_end: int | None = None,
        count: int | None = None,
        crossfade_seconds: float | None = None,
    ):
        if crossfade_seconds is not None and crossfade_seconds < 0:
            raise ValueError(
                f"crossfade_seconds must be non-negative, got {crossfade_seconds}"
            )
        self._source = source
        self._loop_start = loop_start
        self._loop_end = loop_end
        self._count = count
        self._crossfade_seconds = crossfade_seconds

        src_ext = source.extent()
        self._resolved_start = (
            loop_start
            if loop_start is not None
            else (src_ext.start if src_ext.start is not None else 0)
        )
        if loop_end is not None:
            self._resolved_end = loop_end
        elif src_ext.end is not None:
            self._resolved_end = src_ext.end
        else:
            raise ValueError(
                "Cannot loop source with infinite extent without explicit loop_end"
            )
        self._loop_length = self._resolved_end - self._resolved_start
        if self._loop_length <= 0:
            raise ValueError(
                f"Loop length must be positive, got {self._loop_length}"
            )
        self._crossfade = (
            int(round(crossfade_seconds * self.sample_rate))
            if crossfade_seconds is not None
            else 0
        )
        self._crossfade = min(self._crossfade, self._loop_length // 2)

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def loop_start(self) -> int | None:
        return self._loop_start

    @property
    def loop_end(self) -> int | None:
        return self._loop_end

    @property
    def count(self) -> int | None:
        return self._count

    @property
    def crossfade_seconds(self) -> float:
        return float(self._crossfade_seconds or 0.0)

    @property
    def crossfade_samples(self) -> int:
        return int(self._crossfade)

    def inputs(self) -> list[ProcessingElement]:
        return [self._source]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        if self._count is None:
            return Extent(0, None)
        return Extent(0, self._count * self._loop_length)

    def _trace(self, ctx):
        L = self._loop_length
        loop_data = ctx.pull_abs(self._source, self._resolved_start, L)  # (L, C)
        pos = torch.remainder(ctx.times(), L)
        out = loop_data[pos]

        if self._crossfade > 0:
            xf = self._crossfade
            fade_pos = pos - (L - xf)  # >= 0 inside the seam region
            # XLA divides by a constant as a product with its reciprocal
            frac = (fade_pos.to(prec.AUDIO) * float(np.float32(1.0 / xf))).clamp(0.0, 1.0)[:, None]
            blend = loop_data[fade_pos.clamp(0, L - 1)]
            faded = fmaf(blend, frac, out * (1.0 - frac))
            out = torch.where((fade_pos >= 0)[:, None], faded, out)
        return out

    def __repr__(self) -> str:
        extra = f", count={self._count}" if self._count is not None else ""
        if self._crossfade_seconds:
            extra += f", crossfade_seconds={self._crossfade_seconds}"
        return (
            f"LoopPE(source={type(self._source).__name__}, "
            f"loop_start={self._loop_start}, loop_end={self._loop_end}{extra})"
        )


class _Composite(ProcessingElement):
    """Base for PEs that delegate to an internal sub-graph ``self._out``
    (reference pattern: CONTRIBUTING.md composite PEs expose the internal
    graph by returning [self._out] from inputs())."""

    _out: ProcessingElement

    def inputs(self) -> list[ProcessingElement]:
        return [self._out]

    def is_pure(self) -> bool:
        return self._out.is_pure()

    def channel_count(self) -> int | None:
        return self._out.channel_count()

    def _compute_extent(self) -> Extent:
        return self._out.extent()

    def _trace(self, ctx):
        return ctx.pull(self._out)


class SlicePE(_Composite):
    """Extract ``[start, start+duration)`` of the source, re-anchored at
    t=0, with optional linear fade-in/out."""

    def __init__(
        self,
        source: ProcessingElement,
        start: int,
        duration: int,
        *,
        fade_in_seconds: float | None = None,
        fade_out_seconds: float | None = None,
    ):
        if duration < 0:
            raise ValueError(f"duration must be >= 0, got {duration}")
        self._source = source
        self._start = int(start)
        self._duration = int(duration)
        self._fade_in_seconds = fade_in_seconds
        self._fade_out_seconds = fade_out_seconds
        sr = self.sample_rate
        self._fade_in = (
            int(round(fade_in_seconds * sr)) if fade_in_seconds is not None else 0
        )
        self._fade_out = (
            int(round(fade_out_seconds * sr)) if fade_out_seconds is not None else 0
        )

        base = DelayPE(CropPE(source, self._start, self._duration), -self._start)
        if self._duration > 0 and (self._fade_in > 0 or self._fade_out > 0):
            env = np.ones((self._duration,), dtype=np.float32)
            fi = min(self._fade_in, self._duration)
            fo = min(self._fade_out, self._duration)
            if fi > 0:
                env[:fi] = np.minimum(
                    env[:fi], (np.arange(fi, dtype=np.float32) + 1.0) / fi
                )
            if fo > 0:
                env[-fo:] = np.minimum(
                    env[-fo:], 1.0 - (np.arange(fo, dtype=np.float32) + 1.0) / fo
                )
            self._out = GainPE(base, ArrayPE(env))
        else:
            self._out = base

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def start(self) -> int:
        return self._start

    @property
    def duration(self) -> int:
        return self._duration

    @property
    def fade_in_samples(self) -> int:
        return self._fade_in

    @property
    def fade_out_samples(self) -> int:
        return self._fade_out

    def __repr__(self) -> str:
        return (
            f"SlicePE(source={type(self._source).__name__}, start={self._start}, "
            f"duration={self._duration}, fade_in_seconds={self._fade_in_seconds}, "
            f"fade_out_seconds={self._fade_out_seconds})"
        )


class SequencePE(_Composite):
    """Schedule (pe, start) items on a shared timeline.

    ``start=None`` auto-advances past the previous item's finite extent.
    NON_OVERLAP crops each item at the next item's start. Composite:
    DelayPE per item (when needed) merged by MixPE.
    """

    def __init__(
        self,
        *input_start_pairs,
        mode: SequenceMode | str = SequenceMode.OVERLAP,
    ):
        if len(input_start_pairs) == 2 and isinstance(
            input_start_pairs[0], ProcessingElement
        ):
            pairs = [(input_start_pairs[0], input_start_pairs[1])]
        elif len(input_start_pairs) == 1 and isinstance(
            input_start_pairs[0], (list, tuple)
        ):
            pairs = list(input_start_pairs[0])
        else:
            pairs = list(input_start_pairs)
        if not pairs:
            raise ValueError("SequencePE requires at least one (pe, start) pair")

        resolved: list[tuple[ProcessingElement, int]] = []
        prev_end: int | None = 0
        for idx, pair in enumerate(pairs):
            if not isinstance(pair, (list, tuple)) or len(pair) != 2:
                raise ValueError("Each input must be a (pe, start) pair")
            pe, start = pair
            if start is None:
                if idx == 0:
                    start = 0
                elif prev_end is None:
                    raise ValueError(
                        "Cannot auto-advance start time after an infinite extent"
                    )
                else:
                    start = prev_end
            start = int(start)
            resolved.append((pe, start))
            ext = pe.extent()
            prev_end = (
                None
                if ext.end is None
                else start + int(ext.end - (ext.start or 0))
            )
        if isinstance(mode, str):
            mode = SequenceMode(mode.lower())
        self._mode = mode
        resolved.sort(key=lambda p: p[1])
        self._items = resolved

        parts: list[ProcessingElement] = []
        for i, (pe, start) in enumerate(resolved):
            node = DelayPE(pe, start)
            if mode == SequenceMode.NON_OVERLAP and i + 1 < len(resolved):
                next_start = resolved[i + 1][1]
                node = CropPE(node, start, next_start - start)
            parts.append(node)
        self._out = parts[0] if len(parts) == 1 else MixPE(parts)

    @property
    def items(self):
        return list(self._items)

    @property
    def mode(self) -> SequenceMode:
        return self._mode

    def __repr__(self) -> str:
        return f"SequencePE(n_items={len(self._items)}, mode={self._mode.value})"
