"""Extent windowing: CropPE / SetExtentPE and their shared base.

Counterpart of ``pygmu2_tpu.models.window`` (reference:
src/pygmu2/extent_window_pe.py:22, crop_pe.py:15, set_extent_pe.py:17).
The window is a host-side Extent; held edges are selects over the
absolute time index.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch.core.extent import Extent, ExtendMode
from pygmu2_tpu_torch.core.processing_element import ProcessingElement


class _ExtentWindowPE(ProcessingElement):
    """Pass the source through inside a window; apply ExtendMode outside."""

    def __init__(
        self,
        source: ProcessingElement,
        extent: Extent,
        extend_mode: ExtendMode = ExtendMode.ZERO,
    ):
        self._source = source
        self._extent = extent
        self._extend_mode = extend_mode

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def extent_window(self) -> Extent:
        return self._extent

    @property
    def extend_mode(self) -> ExtendMode:
        return self._extend_mode

    def inputs(self) -> list[ProcessingElement]:
        return [self._source]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        return self._extent.intersection(self._source.extent())

    def _fills_own_edges(self) -> bool:
        # _trace enforces the window itself in every mode (zeros or holds
        # outside [w_start, w_end)), so the engine mask must not re-apply
        # the *intersected* extent: a ringing source's decay tail inside
        # the window but past the source extent survives (crop_pe.py
        # masks only its own window).
        return True

    def _trace(self, ctx):
        mode = self._extend_mode
        w_start = self._extent.start
        w_end = self._extent.end
        t = ctx.times()
        out = ctx.pull(self._source)

        hold_first = mode in (ExtendMode.HOLD_FIRST, ExtendMode.HOLD_BOTH)
        hold_last = mode in (ExtendMode.HOLD_LAST, ExtendMode.HOLD_BOTH)

        if w_start is not None:
            before = (t < w_start)[:, None]
            if hold_first:
                first_val = ctx.pull_abs(self._source, w_start, 1)  # (1, C)
                out = torch.where(before, first_val, out)
            else:
                out = torch.where(before, 0.0, out)
        if w_end is not None:
            after = (t >= w_end)[:, None]
            if hold_last:
                last_val = ctx.pull_abs(self._source, w_end - 1, 1)
                out = torch.where(after, last_val, out)
            else:
                out = torch.where(after, 0.0, out)
        return out


class CropPE(_ExtentWindowPE):
    """Limit the source to ``[start, start + duration)``.

    ``duration=None`` leaves the upper bound open. Output extent is the
    crop window intersected with the source extent.
    """

    def __init__(
        self,
        source: ProcessingElement,
        start: int,
        duration: int | None,
        extend_mode: ExtendMode = ExtendMode.ZERO,
    ):
        if duration is not None and duration < 0:
            raise ValueError(f"duration must be >= 0, got {duration}")
        self._start = int(start)
        self._duration = int(duration) if duration is not None else None
        end = None if self._duration is None else self._start + self._duration
        super().__init__(source, Extent(self._start, end), extend_mode)

    @property
    def crop_extent(self) -> Extent:
        return self._extent

    @property
    def start(self) -> int:
        return self._start

    @property
    def duration(self) -> int | None:
        return self._duration

    @property
    def end(self) -> int | None:
        return self._extent.end

    def __repr__(self) -> str:
        extra = (
            f", extend_mode={self._extend_mode.value}"
            if self._extend_mode != ExtendMode.ZERO
            else ""
        )
        return (
            f"CropPE(source={type(self._source).__name__}, "
            f"start={self._start}, end={self._extent.end}{extra})"
        )


class SetExtentPE(_ExtentWindowPE):
    """Force an arbitrary extent onto the source (pad or truncate).

    Unlike CropPE, the forced extent stands alone — it is NOT intersected
    with the source extent.
    """

    def __init__(
        self,
        source: ProcessingElement,
        start: int | None,
        duration: int | None,
        extend_mode: ExtendMode = ExtendMode.ZERO,
    ):
        if duration is not None and duration < 0:
            raise ValueError(f"duration must be >= 0, got {duration}")
        self._start = int(start) if start is not None else None
        self._duration = int(duration) if duration is not None else None
        end = None
        if self._duration is not None:
            end = self._duration if self._start is None else self._start + self._duration
        super().__init__(source, Extent(self._start, end), extend_mode)

    @property
    def start(self) -> int | None:
        return self._start

    @property
    def duration(self) -> int | None:
        return self._duration

    @property
    def end(self) -> int | None:
        return self._extent.end

    def _compute_extent(self) -> Extent:
        return self._extent

    def __repr__(self) -> str:
        extra = (
            f", extend_mode={self._extend_mode.value}"
            if self._extend_mode != ExtendMode.ZERO
            else ""
        )
        return (
            f"SetExtentPE(source={type(self._source).__name__}, "
            f"extent={self._extent!r}{extra})"
        )
