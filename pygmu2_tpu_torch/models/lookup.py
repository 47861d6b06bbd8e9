"""Index-lookup and windowed-statistics PEs.

Counterpart of ``pygmu2_tpu.models.lookup``:
- WavetablePE (reference: src/pygmu2/wavetable_pe.py:32-178) —
  ``out[t] = table[indexer[t]]`` with LINEAR/CUBIC interpolation and
  ZERO/CLAMP/WRAP out-of-bounds modes.
- TimeWarpPE  (reference: src/pygmu2/timewarp_pe.py:38-196) — variable
  speed tape head: ``indices = pos + prefix_sum(rate)`` with carried
  ``pos``; supports negative rates and a live ``seek``.
- WindowPE    (reference: src/pygmu2/window_pe.py:26-258) — zero-phase
  centered window stats MAX/MIN/MEAN/RMS, fetching a halo around the
  block.

WavetablePE pulls the whole (finite) table every block and gathers.
TimeWarpPE pulls a window of the source sized by ``max_rate`` at the
block's lowest index: the one host read of a device value a block (the
window's start, an index into the graph). Prefix sums take XLA's CPU
order (``ops/phase.prefix_sum``), as the JAX PEs' ``jnp.cumsum``.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.models.modes import InterpolationMode, OutOfBoundsMode, WindowMode
from pygmu2_tpu_torch.ops.interp import interp_window
from pygmu2_tpu_torch.ops.phase import prefix_sum
from pygmu2_tpu_torch.ops.xla_math import mod, sqrtf


def _mode(interpolation: InterpolationMode) -> str:
    return "cubic" if interpolation == InterpolationMode.CUBIC else "linear"


class WavetablePE(ProcessingElement):
    """``out[t] = wavetable[indexer[t]]`` with interpolation."""

    def __init__(
        self,
        wavetable: ProcessingElement,
        indexer: ProcessingElement,
        interpolation: InterpolationMode = InterpolationMode.LINEAR,
        out_of_bounds: OutOfBoundsMode = OutOfBoundsMode.ZERO,
    ):
        self._wavetable = wavetable
        self._indexer = indexer
        self._interpolation = interpolation
        self._out_of_bounds = out_of_bounds

    @property
    def wavetable(self) -> ProcessingElement:
        return self._wavetable

    @property
    def indexer(self) -> ProcessingElement:
        return self._indexer

    @property
    def interpolation(self) -> InterpolationMode:
        return self._interpolation

    @property
    def out_of_bounds(self) -> OutOfBoundsMode:
        return self._out_of_bounds

    def inputs(self) -> list[ProcessingElement]:
        return [self._wavetable, self._indexer]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._wavetable.channel_count()

    def _compute_extent(self) -> Extent:
        return self._indexer.extent()

    def _trace(self, ctx):
        idx = ctx.pull(self._indexer)[:, 0].to(torch.float32)
        wt_ext = self._wavetable.extent()
        if wt_ext.start is None or wt_ext.end is None:
            raise ValueError(
                "WavetablePE requires a wavetable with finite extent; "
                "wrap the source in CropPE."
            )
        w_start, w_end = wt_ext.start, wt_ext.end
        table = ctx.pull_abs(self._wavetable, w_start, w_end - w_start)
        mode = _mode(self._interpolation)
        pos = idx - w_start
        W = w_end - w_start
        if self._out_of_bounds == OutOfBoundsMode.WRAP:
            return interp_window(table, mod(pos, float(W)), mode=mode, oob_zero=False)
        if self._out_of_bounds == OutOfBoundsMode.CLAMP:
            return interp_window(table, pos.clamp(0.0, W - 1), mode=mode, oob_zero=False)
        out = interp_window(table, pos, mode=mode, oob_zero=False)
        valid = (pos >= 0.0) & (pos < W)
        return torch.where(valid[:, None], out, 0.0)

    def __repr__(self) -> str:
        return (
            f"WavetablePE(wavetable={type(self._wavetable).__name__}, "
            f"indexer={type(self._indexer).__name__}, "
            f"interpolation={self._interpolation.value})"
        )


class TimeWarpPE(ProcessingElement):
    """Variable-speed playback: rate in source-samples per output-sample.

    ``max_rate`` bounds |rate| for PE-valued rates (it sizes the source
    window a block pulls); scalar rates size the window exactly.
    """

    def __init__(
        self,
        source: ProcessingElement,
        rate=1.0,
        interpolation: InterpolationMode = InterpolationMode.LINEAR,
        max_rate: float = 4.0,
    ):
        self._source = source
        self._rate = rate
        self._rate_is_pe = isinstance(rate, ProcessingElement)
        self._interpolation = interpolation
        self._max_rate = abs(float(rate)) if not self._rate_is_pe else float(max_rate)
        self._pos_lock = threading.Lock()
        self._pending_pos = 0.0

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def rate(self):
        return self._rate

    @property
    def interpolation(self) -> InterpolationMode:
        return self._interpolation

    def seek(self, position: float) -> None:
        """Thread-safe tape-head seek: takes effect on the next block.

        As :meth:`ControlPE.set_value`, the live position rides in the
        carried state. Seeking before the first render sets the initial
        tape position.
        """
        with self._pos_lock:
            self._pending_pos = float(position)
            # version bump: an in-flight block's scatter must not overwrite
            # this write (engine.Program.run)
            self._eng_version = getattr(self, "_eng_version", 0) + 1
            st = self._eng_state
            if st is not None:
                self._eng_state = {"user": self._pos_on(st["user"].device), "next": st["next"]}

    @property
    def position(self) -> float:
        """Current tape-head position in source samples (a host read)."""
        st = self._eng_state
        if st is not None:
            return float(st["user"])
        return self._pending_pos

    def _pos_on(self, device) -> torch.Tensor:
        return torch.full((), self._pending_pos, dtype=prec.WIDE, device=device)

    def _eng_live_state(self, device):
        """Live payload for the engine's external-write-wins scatter
        (engine.Program.run), on ``device``, the block's."""
        with self._pos_lock:
            return self._pos_on(device)

    def inputs(self) -> list[ProcessingElement]:
        if self._rate_is_pe:
            return [self._source, self._rate]
        return [self._source]

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        # Reference semantics (timewarp_pe.py:88-137): rate-PE extent wins;
        # constant rate over a finite source maps the source bounds through
        # the tape-head trajectory pos = n·r.
        if self._rate_is_pe:
            return self._rate.extent()
        src = self._source.extent()
        if src.start is None or src.end is None:
            return Extent(None, None)
        src_start, src_end = float(src.start), float(src.end)
        r = float(self._rate)
        if r == 0.0:
            if src_start <= 0.0 < src_end:
                return Extent(None, None)
            return Extent(0, 0)
        if r > 0.0:
            n_start = max(0, int(math.ceil(src_start / r)) if src_start > 0 else 0)
            n_end = max(n_start, int(math.ceil(src_end / r)))
            return Extent(n_start, n_end)
        lower = src_end / r
        upper = src_start / r
        n_start = max(0, int(math.floor(lower)) + 1)
        n_end = max(n_start, int(math.floor(upper)) + 1)
        return Extent(n_start, n_end)

    def _trace(self, ctx):
        T = ctx.duration
        dev = ctx.device
        with self._pos_lock:
            init_pos = self._pending_pos
        pos0, _ = ctx.state(
            self, init=lambda: torch.full((), init_pos, dtype=prec.WIDE, device=dev)
        )
        if self._rate_is_pe:
            rate = ctx.param(self._rate, dtype=prec.WIDE)
            prefix = torch.cat([torch.zeros((1,), dtype=prec.WIDE, device=dev),
                                prefix_sum(rate[:-1])])
            total = rate.sum()
        else:
            # i * r is exact in float64 for a constant rate
            r = float(self._rate)
            prefix = torch.arange(T, dtype=prec.WIDE, device=dev) * r
            total = torch.full((), float(T) * r, dtype=prec.WIDE, device=dev)
        indices = pos0 + prefix
        ctx.set_state(self, pos0 + total)

        mode = _mode(self._interpolation)
        pad = 2 if mode == "cubic" else 1
        win_len = int(math.ceil(T * self._max_rate)) + 2 * pad + 2
        # the window's start is an index into the graph: read on the host
        win_start = int(torch.floor(indices.min()).item()) - pad
        window = ctx.pull_abs(self._source, win_start, win_len)
        pos = (indices - float(win_start)).to(torch.float32)
        out = interp_window(window, pos, mode=mode, oob_zero=True)

        # zero-mask indices outside the source extent (reference rule)
        src_ext = self._source.extent()
        valid = torch.ones((T,), dtype=torch.bool, device=dev)
        if src_ext.start is not None:
            valid &= indices >= src_ext.start
        if src_ext.end is not None:
            valid &= indices < src_ext.end
        return torch.where(valid[:, None], out, 0.0)

    def __repr__(self) -> str:
        r = type(self._rate).__name__ if self._rate_is_pe else self._rate
        return f"TimeWarpPE(source={type(self._source).__name__}, rate={r})"


def _blocked_prefix(x, block: int = 1024):
    """Inclusive prefix sum with a leading zero row, float32 throughout:
    local cumsums within ``block``-row tiles plus a cumsum over the tile
    totals (the JAX package's order, each cumsum XLA's)."""
    T, C = x.shape
    x = x.to(torch.float32)
    Tp = -(-T // block) * block
    xb = F.pad(x, (0, 0, 0, Tp - T)).reshape(Tp // block, block, C)
    loc = prefix_sum(xb, dim=1)
    base = prefix_sum(loc[:, -1, :])
    base = torch.cat([torch.zeros_like(base[:1]), base[:-1]])
    csum = (loc + base[:, None, :]).reshape(Tp, C)[:T]
    return torch.cat([torch.zeros_like(csum[:1]), csum])


class WindowPE(ProcessingElement):
    """Zero-phase centered window statistic (MAX/MIN/MEAN/RMS)."""

    def __init__(
        self,
        source: ProcessingElement,
        window: float = 0.05,
        mode: WindowMode = WindowMode.MAX,
        rectify: bool = True,
    ):
        self._source = source
        self._window = max(0.0, window)
        self._mode = mode
        self._rectify = rectify

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def window(self) -> float:
        return self._window

    @property
    def mode(self) -> WindowMode:
        return self._mode

    @property
    def rectify(self) -> bool:
        return self._rectify

    def inputs(self) -> list[ProcessingElement]:
        return [self._source]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        return self._source.extent()

    def _trace(self, ctx):
        half = max(1, int(self._window * ctx.sample_rate / 2))
        T = ctx.duration
        x = ctx.pull(self._source, shift=-half, duration=T + 2 * half)
        if self._rectify:
            x = x.abs()
        wsize = 2 * half + 1

        if self._mode == WindowMode.MAX:
            out = F.max_pool1d(x.T[None], wsize, stride=1)[0].T
        elif self._mode == WindowMode.MIN:
            out = -F.max_pool1d(-x.T[None], wsize, stride=1)[0].T
        else:
            # XLA divides by a constant as a product with its reciprocal
            inv = float(np.float32(1.0 / wsize))
            if self._mode == WindowMode.MEAN:
                csum = _blocked_prefix(x)
                out = (csum[wsize:] - csum[:-wsize]) * inv
            else:  # RMS
                csq = _blocked_prefix(x * x)
                out = sqrtf(torch.clamp_min((csq[wsize:] - csq[:-wsize]) * inv, 0.0))
        return out.to(prec.AUDIO)

    def __repr__(self) -> str:
        return (
            f"WindowPE(source={type(self._source).__name__}, "
            f"window={self._window}, mode={self._mode.value})"
        )
