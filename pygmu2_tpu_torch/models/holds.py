"""Latch and slew PEs, and CachePE.

Counterpart of ``pygmu2_tpu.models.holds``:
- SampleHoldPE  (reference: src/pygmu2/sample_hold_pe.py:21) — latch the
  source on positive trigger events.
- TrackHoldPE   (reference: src/pygmu2/track_hold_pe.py:21) — follow the
  source while gate=1, hold while 0.
- SlewLimiterPE (reference: src/pygmu2/slew_limiter_pe.py:36) — rate
  limiter, LINEAR (clamped step) or EXPONENTIAL (asymmetric one-pole).
- ControlPE     — a constant source whose value any thread may set
  between blocks (a live control: its value rides in the carried state).
- CachePE       (reference: src/pygmu2/cache_pe.py:21) — a pass-through
  marker: the engine's per-block memo renders a shared node once.

Both holds are parallel despite looking stateful: the last latched value
at index i is a cumulative max over event positions, then a gather. The
slew limiter's clamped or asymmetric update is serial: it runs in
``ops/slew.slew_scan`` (a hand-written kernel on the card).
"""

from __future__ import annotations

import threading

import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement, SourcePE
from pygmu2_tpu_torch.models.modes import SlewMode
from pygmu2_tpu_torch.ops import slew as _slew


def _latch(src, cond, carried):
    """out[i] = src[j] for the latest j <= i with cond[j]; carried before."""
    T = src.shape[0]
    idx = torch.arange(T, device=src.device)
    last = torch.cummax(torch.where(cond, idx, -1), dim=0).values
    picked = src[last.clamp(0, T - 1)]
    return torch.where(last >= 0, picked, carried)


class _HoldPE(ProcessingElement):
    """Shared pieces of the two latches: mono, stateful, unbounded."""

    def __init__(self, source, control, initial_value: float = 0.0):
        self._source = source
        self._control = control
        self._initial_value = float(initial_value)

    @property
    def initial_value(self) -> float:
        return self._initial_value

    def inputs(self) -> list[ProcessingElement]:
        return [self._source, self._control]

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int:
        return 1

    def _compute_extent(self) -> Extent:
        return Extent(None, None)

    def _latched(self, ctx, cond_of):
        control = ctx.pull(self._control)[:, 0]
        src = ctx.pull(self._source)[:, 0]
        held, _ = ctx.state(self, init=lambda: torch.full(
            (), self._initial_value, dtype=prec.AUDIO, device=ctx.device))
        out = _latch(src, cond_of(control), held)
        ctx.set_state(self, out[-1])
        return out[:, None]


class SampleHoldPE(_HoldPE):
    """Latch channel 0 of the source on each positive trigger sample."""

    def __init__(self, source, trigger, initial_value: float = 0.0):
        super().__init__(source, trigger, initial_value)

    def _trace(self, ctx):
        return self._latched(ctx, lambda trig: trig > 0)

    def __repr__(self) -> str:
        return (
            f"SampleHoldPE(source={type(self._source).__name__}, "
            f"trigger={type(self._control).__name__}, "
            f"initial_value={self._initial_value})"
        )


class TrackHoldPE(_HoldPE):
    """Follow the source while gate > 0.5; hold the last value while low."""

    def __init__(self, source, gate, initial_value: float = 0.0):
        super().__init__(source, gate, initial_value)

    def _trace(self, ctx):
        return self._latched(ctx, lambda gate: gate > 0.5)

    def __repr__(self) -> str:
        return (
            f"TrackHoldPE(source={type(self._source).__name__}, "
            f"gate={type(self._control).__name__}, "
            f"initial_value={self._initial_value})"
        )


class SlewLimiterPE(ProcessingElement):
    """Rate-limit a mono control signal (units/second)."""

    def state_decays(self) -> bool:
        return True  # slewed value catches the input after a finite warm-up

    def __init__(
        self,
        source: ProcessingElement,
        rise_rate: float,
        fall_rate: float | None = None,
        mode: SlewMode = SlewMode.LINEAR,
    ):
        if rise_rate <= 0:
            raise ValueError("rise_rate must be > 0")
        self._source = source
        self._rise_rate = float(rise_rate)
        self._fall_rate = float(fall_rate) if fall_rate is not None else self._rise_rate
        if self._fall_rate <= 0:
            raise ValueError("fall_rate must be > 0")
        self._mode = mode

    @property
    def rise_rate(self) -> float:
        return self._rise_rate

    @property
    def fall_rate(self) -> float:
        return self._fall_rate

    @property
    def mode(self) -> SlewMode:
        return self._mode

    def inputs(self) -> list[ProcessingElement]:
        return [self._source]

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int:
        return 1

    def _compute_extent(self) -> Extent:
        return Extent(None, None)

    def _trace(self, ctx):
        src = ctx.pull(self._source)[:, 0]
        sr = float(ctx.sample_rate)
        rise_dt = self._rise_rate / sr
        fall_dt = self._fall_rate / sr
        current0, _ = ctx.state(
            self, init=lambda: torch.zeros((), dtype=prec.AUDIO, device=ctx.device)
        )
        linear = self._mode == SlewMode.LINEAR
        if linear:
            p_rise, p_fall = rise_dt, fall_dt
        else:
            p_rise, p_fall = min(rise_dt, 1.0), min(fall_dt, 1.0)
        out, final = _slew.slew_scan(
            src.contiguous(), current0, linear=linear, p_rise=p_rise, p_fall=p_fall
        )
        ctx.set_state(self, final)
        return out[:, None]

    def __repr__(self) -> str:
        return (
            f"SlewLimiterPE(rise_rate={self._rise_rate}, "
            f"fall_rate={self._fall_rate}, mode={self._mode.value})"
        )


class ControlPE(SourcePE):
    """Constant-valued source whose value is settable from any thread.

    The live value rides in the carried state: ``set_value`` writes it
    between blocks (thread-safe), and a write that lands while a block
    renders is kept by ``Program.run`` (the PE's ``_eng_version``).
    """

    def __init__(self, initial_value: float = 0.0, channels: int = 1):
        self._initial = float(initial_value)
        self._pending = float(initial_value)
        self._lock = threading.Lock()
        self._channels = channels

    def set_value(self, value: float) -> None:
        """Thread-safe: takes effect on the next rendered block."""
        with self._lock:
            self._pending = float(value)
            # version bump: an in-flight block's scatter must not overwrite
            # this write (engine.Program.run)
            self._eng_version = getattr(self, "_eng_version", 0) + 1
            if self._eng_state is not None:
                self._eng_state = {
                    "user": self._value_on(self._eng_state["user"].device),
                    "next": self._eng_state["next"],
                }

    @property
    def value(self) -> float:
        return self._pending

    def _value_on(self, device) -> torch.Tensor:
        # a fill on the device, not a host-to-card copy (which would sync)
        return torch.full((), self._pending, dtype=torch.float32, device=device)

    def _eng_live_state(self, device):
        """Live payload for the engine's external-write-wins scatter
        (engine.Program.run), on ``device``, the block's."""
        with self._lock:
            return self._value_on(device)

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int:
        return self._channels

    def _compute_extent(self) -> Extent:
        return Extent(None, None)

    def _trace(self, ctx):
        with self._lock:
            init = self._pending
        val, _ = ctx.state(
            self,
            init=lambda: torch.full((), init, dtype=torch.float32, device=ctx.device),
            reset_on_gap=False,
        )
        ctx.set_state(self, val)
        return val.to(prec.AUDIO).expand(ctx.duration, self._channels).contiguous()

    def __repr__(self) -> str:
        return f"ControlPE(value={self._pending}, channels={self._channels})"


class CachePE(ProcessingElement):
    """Marker legalizing fan-out of an impure source inside composites.

    The engine's per-block memo already renders any node once per
    (start, duration); CachePE passes through and reports pure so the
    validator accepts multiple sinks (reference: cache_pe.py:47-50).
    """

    def __init__(self, source: ProcessingElement):
        self._source = source

    @property
    def source(self) -> ProcessingElement:
        return self._source

    def inputs(self) -> list[ProcessingElement]:
        return [self._source]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        return self._source.extent()

    def _trace(self, ctx):
        return ctx.pull(self._source)

    def __repr__(self) -> str:
        return f"CachePE(source={type(self._source).__name__})"
