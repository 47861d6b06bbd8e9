"""RandomPE — random control-signal source (sample/hold, interpolated,
random walk), optionally re-seeded by a trigger input.

Counterpart of ``pygmu2_tpu.models.random_control`` (the reference ships
this PE only as a disabled draft, src/pygmu2/random_pe.py-disabled:73).
The values are a counter hash (:func:`pygmu2_tpu_torch.ops.noise.white_uniform`),
bit for bit the JAX package's:

- Clocked modes (no trigger) are pure functions of the absolute sample
  index: segment k = floor(t * rate / sr), value(k) = hash(seed, k).
  LINEAR interpolates between segment values; SMOOTH uses the cubic
  smoothstep 3f²−2f³.
- With a ``trigger`` input, a new value is drawn on each positive
  trigger sample, keyed by the cumulative trigger count (the only carried
  state besides the walk's value).
- WALK is a bounded random walk, reflected at the range edges
  (:meth:`RandomPE._fold_np`). The reflection is nonlinear, so the walk is
  sequential: the JAX package scans it per segment (clocked) or per
  sample (triggered, and clocked near the sample rate). Its value changes
  only where a new segment starts or the trigger fires, so the port steps
  over the block's events alone, on the host in float32 numpy with the
  JAX program's operations, and hands the block back to the device
  expanded by the latest event, copied from pinned memory behind the
  block's work (no sync). A clocked walk's events are its segments, known
  on the host from the block's start, and so is the state it carries: it
  reads nothing from the device. A triggered walk reads the trigger and
  its carried state in one download a block, the one device sync it costs.
"""

from __future__ import annotations

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement, SourcePE
from pygmu2_tpu_torch.models.modes import RandomMode
from pygmu2_tpu_torch.ops.noise import hash_u32, white_uniform_np
from pygmu2_tpu_torch.ops.xla_math import fmaf

_LANE = 11  # decorrelate RandomPE streams from NoisePE streams
_F32 = np.float32
_NO_SEGMENT = np.iinfo(np.int32).min  # the clocked walk's initial segment


def _upload(arr: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev``. On the card the copy goes from pinned
    memory and is queued behind the block's work, where a copy from
    pageable memory would wait for the stream."""
    t = torch.from_numpy(arr)
    if torch.device(dev).type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


class RandomPE(SourcePE):
    """Random control signal in ``[min_value, max_value]``, mono, infinite.

    Args:
        rate: new values per second (clocked modes; ignored when a
            trigger drives the PE).
        min_value / max_value: output range.
        mode: ``RandomMode`` — SAMPLE_HOLD, LINEAR, SMOOTH, or WALK.
        seed: stream seed; None uses seed 0.
        trigger: optional trigger PE; each positive sample draws a new
            value (SAMPLE_HOLD/LINEAR/SMOOTH hold it; WALK takes a step).
        step_size: WALK step scale as a fraction of the range.
    """

    def __init__(
        self,
        rate: float = 1.0,
        min_value: float = 0.0,
        max_value: float = 1.0,
        mode: RandomMode = RandomMode.SAMPLE_HOLD,
        seed: int | None = None,
        trigger: ProcessingElement | None = None,
        step_size: float = 0.1,
    ):
        if rate <= 0:
            raise ValueError(f"RandomPE rate must be > 0, got {rate}")
        if max_value < min_value:
            raise ValueError("RandomPE requires max_value >= min_value")
        if step_size <= 0:
            raise ValueError(f"RandomPE step_size must be > 0, got {step_size}")
        self._rate = float(rate)
        self._min_value = float(min_value)
        self._max_value = float(max_value)
        self._mode = mode
        self._seed = seed
        self._trigger = trigger
        self._step_size = float(step_size)
        # the clocked walk's last stored state tensors and their host values
        self._walk_stored = None

    # ---- properties ------------------------------------------------------

    @property
    def rate(self) -> float:
        return self._rate

    @property
    def min_value(self) -> float:
        return self._min_value

    @property
    def max_value(self) -> float:
        return self._max_value

    @property
    def mode(self) -> RandomMode:
        return self._mode

    @property
    def seed(self) -> int | None:
        return self._seed

    @property
    def trigger(self) -> ProcessingElement | None:
        return self._trigger

    @property
    def step_size(self) -> float:
        return self._step_size

    # ---- graph contract --------------------------------------------------

    def inputs(self) -> list[ProcessingElement]:
        return [self._trigger] if self._trigger is not None else []

    def is_pure(self) -> bool:
        # Clocked hold/interp modes are pure functions of absolute time;
        # WALK and triggered modes carry state.
        return self._trigger is None and self._mode != RandomMode.WALK

    def state_decays(self) -> bool:
        return self.is_pure()

    def channel_count(self) -> int:
        return 1

    def _compute_extent(self) -> Extent:
        return Extent(None, None)

    # ---- value streams ---------------------------------------------------

    def _value(self, k):
        """Hash segment/trigger ordinal -> uniform in [min, max]: XLA folds
        ``(w 2^-31 - 1 + 1) 0.5 span + min`` into one fused multiply-add
        of the hash word ``w``."""
        word = hash_u32(k, seed=self._seed or 0, lane=_LANE).to(torch.float32)
        span = float(_F32(self._max_value - self._min_value))
        return fmaf(word, 2.0 ** -32 * span, float(_F32(self._min_value)))

    def _steps_np(self, k, lane):
        """The walk's steps for ordinals ``k`` (host numpy, float32):
        ``u * step_size * span`` is one product by the float32 product of
        the two constants, as XLA folds it."""
        span = _F32(self._max_value - self._min_value)
        u = white_uniform_np(np.asarray(k, np.int64), seed=self._seed or 0, lane=lane)
        return u * _F32(_F32(self._step_size) * span)

    def _fold_np(self, v):
        """Reflect a float32 scalar into [min, max] (triangle fold), with
        the JAX program's float32 operations: XLA folds ``v - lo - span``
        into one subtraction of the float32 sum ``lo + span``."""
        lo = _F32(self._min_value)
        span = _F32(self._max_value - self._min_value)
        if span == 0.0:
            return lo
        x = _F32(v - _F32(lo + span))
        two = _F32(2.0) * span
        r = np.fmod(x, two)  # jnp.mod: exact, with the divisor's sign
        if r != 0 and (r < 0) != (two < 0):
            r = _F32(r + two)
        return _F32(lo + abs(_F32(r - span)))

    def _trace(self, ctx):
        if self._trigger is not None:
            out = self._trace_triggered(ctx)
        elif self._mode == RandomMode.WALK:
            out = self._trace_walk_clocked(ctx)
        else:
            out = self._trace_clocked(ctx)
        return out.to(prec.AUDIO)[:, None]

    def _segments(self, ctx):
        """(k, frac): segment ordinal + position inside it, per sample."""
        t = ctx.times().to(torch.float64)
        pos = t * (self._rate / ctx.sample_rate)
        k = torch.floor(pos)
        return k.to(torch.int64), (pos - k).to(torch.float32)

    def _trace_clocked(self, ctx):
        k, frac = self._segments(ctx)
        v0 = self._value(k)
        if self._mode == RandomMode.SAMPLE_HOLD:
            return v0
        v1 = self._value(k + 1)
        if self._mode == RandomMode.SMOOTH:
            frac = frac * frac * (3.0 - 2.0 * frac)
        return fmaf(v1 - v0, frac, v0)

    def _walk(self, v, ordinals, lane):
        """Step the walk once per ordinal from float32 ``v``; returns the
        values after each step."""
        steps = self._steps_np(ordinals, lane)
        vals = np.empty(len(steps), _F32)
        for i, s in enumerate(steps):
            v = self._fold_np(_F32(v + s))
            vals[i] = v
        return v, vals

    def _walk_carry(self, pk0, v0, fresh, mid):
        """The clocked walk's carried (segment, value) on the host: the
        initial state when ``fresh``, the values this PE computed for the
        tensors it stored last, else (a restored snapshot) one float64
        download."""
        if fresh:
            return _NO_SEGMENT, _F32(mid)
        stored = self._walk_stored
        if stored is not None and stored[0] is pk0 and stored[1] is v0:
            return stored[2], stored[3]
        pk, v = torch.stack([pk0.to(torch.float64), v0.to(torch.float64)]).cpu().tolist()
        return int(pk), _F32(v)

    def _trace_walk_clocked(self, ctx):
        T = ctx.duration
        dev = ctx.device
        mid = 0.5 * (self._min_value + self._max_value)
        init = lambda: (  # noqa: E731
            torch.full((), _NO_SEGMENT, dtype=torch.int64, device=dev),
            torch.full((), mid, dtype=torch.float32, device=dev),
        )
        (pk0, v0), fresh = ctx.state(self, init=init, reset_on_gap=True)
        # the segment of every sample, as the device computes it (float64)
        t = np.arange(ctx.start, ctx.start + T, dtype=np.int64).astype(np.float64)
        k = np.floor(t * (self._rate / ctx.sample_rate)).astype(np.int64)
        pk, v = self._walk_carry(pk0, v0, fresh, mid)
        v_in = v
        # segments entered in this block, in order (k never decreases);
        # the walk steps once on entering each segment past pk
        first = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
        entered = k[first]
        step = entered > pk
        # (the JAX package scans per segment while the block spans few of
        # them, else per sample; both step once per segment entered)
        v, vals = self._walk(v, entered[step], _LANE)
        # the value held over each run of equal k: the carry until the
        # first step, then the value after the latest step
        held = np.full(len(entered), v_in, _F32)
        n_steps = np.cumsum(step)
        held[n_steps > 0] = vals[n_steps[n_steps > 0] - 1]
        out = np.repeat(held, np.diff(np.r_[first, T]))
        pk = max(pk, int(k[-1]))
        stored = (torch.full((), pk, dtype=torch.int64, device=dev),
                  torch.full((), float(v), dtype=torch.float32, device=dev))
        ctx.set_state(self, stored)
        self._walk_stored = (*stored, pk, v)
        return _upload(out, dev)

    def _trace_triggered(self, ctx):
        dev = ctx.device
        trig = ctx.pull(self._trigger)[:, 0] > 0
        mid = 0.5 * (self._min_value + self._max_value)
        init = lambda: (  # noqa: E731
            torch.zeros((), dtype=torch.int32, device=dev),  # cumulative trigger count
            torch.full((), mid, dtype=torch.float32, device=dev),  # walk value
        )
        (c0, v0), _ = ctx.state(self, init=init, reset_on_gap=True)
        count = (c0 + torch.cumsum(trig.to(torch.int32), 0)).to(torch.int32)
        if self._mode != RandomMode.WALK:
            # hold the value drawn at the latest trigger (count ordinal)
            out = self._value(count)
            ctx.set_state(self, (count[-1], out[-1].to(torch.float32)))
            return out
        # WALK: one reflected step per trigger, keyed by the trigger ordinal.
        # The block's one sync: the trigger and the carried (count, value),
        # exact in one float64 download
        host = torch.cat([trig.to(torch.float64),
                          torch.stack([c0.to(torch.float64), v0.to(torch.float64)])]).cpu()
        host = host.numpy()
        n_fired = int(np.count_nonzero(host[:-2]))
        c, v_in = int(host[-2]), _F32(host[-1])
        v, vals = self._walk(v_in, c + 1 + np.arange(n_fired), _LANE + 1)
        # each sample holds the value after the latest trigger at or before it
        vals = _upload(np.r_[v_in, vals].astype(np.float32), dev)
        out = vals[torch.cumsum(trig.to(torch.int64), 0)]
        ctx.set_state(self, (count[-1], torch.full((), float(v), dtype=torch.float32,
                                                   device=dev)))
        return out

    def __repr__(self) -> str:
        extra = (
            f", trigger={type(self._trigger).__name__}"
            if self._trigger is not None
            else ""
        )
        return (
            f"RandomPE(rate={self._rate}, "
            f"range=[{self._min_value}, {self._max_value}], "
            f"mode={self._mode.value}{extra})"
        )
