"""Trigger-driven restart and random selection.

Counterpart of ``pygmu2_tpu.models.trigger_restart``:

- TriggerRestartPE (reference: src/pygmu2/trigger_restart_pe.py:18-98) —
  on each positive trigger, restart the source from its own t=0.
- RandomSelectPE (reference: src/pygmu2/random_select_pe.py:22-172) —
  on each positive trigger, pick a weighted-random input and play it from
  its start.
- TriggerPE — a gate-edge-driven clip player (ONE_SHOT or GATED).
- ResetPE — re-anchor the source's local time on each rising edge.

The source's whole finite extent is rendered once per block
(``ctx.pull_abs``) and a restart is a gather at ``t - t_last_event``, the
last-event time a running maximum (``torch.cummax``) carried across
blocks. Selection randomness is a counter hash of the event time. Sources
must have a finite extent (wrap infinite sources in CropPE).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.ops.noise import hash_u32

_NO_EVENT = -(2**62)


def _clip_pick(clip, pos):
    """``clip[pos]`` for (L, C) clips and (T,) positions (the JAX package
    routes it through an exact one-hot contraction)."""
    return clip[pos.to(torch.int64)]


def _finite_len(pe: ProcessingElement, what: str) -> tuple[int, int]:
    ext = pe.extent()
    if ext.start is None or ext.end is None:
        raise ValueError(
            f"{what} requires a source with finite extent (got {ext}); "
            "wrap it in CropPE."
        )
    return ext.start, ext.end - ext.start


def _no_event(ctx):
    return torch.full((), _NO_EVENT, dtype=prec.INDEX, device=ctx.device)


def _latch(events, carry):
    """Running maximum of the event times, entering with ``carry``."""
    return torch.cummax(torch.maximum(events, carry), dim=0).values


def _event_latch(ctx, self_pe, trig, t):
    """Absolute time of the latest positive trigger at/before each sample
    (carried across blocks); _NO_EVENT where none has occurred yet."""
    t0_carry, _ = ctx.state(self_pe, init=lambda: _no_event(ctx))
    t0 = _latch(torch.where(trig > 0, t, _NO_EVENT), t0_carry)
    ctx.set_state(self_pe, t0[-1])
    return t0


def _rising_edges(ctx, self_pe, gate, init_t0):
    """(edge mask, carried latch): a rising edge is a positive sample after
    a non-positive one; the previous gate sample is carried."""
    (prev_g, t0_carry), _ = ctx.state(
        self_pe,
        init=lambda: (torch.zeros((), dtype=prec.AUDIO, device=ctx.device), init_t0()),
    )
    prev = torch.cat([prev_g[None], gate[:-1]])
    return (gate > 0) & (prev <= 0), t0_carry


class TriggerRestartPE(ProcessingElement):
    """Restart the source from local t=0 on every positive trigger."""

    def __init__(self, trigger, src: ProcessingElement):
        self._trigger = trigger
        self._src = src

    def inputs(self) -> list[ProcessingElement]:
        return [self._trigger, self._src]

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int | None:
        return self._src.channel_count()

    def resolve_channel_count(self, input_channel_counts: list[int]) -> int:
        if len(input_channel_counts) != 2:
            raise ValueError("TriggerRestartPE expects exactly two inputs")
        return input_channel_counts[1]

    def _compute_extent(self) -> Extent:
        return self._trigger.extent()

    def _trace(self, ctx):
        trig = ctx.pull(self._trigger)[:, 0]
        t = ctx.times()
        src_start, src_len = _finite_len(self._src, "TriggerRestartPE")
        clip = ctx.pull_abs(self._src, src_start, src_len)  # (L, C)

        t0 = _event_latch(ctx, self, trig, t)
        local = t - t0
        valid = (t0 != _NO_EVENT) & (local >= 0) & (local < src_len)
        pos = local.clamp(0, src_len - 1)
        return torch.where(valid[:, None], _clip_pick(clip, pos), 0.0)

    def __repr__(self) -> str:
        return (
            f"TriggerRestartPE(trigger={type(self._trigger).__name__}, "
            f"src={type(self._src).__name__})"
        )


class RandomSelectPE(ProcessingElement):
    """Weighted-random input selection on each positive trigger."""

    def __init__(self, trigger, inputs, weights=None, seed: int | None = None):
        if not inputs:
            raise ValueError("RandomSelectPE requires at least one input")
        if weights is not None and len(weights) != len(inputs):
            raise ValueError("weights must have the same length as inputs")
        self._trigger = trigger
        self._sources = list(inputs)
        self._weights = list(weights) if weights is not None else None
        self._seed = seed
        self._cum_cache: dict = {}

    def inputs(self) -> list[ProcessingElement]:
        return [self._trigger] + self._sources

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int | None:
        return self._sources[0].channel_count()

    def resolve_channel_count(self, input_channel_counts: list[int]) -> int:
        if len(input_channel_counts) < 2:
            raise ValueError("RandomSelectPE has no audio inputs")
        audio = input_channel_counts[1:]
        first = audio[0]
        for i, cc in enumerate(audio[1:], start=2):
            if cc != first:
                raise ValueError(
                    f"RandomSelectPE channel mismatch: input 1 has {first}, "
                    f"input {i} has {cc}"
                )
        return first

    def _compute_extent(self) -> Extent:
        return self._trigger.extent()

    def _tables(self, device, lens):
        """Cumulative weights (float32) and clip lengths on ``device``,
        copied there once."""
        key = str(device)
        if key not in self._cum_cache:
            w = np.asarray(
                self._weights if self._weights is not None else [1.0] * len(self._sources),
                dtype=np.float64,
            )
            cum = np.cumsum(w / w.sum()).astype(np.float32)
            self._cum_cache[key] = (
                torch.from_numpy(cum).to(device),
                torch.as_tensor(lens, dtype=prec.INDEX).to(device),
            )
        return self._cum_cache[key]

    def _trace(self, ctx):
        trig = ctx.pull(self._trigger)[:, 0]
        t = ctx.times()

        clips = [_finite_len(src, "RandomSelectPE") for src in self._sources]
        max_len = max(length for _, length in clips)
        stacked = []
        for src, (s0, length) in zip(self._sources, clips):
            clip = ctx.pull_abs(src, s0, length)
            if length < max_len:
                clip = torch.cat([clip, clip.new_zeros((max_len - length, clip.shape[1]))])
            stacked.append(clip)
        flat = torch.cat(stacked)  # (K * max_len, C)
        cum, lens = self._tables(ctx.device, [length for _, length in clips])

        t0 = _event_latch(ctx, self, trig, t)

        # Weighted choice keyed by the event time (stable per event): XLA
        # folds (w 2^-31 - 1 + 1) 0.5 into w 2^-32, exact
        word = hash_u32(t0, seed=(self._seed or 0) ^ 0x5EED).to(torch.float32)
        u = word * 2.0 ** -32
        k = torch.searchsorted(cum, u, right=True).clamp(0, len(self._sources) - 1)

        local = t - t0
        valid = (t0 != _NO_EVENT) & (local >= 0) & (local < lens[k])
        pos = local.clamp(0, max_len - 1)
        out = _clip_pick(flat, k * max_len + pos)  # (T, C)
        return torch.where(valid[:, None], out, 0.0)

    def __repr__(self) -> str:
        return (
            f"RandomSelectPE(trigger={type(self._trigger).__name__}, "
            f"n_inputs={len(self._sources)})"
        )


class TriggerMode(enum.Enum):
    """TriggerPE playback policy (see :class:`TriggerPE`)."""

    ONE_SHOT = "one_shot"
    GATED = "gated"


class TriggerPE(ProcessingElement):
    """Gate-edge-driven clip player: a rising edge of ``gate`` starts the
    finite ``source`` from its local t=0.

    Modes:
        ONE_SHOT — once started, the clip plays to its end regardless of
            the gate; rising edges DURING playback are ignored. A new edge
            after the clip ends restarts.
        GATED — output follows the gate: a rising edge (re)starts the
            clip, and the output cuts to silence whenever the gate is low.

    Edge detection carries the previous gate sample across blocks, so
    chunked rendering is exact at any block size. ONE_SHOT accepts an edge
    only when idle: its clip length is a refractory period, so at most
    ``T // src_len + 1`` edges are accepted a block, found by as many jumps
    to the next edge (a reverse running minimum of the edge positions),
    all on the device: the loop's length is fixed by the shapes, and no
    value is read back to the host. GATED is a running-maximum latch.
    """

    def __init__(self, gate, source: ProcessingElement,
                 mode: TriggerMode = TriggerMode.ONE_SHOT):
        self._gate = gate
        self._source = source
        self._mode = mode

    @property
    def gate(self):
        return self._gate

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def mode(self) -> TriggerMode:
        return self._mode

    def inputs(self) -> list[ProcessingElement]:
        return [self._gate, self._source]

    def is_pure(self) -> bool:
        return False

    def state_decays(self) -> bool:
        return False  # the latched start time never converges on its own

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def resolve_channel_count(self, input_channel_counts: list[int]) -> int:
        if len(input_channel_counts) != 2:
            raise ValueError("TriggerPE expects exactly two inputs")
        return input_channel_counts[1]

    def _compute_extent(self) -> Extent:
        return self._gate.extent()

    def _accepted(self, edge, t, t0_carry, src_len):
        """ONE_SHOT's accepted edges, as a (T,) bool mask."""
        T = int(t.shape[0])
        dev = t.device
        k_jumps = T // max(src_len, 1) + 1
        idx = torch.arange(T, dtype=torch.int64, device=dev)
        e_pos = torch.where(edge, idx, T)
        # first edge position at/after each sample (reverse running minimum)
        nxt = torch.flip(torch.cummin(torch.flip(e_pos, [0]), 0).values, [0])
        # first idle sample, relative to the block start
        r = torch.where(t0_carry == _NO_EVENT, torch.zeros_like(t0_carry),
                        t0_carry + src_len - t[0]).clamp(0, T)
        acc = torch.zeros((T,), dtype=torch.int32, device=dev)
        for _ in range(k_jumps):
            p = torch.where(r >= T, T, nxt[r.clamp(0, T - 1)])
            hit = p < T
            acc.scatter_reduce_(0, p.clamp(0, T - 1)[None], hit.to(torch.int32)[None], "amax")
            r = torch.where(hit, p + src_len, T)
        return acc > 0

    def _trace(self, ctx):
        gate = ctx.pull(self._gate)[:, 0]
        t = ctx.times()
        src_start, src_len = _finite_len(self._source, "TriggerPE")
        clip = ctx.pull_abs(self._source, src_start, src_len)  # (L, C)

        edge, t0_carry = _rising_edges(ctx, self, gate, lambda: _no_event(ctx))
        if self._mode == TriggerMode.GATED:
            # parallel latch: every rising edge restarts
            events = torch.where(edge, t, _NO_EVENT)
        else:
            events = torch.where(self._accepted(edge, t, t0_carry, src_len), t, _NO_EVENT)
        t0 = _latch(events, t0_carry)
        ctx.set_state(self, (gate[-1], t0[-1]))

        local = t - t0
        valid = (t0 != _NO_EVENT) & (local >= 0) & (local < src_len)
        if self._mode == TriggerMode.GATED:
            valid = valid & (gate > 0)
        pos = local.clamp(0, src_len - 1)
        return torch.where(valid[:, None], _clip_pick(clip, pos), 0.0)

    def __repr__(self) -> str:
        return (
            f"TriggerPE(gate={type(self._gate).__name__}, "
            f"source={type(self._source).__name__}, mode={self._mode.value})"
        )


class ResetPE(ProcessingElement):
    """Re-anchor the source's local time to 0 on each rising edge of
    ``trigger``; before the first edge the source passes through at
    absolute time.

    Differences from TriggerPE: no playback gate (output never cuts on
    trigger-low), retriggers are always honored (every rising edge
    re-anchors), and the un-reset passthrough anchors at t=0. The source
    must have finite extent (wrap infinite sources in CropPE).
    """

    def __init__(self, source: ProcessingElement, trigger):
        self._source = source
        self._trigger = trigger

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def trigger(self):
        return self._trigger

    def inputs(self) -> list[ProcessingElement]:
        return [self._source, self._trigger]

    def is_pure(self) -> bool:
        return False

    def state_decays(self) -> bool:
        return False  # the latched reset time never converges on its own

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def resolve_channel_count(self, input_channel_counts: list[int]) -> int:
        if len(input_channel_counts) != 2:
            raise ValueError("ResetPE expects exactly two inputs")
        return input_channel_counts[0]

    def _compute_extent(self) -> Extent:
        return self._trigger.extent()

    def _trace(self, ctx):
        trig = ctx.pull(self._trigger)[:, 0]
        t = ctx.times()
        src_start, src_len = _finite_len(self._source, "ResetPE")
        clip = ctx.pull_abs(self._source, src_start, src_len)  # (L, C)

        zero = lambda: torch.zeros((), dtype=prec.INDEX, device=ctx.device)  # noqa: E731
        edge, t0_carry = _rising_edges(ctx, self, trig, zero)
        t0 = _latch(torch.where(edge, t, _NO_EVENT), t0_carry)
        ctx.set_state(self, (trig[-1], t0[-1]))

        # the source is evaluated at absolute time (t - t0): passthrough
        # before any reset (t0 = 0), re-anchored to its own time origin
        # after each edge — including the source extent's own offset
        local = t - t0 - src_start
        valid = (local >= 0) & (local < src_len)
        pos = local.clamp(0, src_len - 1)
        return torch.where(valid[:, None], _clip_pick(clip, pos), 0.0)

    def __repr__(self) -> str:
        return (
            f"ResetPE(source={type(self._source).__name__}, "
            f"trigger={type(self._trigger).__name__})"
        )
