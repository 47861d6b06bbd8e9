"""ReversePitchEchoPE — CCRMA-style pitch-shifting reverse echo.

Counterpart of ``pygmu2_tpu.models.reverse_echo`` (reference:
src/pygmu2/reverse_pitch_echo_pe.py:30-716):

1. dual-read-head time-domain pitch shifter (heads 180° apart,
   crossfaded by distance from the write head),
2. pitch-shifted audio written into fixed blocks (double buffered),
3. completed blocks played back reversed (or alternating direction)
   under a Hann window,
4. windowed output fed back into the write path.

All parameters (block length, pitch ratio, feedback, alternate) are
scalar-or-PE. The recurrence is data-dependent (feedback through the
block buffers, state-fed read positions): it runs in
``ops/reverse_echo.reverse_echo_scan`` (a hand-written kernel on the card)
for every block length, channel count and buffer capacity.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.ops import reverse_echo as _echo


class ReversePitchEchoPE(ProcessingElement):
    """Reverse echo with integrated time-domain pitch shifter."""

    _MAX_DELAY_SECONDS = 10.0
    _MIN_BLOCK_SAMPLES = 64
    _MAX_FEEDBACK = 0.995

    def __init__(
        self,
        source: ProcessingElement,
        block_seconds=0.25,
        pitch_ratio=1.0,
        feedback=0.85,
        alternate_direction=0.0,
        smoothing_samples: int = 2400,
        max_delay_seconds: float | None = None,
    ):
        self._source = source
        self._block_seconds = block_seconds
        self._pitch_ratio = pitch_ratio
        self._feedback = feedback
        self._alternate_direction = alternate_direction
        self._smoothing_samples = max(1, int(smoothing_samples))
        # the block buffers' capacity: shrink it when the effect uses
        # short blocks (the buffers are carried state)
        self._max_delay_seconds = float(max_delay_seconds or self._MAX_DELAY_SECONDS)

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def block_seconds(self):
        return self._block_seconds

    @property
    def pitch_ratio(self):
        return self._pitch_ratio

    @property
    def feedback(self):
        return self._feedback

    @property
    def alternate_direction(self):
        return self._alternate_direction

    def _params(self):
        return (self._block_seconds, self._pitch_ratio, self._feedback,
                self._alternate_direction)

    def inputs(self) -> list[ProcessingElement]:
        return [self._source] + [p for p in self._params() if isinstance(p, ProcessingElement)]

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _fills_own_edges(self) -> bool:
        # The echo rings past the source extent (feedback + the replayed
        # previous block); the reference produces this tail because it
        # never clips to extent. Opt out of the engine's zero-fill.
        return True

    def _compute_extent(self) -> Extent:
        ext = self._source.extent()
        for p in self._params():
            if isinstance(p, ProcessingElement):
                ext = ext.intersection(p.extent()) or ext
        return ext

    def _trace(self, ctx):
        x = ctx.pull(self._source)  # (T, C)
        T, C = x.shape
        sr = float(ctx.sample_rate)
        dev = ctx.device
        max_delay = max(self._MIN_BLOCK_SAMPLES + 1, int(self._max_delay_seconds * sr))
        pitch_len = max(2, int(sr / 60))

        block_v = ctx.param(self._block_seconds, dtype=prec.AUDIO)
        pitch_v = torch.clamp(ctx.param(self._pitch_ratio, dtype=prec.AUDIO), min=0.001)
        fb_v = torch.clamp(
            torch.nan_to_num(ctx.param(self._feedback, dtype=prec.AUDIO)),
            -self._MAX_FEEDBACK, self._MAX_FEEDBACK,
        )
        alt_v = ctx.param(self._alternate_direction, dtype=prec.AUDIO)

        init_seconds = (
            0.25 if isinstance(self._block_seconds, ProcessingElement)
            else float(self._block_seconds)
        )
        init_block = float(min(max(init_seconds * sr, self._MIN_BLOCK_SAMPLES), max_delay - 1))

        def init():
            zeros = lambda rows: torch.zeros((rows, C), dtype=prec.AUDIO, device=dev)  # noqa: E731
            i32 = lambda v: torch.full((), v, dtype=torch.int32, device=dev)  # noqa: E731
            return {
                "buf_a": zeros(max_delay),
                "buf_b": zeros(max_delay),
                "cur_is_a": i32(1),
                "pitch_buf": zeros(pitch_len),
                "p_wpos": i32(0),
                "p_rpos": torch.zeros((), dtype=torch.float32, device=dev),
                "w_idx": i32(0),
                "r_idx": i32(0),
                "smoothed": torch.full((), init_block, dtype=torch.float32, device=dev),
                "cur_block": i32(int(init_block)),
                "prev_block": i32(0),
                "reverse": i32(1),
            }

        st, _ = ctx.state(self, init=init)
        misc = torch.stack([st[k].to(torch.float32) for k in _echo.MISC_FIELDS])
        # The kernel takes every case: the JAX package's block path for a
        # static, exactly representable block length at unity pitch
        # (ops/reverse_echo_block.py) computes the same recurrence.
        wet, ba, bb, pb, misc2 = _echo.reverse_echo_scan(
            x.to(torch.float32), block_v, pitch_v, fb_v, alt_v,
            st["buf_a"], st["buf_b"], st["pitch_buf"], misc,
            sr=sr, plen=pitch_len, cap=max_delay, min_block=self._MIN_BLOCK_SAMPLES,
            max_block=max_delay - 1, smooth_alpha=1.0 / self._smoothing_samples,
        )
        new = {"buf_a": ba, "buf_b": bb, "pitch_buf": pb,
               **dict(zip(_echo.MISC_FIELDS, misc2))}
        ctx.set_state(self, {k: new[k].to(v.dtype) for k, v in st.items()})
        return wet

    def __repr__(self) -> str:
        return f"ReversePitchEchoPE(source={type(self._source).__name__})"
