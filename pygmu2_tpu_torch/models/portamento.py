"""PortamentoPE — pitch-glide control stream.

Counterpart of ``pygmu2_tpu.models.portamento``, the reference PortamentoPE (reference:
src/pygmu2/portamento_pe.py:23-285): from a list of
``(pitch, sample_index, duration)`` notes, emit a pitch stream that holds
each note's pitch and glides to the next over an adaptive ramp
(``min(max_ramp_seconds, ramp_fraction × note_duration)``), holding the
first/last pitch outside the note range.

The reference composes DelayPE/CropPE/SequencePE per transition; since
the result is a single monotone-in-time breakpoint function, it is
ONE PiecewisePE here, as in the JAX package:
breakpoints (note[i].start, prev_pitch) → (note[i].start + ramp, pitch).
Ramps that would overrun the next note's start are shortened to keep the
curve well-ordered.
"""

from __future__ import annotations

from pygmu2_tpu_torch.core.extent import Extent, ExtendMode
from pygmu2_tpu_torch.core.processing_element import ProcessingElement, SourcePE
from pygmu2_tpu_torch.models.piecewise import PiecewisePE
from pygmu2_tpu_torch.models.modes import TransitionType


class PortamentoPE(SourcePE):
    """Glide between scheduled pitches; infinite extent, holds at edges."""

    def __init__(
        self,
        notes,
        max_ramp_seconds: float = 0.1,
        ramp_fraction: float = 0.3,
        channels: int = 1,
    ):
        if not notes:
            raise ValueError("PortamentoPE: notes list cannot be empty")
        if max_ramp_seconds < 0:
            raise ValueError(
                f"PortamentoPE: max_ramp_seconds must be non-negative "
                f"(got {max_ramp_seconds})"
            )
        if not (0.0 <= ramp_fraction <= 1.0):
            raise ValueError(
                f"PortamentoPE: ramp_fraction must be between 0 and 1 "
                f"(got {ramp_fraction})"
            )
        if channels < 1:
            raise ValueError(
                f"PortamentoPE: channels must be >= 1 (got {channels})"
            )
        self._notes = sorted(notes, key=lambda x: x[1])
        self._max_ramp_seconds = float(max_ramp_seconds)
        self._ramp_fraction = float(ramp_fraction)
        self._channels = int(channels)
        self._curve = self._build_curve()

    @property
    def notes(self):
        return self._notes.copy()

    @property
    def max_ramp_seconds(self) -> float:
        return self._max_ramp_seconds

    @property
    def ramp_fraction(self) -> float:
        return self._ramp_fraction

    def _build_curve(self) -> PiecewisePE:
        max_ramp = max(1, int(round(self._max_ramp_seconds * self.sample_rate)))
        points: list[tuple[int, float]] = []
        first_pitch, first_start, _ = self._notes[0]
        points.append((first_start, float(first_pitch)))
        for i in range(len(self._notes) - 1):
            prev_pitch = float(self._notes[i][0])
            curr_pitch, curr_start, curr_duration = self._notes[i + 1]
            ramp = max(1, min(max_ramp, int(round(curr_duration * self._ramp_fraction))))
            if i + 2 < len(self._notes):
                ramp = min(ramp, max(1, self._notes[i + 2][1] - curr_start))
            points.append((curr_start, prev_pitch))
            points.append((curr_start + ramp, float(curr_pitch)))
        return PiecewisePE(
            points,
            transition_type=TransitionType.LINEAR,
            extend_mode=ExtendMode.HOLD_BOTH,
            channels=self._channels,
        )

    def inputs(self) -> list[ProcessingElement]:
        return [self._curve]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int:
        return self._channels

    def _compute_extent(self) -> Extent:
        return Extent(None, None)

    def _fills_own_edges(self) -> bool:
        return True

    def _trace(self, ctx):
        return ctx.pull(self._curve)

    def __repr__(self) -> str:
        return (
            f"PortamentoPE({len(self._notes)} notes, "
            f"max_ramp_seconds={self._max_ramp_seconds}, "
            f"ramp_fraction={self._ramp_fraction})"
        )
