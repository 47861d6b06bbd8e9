"""Dynamics processing: gain computer + all-in-one composites.

Counterpart of ``pygmu2_tpu.models.dynamics``:
- DynamicsPE (reference: src/pygmu2/dynamics_pe.py:29-386) — gain
  computer driven by an EXTERNAL envelope PE (sidechain-capable);
  COMPRESS/EXPAND/LIMIT/GATE with quadratic soft knee and auto makeup;
  stereo_link takes the max across envelope channels. Pure — state lives
  in the envelope PE. Elementwise tensor ops.
- CompressorPE / LimiterPE / ExpanderPE (reference:
  src/pygmu2/compressor_pe.py:24-325) — composites over
  ``CachePE(src) → EnvelopePE → DynamicsPE``.
"""

from __future__ import annotations

import math

import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.models.envelopes import EnvelopePE
from pygmu2_tpu_torch.models.holds import CachePE
from pygmu2_tpu_torch.models.modes import DetectionMode, DynamicsMode


class DynamicsPE(ProcessingElement):
    """Envelope-driven gain computer (dB-domain static curve)."""

    AUTO = "auto"

    def __init__(
        self,
        source: ProcessingElement,
        envelope: ProcessingElement,
        threshold: float = -20.0,
        ratio: float = 4.0,
        knee: float = 0.0,
        makeup_gain="auto",
        mode: DynamicsMode = DynamicsMode.COMPRESS,
        stereo_link: bool = True,
        gate_range: float = -80.0,
    ):
        self._source = source
        self._envelope = envelope
        self._threshold = threshold
        self._ratio = max(0.001, ratio)
        self._knee = max(0.0, knee)
        self._makeup_gain = makeup_gain
        self._mode = mode
        self._stereo_link = stereo_link
        self._range = gate_range
        if makeup_gain == self.AUTO:
            self._makeup_gain_db = self._compute_auto_makeup()
        else:
            self._makeup_gain_db = float(makeup_gain)

    def _compute_auto_makeup(self) -> float:
        """Compensate ~70% of the reduction at threshold+12 dB
        (host-side scalar math; never touches the device at init)."""
        if self._mode in (DynamicsMode.EXPAND, DynamicsMode.GATE):
            return 0.0
        level_db = self._threshold + 12.0
        ratio = math.inf if self._mode == DynamicsMode.LIMIT else self._ratio
        slope = -1.0 if math.isinf(ratio) else (1.0 / ratio - 1.0)
        knee = self._knee
        overshoot = level_db - self._threshold  # = 12
        if knee <= 0 or level_db > self._threshold + knee / 2.0:
            gain_db = overshoot * slope
        else:
            x = overshoot + knee / 2.0
            gain_db = slope * (x**2) / (2 * knee)
        return -gain_db * 0.7

    def _gain_db(self, level_db):
        threshold = self._threshold
        ratio = self._ratio
        knee = self._knee
        mode = self._mode
        if mode == DynamicsMode.LIMIT:
            ratio = math.inf

        if mode in (DynamicsMode.COMPRESS, DynamicsMode.LIMIT):
            overshoot = level_db - threshold
            slope = -1.0 if math.isinf(ratio) else (1.0 / ratio - 1.0)
            if knee <= 0:
                return torch.where(level_db > threshold, overshoot * slope, 0.0)
            half = knee / 2.0
            x = level_db - threshold + half
            knee_gain = slope * (x**2) / (2 * knee)
            return torch.where(
                level_db < threshold - half,
                0.0,
                torch.where(level_db > threshold + half, overshoot * slope, knee_gain),
            )
        if mode == DynamicsMode.EXPAND:
            undershoot = threshold - level_db
            if knee <= 0:
                return torch.where(
                    level_db < threshold, -undershoot * (ratio - 1.0), 0.0
                )
            half = knee / 2.0
            x = threshold + half - level_db
            knee_gain = -(ratio - 1.0) * (x**2) / (2 * knee)
            return torch.where(
                level_db > threshold + half,
                0.0,
                torch.where(
                    level_db < threshold - half, -undershoot * (ratio - 1.0), knee_gain
                ),
            )
        # GATE
        range_db = self._range
        if knee <= 0:
            return torch.where(level_db < threshold, range_db, 0.0)
        half = knee / 2.0
        t = (threshold + half - level_db) / knee
        return torch.where(
            level_db > threshold + half,
            0.0,
            torch.where(level_db < threshold - half, range_db, t * range_db),
        )

    # ---- properties ------------------------------------------------------

    @property
    def threshold(self) -> float:
        return self._threshold

    @property
    def ratio(self) -> float:
        return self._ratio

    @property
    def knee(self) -> float:
        return self._knee

    @property
    def makeup_gain(self) -> float:
        return self._makeup_gain_db

    @property
    def mode(self) -> DynamicsMode:
        return self._mode

    @property
    def stereo_link(self) -> bool:
        return self._stereo_link

    def inputs(self) -> list[ProcessingElement]:
        return [self._source, self._envelope]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        return self._source.extent().intersection(self._envelope.extent())

    def _trace(self, ctx):
        audio = ctx.pull(self._source)
        env = ctx.pull(self._envelope)
        channels = audio.shape[1]
        env_channels = env.shape[1]
        if self._stereo_link and env_channels > 1:
            env = torch.amax(env, dim=1, keepdim=True)
        elif env_channels != channels:
            env = env[:, 0:1]
        level_db = 20.0 * torch.log10(torch.clamp(env, min=1e-10))
        gain_db = self._gain_db(level_db) + self._makeup_gain_db
        return (audio * 10.0 ** (gain_db / 20.0)).to(prec.AUDIO)

    def __repr__(self) -> str:
        makeup = (
            "auto" if self._makeup_gain == self.AUTO else f"{self._makeup_gain_db:.1f}"
        )
        return (
            f"DynamicsPE(threshold={self._threshold}, ratio={self._ratio}, "
            f"knee={self._knee}, makeup={makeup}, mode={self._mode.value}, "
            f"stereo_link={self._stereo_link})"
        )


class _DynamicsProcessorPE(ProcessingElement):
    """Shared composite: CachePE(src) → EnvelopePE → DynamicsPE."""

    def __init__(
        self,
        cached_source: ProcessingElement,
        envelope_pe: EnvelopePE,
        dynamics_pe: DynamicsPE,
        *,
        threshold: float,
        attack: float,
        release: float,
        knee: float,
        stereo_link: bool,
    ):
        self._source = cached_source
        self._envelope_pe = envelope_pe
        self._dynamics_pe = dynamics_pe
        self._threshold = threshold
        self._attack = attack
        self._release = release
        self._knee = knee
        self._stereo_link = stereo_link

    @property
    def threshold(self) -> float:
        return self._threshold

    @property
    def attack(self) -> float:
        return self._attack

    @property
    def release(self) -> float:
        return self._release

    @property
    def knee(self) -> float:
        return self._knee

    @property
    def stereo_link(self) -> bool:
        return self._stereo_link

    def inputs(self) -> list[ProcessingElement]:
        return [self._dynamics_pe]

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int | None:
        return self._dynamics_pe.channel_count()

    def _compute_extent(self) -> Extent:
        return self._dynamics_pe.extent()

    def _trace(self, ctx):
        return ctx.pull(self._dynamics_pe)


class CompressorPE(_DynamicsProcessorPE):
    """All-in-one compressor (envelope follower included)."""

    AUTO = "auto"

    def __init__(
        self,
        source: ProcessingElement,
        threshold: float = -20.0,
        ratio: float = 4.0,
        attack: float = 0.01,
        release: float = 0.1,
        knee: float = 6.0,
        makeup_gain="auto",
        lookahead: float = 0.0,
        detection: DetectionMode = DetectionMode.RMS,
        stereo_link: bool = True,
    ):
        cached = CachePE(source)
        envelope_pe = EnvelopePE(
            cached,
            attack=attack,
            release=release,
            lookahead=lookahead,
            mode=detection,
        )
        dynamics_pe = DynamicsPE(
            cached,
            envelope_pe,
            threshold=threshold,
            ratio=ratio,
            knee=knee,
            makeup_gain=makeup_gain,
            mode=DynamicsMode.COMPRESS,
            stereo_link=stereo_link,
        )
        super().__init__(
            cached,
            envelope_pe,
            dynamics_pe,
            threshold=threshold,
            attack=attack,
            release=release,
            knee=knee,
            stereo_link=stereo_link,
        )
        self._ratio = ratio
        self._lookahead = lookahead
        self._detection = detection
        self._makeup_gain_arg = makeup_gain

    @property
    def ratio(self) -> float:
        return self._ratio

    @property
    def lookahead(self) -> float:
        return self._lookahead

    @property
    def detection(self) -> DetectionMode:
        return self._detection

    def __repr__(self) -> str:
        makeup = (
            "auto"
            if self._makeup_gain_arg == self.AUTO
            else f"{self._makeup_gain_arg}"
        )
        return (
            f"CompressorPE(threshold={self._threshold}, ratio={self._ratio}, "
            f"attack={self._attack}, release={self._release}, knee={self._knee}, "
            f"makeup={makeup}, lookahead={self._lookahead})"
        )


class LimiterPE(CompressorPE):
    """Brick-wall limiter: ratio 100, PEAK detection, lookahead."""

    def __init__(
        self,
        source: ProcessingElement,
        ceiling: float = -1.0,
        attack: float = 0.0005,
        release: float = 0.05,
        lookahead: float = 0.005,
        stereo_link: bool = True,
    ):
        super().__init__(
            source,
            threshold=ceiling,
            ratio=100.0,
            attack=attack,
            release=release,
            knee=0.0,
            makeup_gain=0.0,
            lookahead=lookahead,
            detection=DetectionMode.PEAK,
            stereo_link=stereo_link,
        )
        self._ceiling = ceiling

    @property
    def ceiling(self) -> float:
        return self._ceiling

    def __repr__(self) -> str:
        return (
            f"LimiterPE(ceiling={self._ceiling}, release={self._release}, "
            f"lookahead={self._lookahead})"
        )


class ExpanderPE(_DynamicsProcessorPE):
    """Downward expander / noise gate (GATE mode below threshold)."""

    def __init__(
        self,
        source: ProcessingElement,
        threshold: float = -40.0,
        attack: float = 0.001,
        release: float = 0.05,
        gate_range: float = -80.0,
        knee: float = 0.0,
        stereo_link: bool = True,
    ):
        cached = CachePE(source)
        envelope_pe = EnvelopePE(
            cached, attack=attack, release=release, mode=DetectionMode.PEAK
        )
        dynamics_pe = DynamicsPE(
            cached,
            envelope_pe,
            threshold=threshold,
            ratio=1.0,
            knee=knee,
            makeup_gain=0.0,
            mode=DynamicsMode.GATE,
            stereo_link=stereo_link,
            gate_range=gate_range,
        )
        super().__init__(
            cached,
            envelope_pe,
            dynamics_pe,
            threshold=threshold,
            attack=attack,
            release=release,
            knee=knee,
            stereo_link=stereo_link,
        )
        self._gate_range = gate_range

    @property
    def gate_range(self) -> float:
        return self._gate_range

    def __repr__(self) -> str:
        return (
            f"ExpanderPE(threshold={self._threshold}, attack={self._attack}, "
            f"release={self._release}, gate_range={self._gate_range})"
        )
