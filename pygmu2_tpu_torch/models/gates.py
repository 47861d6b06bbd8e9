"""Gate and trigger signals (counterpart of ``pygmu2_tpu.models.gates``).

- GateSignal      (reference: src/pygmu2/gate_signal.py:31) — mono {0,1}.
- TriggerSignal   (reference: src/pygmu2/trigger_signal.py:33) — mono
  integer event stream; sign = edge direction, magnitude = multiplicity.
- PeriodicGate    (reference: src/pygmu2/periodic_gate.py:18) — wraps
  FunctionGenPE's rectangle.
- PeriodicTrigger (reference: src/pygmu2/periodic_trigger.py:16).

Validation (env-gated like the reference's PYGMU_VALIDATE_SIGNALS) runs
host-side on the block ``render`` returns.
"""

from __future__ import annotations

import os
from abc import abstractmethod

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.core.snippet import Snippet


def _env_flag(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).strip().lower() in ("1", "true", "yes", "on")


def _probe(cls, arr: np.ndarray, kind: str) -> np.ndarray:
    if arr.ndim != 2 or arr.shape[1] != 1:
        raise ValueError(f"{kind} must be mono with shape (N,1); got {arr.shape}")
    if cls.VALIDATE_FULL or arr.shape[0] <= cls.VALIDATE_PROBE_SAMPLES:
        return arr[:, 0]
    idx = np.linspace(0, arr.shape[0] - 1, num=cls.VALIDATE_PROBE_SAMPLES, dtype=int)
    return arr[idx, 0]


class GateSignal(ProcessingElement):
    """Semantic base: mono output of exactly {0, 1}.

    Subclasses implement ``_trace_gate``.
    """

    VALIDATE: bool = _env_flag("PYGMU_VALIDATE_SIGNALS", "1")
    VALIDATE_FULL: bool = _env_flag("PYGMU_VALIDATE_SIGNALS_FULL", "0")
    VALIDATE_PROBE_SAMPLES = 64

    def channel_count(self) -> int:
        return 1

    @abstractmethod
    def _trace_gate(self, ctx):
        """Return a (duration, 1) tensor with values 0/1."""

    def _trace(self, ctx):
        return self._trace_gate(ctx)

    def render(self, start: int, duration: int, *, device="cuda") -> Snippet:
        snippet = super().render(start, duration, device=device)
        if self.VALIDATE and duration > 0:
            self._validate_gate_array(snippet.data)
        return snippet

    @classmethod
    def _validate_gate_array(cls, arr: np.ndarray) -> None:
        probe = _probe(cls, arr, "GateSignal")
        if not np.all((probe == 0.0) | (probe == 1.0)):
            raise ValueError("GateSignal rendered values outside {0, 1}")


class TriggerSignal(ProcessingElement):
    """Semantic base: mono integer event stream.

    Subclasses implement ``_trace_trigger``.
    """

    VALIDATE: bool = _env_flag("PYGMU_VALIDATE_SIGNALS", "1")
    VALIDATE_FULL: bool = _env_flag("PYGMU_VALIDATE_SIGNALS_FULL", "0")
    VALIDATE_PROBE_SAMPLES = 64

    def channel_count(self) -> int:
        return 1

    @abstractmethod
    def _trace_trigger(self, ctx):
        """Return a (duration, 1) tensor of integer-valued samples."""

    def _trace(self, ctx):
        return self._trace_trigger(ctx)

    def render(self, start: int, duration: int, *, device="cuda") -> Snippet:
        snippet = super().render(start, duration, device=device)
        if self.VALIDATE and duration > 0:
            self._validate_trigger_array(snippet.data)
        return snippet

    @classmethod
    def _validate_trigger_array(cls, arr: np.ndarray) -> None:
        probe = _probe(cls, arr, "TriggerSignal")
        if not np.all(probe == np.round(probe)):
            raise ValueError("TriggerSignal rendered non-integer values")


class PeriodicGate(GateSignal):
    """Periodic rectangular 0/1 gate; frequency/duty/phase scalar-or-PE
    (composite over FunctionGenPE's rectangle, mapped −1..1 → 0..1)."""

    def __init__(self, frequency=1.0, duty_cycle=0.5, phase=0.0):
        from pygmu2_tpu_torch.models.oscillators import FunctionGenPE

        self._fg = FunctionGenPE(
            frequency=frequency,
            duty_cycle=duty_cycle,
            phase=phase,
            waveform=FunctionGenPE.WAVE_RECTANGLE,
            channels=1,
        )

    def inputs(self) -> list[ProcessingElement]:
        return self._fg.inputs()

    def is_pure(self) -> bool:
        return self._fg.is_pure()

    def _compute_extent(self) -> Extent:
        return self._fg.extent()

    def _trace_gate(self, ctx):
        wave = ctx.pull(self._fg)
        return (wave + 1.0) * 0.5

    def __repr__(self) -> str:
        return "PeriodicGate(...)"


class PeriodicTrigger(TriggerSignal):
    """+1 impulses every ``round(sr/hz)`` samples, with phase offset."""

    def __init__(self, hz: float, phase: float = 0.0, amplitude: int = 1):
        if hz <= 0:
            raise ValueError("PeriodicTrigger hz must be > 0")
        self._hz = float(hz)
        self._phase = float(phase) % 1.0
        self._amp = int(amplitude)
        self._period = int(round(self.sample_rate / self._hz))
        if self._period <= 0:
            raise ValueError(
                "PeriodicTrigger computed period <= 0; check sample rate / hz"
            )
        self._phase_samples = int(round(self._phase * self._period))

    def inputs(self) -> list[ProcessingElement]:
        return []

    def is_pure(self) -> bool:
        return True

    def _compute_extent(self) -> Extent:
        return Extent(None, None)

    def _trace_trigger(self, ctx):
        hit = torch.remainder(ctx.times() + self._phase_samples, self._period) == 0
        return torch.where(hit, float(self._amp), 0.0).to(prec.AUDIO)[:, None]

    def __repr__(self) -> str:
        return f"PeriodicTrigger(hz={self._hz}, phase={self._phase})"
