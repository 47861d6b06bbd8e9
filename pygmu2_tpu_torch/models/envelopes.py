"""ADSR generators: AdsrGatedPE, AdsrTriggeredPE.

Counterpart of the ADSR pair of ``pygmu2_tpu.models.envelopes``:
- AdsrGatedPE     (reference: src/pygmu2/adsr_pe.py:30-193) — gate-driven
  ADSR with linear segments, IDLE/ATTACK/DECAY/SUSTAIN/RELEASE.
- AdsrTriggeredPE (reference: src/pygmu2/adsr_pe.py:199-335) — one-shot
  ADSR with a fixed sustain time, restarted by triggers.

Both run the state machine in ``ops/adsr.adsr_scan`` (a hand-written
kernel on the card) for any number of gate edges; the JAX package's
edge-tiered closed form (``ops/adsr_block.py``) is a TPU workaround for
a slow ``lax.scan`` and equals the machine to 1e-5.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.ops import adsr as _adsr

# ADSR stage codes.
_IDLE, _ATTACK, _DECAY, _SUSTAIN, _RELEASE = 0, 1, 2, 3, 4


class _AdsrBase(ProcessingElement):
    """Shared pieces of the gated/triggered ADSR state machines."""

    def __init__(self, attack_time, decay_time, sustain_level, release_time):
        self._attack_time = float(attack_time)
        self._decay_time = float(decay_time)
        self._sustain_level = float(sustain_level)
        self._release_time = float(release_time)
        sr = float(self.sample_rate)
        self._attack_dvdt = 1.0 / (self._attack_time * sr)
        self._decay_dvdt = (self._sustain_level - 1.0) / (self._decay_time * sr)
        self._release_dvdt = -self._sustain_level / (self._release_time * sr)

    def _slopes(self) -> dict:
        return dict(
            dA=self._attack_dvdt,
            dD=self._decay_dvdt,
            dR=self._release_dvdt,
            sus=self._sustain_level,
        )

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int:
        return 1


class AdsrGatedPE(_AdsrBase):
    """Gate-driven ADSR: rising edge → attack, falling edge → release."""

    def __init__(
        self,
        gate,
        attack_time: float = 0.1,
        decay_time: float = 0.1,
        sustain_level: float = 0.5,
        release_time: float = 0.1,
    ):
        self._gate = gate
        super().__init__(attack_time, decay_time, sustain_level, release_time)

    def inputs(self) -> list[ProcessingElement]:
        return [self._gate]

    def _compute_extent(self) -> Extent:
        return self._gate.extent()

    def _trace(self, ctx):
        gate = ctx.pull(self._gate)[:, 0]
        dev = ctx.device
        st, _ = ctx.state(self, init=lambda: {
            "stage": torch.full((), _IDLE, dtype=torch.int32, device=dev),
            # carried wide, as the JAX package's state layout
            "env": torch.zeros((), dtype=prec.WIDE, device=dev),
            "prev_gate": torch.zeros((), dtype=prec.AUDIO, device=dev),
        })
        kw = self._slopes()
        kst = torch.stack([
            st["stage"].to(torch.float32),
            st["env"].to(torch.float32),
            torch.zeros((), dtype=torch.float32, device=ctx.device),
            st["prev_gate"].to(torch.float32),
        ])
        y, ns = _adsr.adsr_scan(gate.to(torch.float32).contiguous(), kst, **kw)
        ctx.set_state(
            self,
            {
                "stage": ns[0].to(torch.int32),
                "env": _adsr.env_of_state(ns, **kw).to(prec.WIDE),
                "prev_gate": ns[3].to(prec.AUDIO),
            },
        )
        return y[:, None]

    def __repr__(self) -> str:
        return (
            f"AdsrGatedPE(A={self._attack_time}, D={self._decay_time}, "
            f"S={self._sustain_level}, R={self._release_time})"
        )


class AdsrTriggeredPE(_AdsrBase):
    """One-shot ADSR with a fixed sustain time, restarted by triggers."""

    def __init__(
        self,
        trigger,
        attack_time: float = 0.1,
        decay_time: float = 0.1,
        sustain_time: float = 0.5,
        sustain_level: float = 0.5,
        release_time: float = 0.1,
    ):
        self._trigger = trigger
        self._sustain_time = float(sustain_time)
        super().__init__(attack_time, decay_time, sustain_level, release_time)
        self._sustain_samples = int(round(self._sustain_time * float(self.sample_rate)))

    def inputs(self) -> list[ProcessingElement]:
        return [self._trigger]

    def _compute_extent(self) -> Extent:
        return self._trigger.extent()

    def _trace(self, ctx):
        trig = ctx.pull(self._trigger)[:, 0]
        dev = ctx.device
        st, _ = ctx.state(self, init=lambda: {
            "stage": torch.full((), _IDLE, dtype=torch.int32, device=dev),
            "env": torch.zeros((), dtype=prec.WIDE, device=dev),  # see AdsrGatedPE
            "sustain_ends_at": torch.zeros((), dtype=prec.INDEX, device=dev),
        })

        # Reference timing (adsr_pe.py:323-328): the sustain branch holds
        # one more sample than `sustain_samples` — the expiry check runs
        # pre-update on the transition sample, so the first *decremented*
        # output lands at entry + S + 2. The count-based expiry fires one
        # sample earlier; S + 1 aligns them.
        S = self._sustain_samples + 1
        if not 1 < S < (1 << 24):
            raise NotImplementedError(
                f"AdsrTriggeredPE with {self._sustain_samples} sustain samples: "
                "the port runs sustain times of 1 .. 2**24 - 2 samples"
            )
        kw = self._slopes()
        t0 = ctx.start
        # the absolute sustain deadline as a samples-since-entry count:
        # n_pre(t0) = S - 1 - (ends_at - t0), clamped into [0, S-1]
        n0 = torch.where(
            st["stage"] == _SUSTAIN,
            (S - 1 - (st["sustain_ends_at"] - t0)).clamp(0, S - 1).to(torch.float32),
            torch.zeros((), dtype=torch.float32, device=ctx.device),
        )
        kst = torch.stack([
            st["stage"].to(torch.float32),
            st["env"].to(torch.float32),
            n0,
            torch.zeros((), dtype=torch.float32, device=ctx.device),
        ])
        y, ns = _adsr.adsr_scan(
            trig.to(torch.float32).contiguous(), kst, sustain_samples=S, **kw
        )
        t_next = t0 + trig.shape[0]
        ends = torch.where(
            ns[0] == float(_SUSTAIN),
            t_next + S - 1 - ns[2].to(prec.INDEX),
            st["sustain_ends_at"],
        )
        ctx.set_state(
            self,
            {
                "stage": ns[0].to(torch.int32),
                "env": _adsr.env_of_state(ns, **kw).to(prec.WIDE),
                "sustain_ends_at": ends.to(prec.INDEX),
            },
        )
        return y[:, None]

    def __repr__(self) -> str:
        return (
            f"AdsrTriggeredPE(A={self._attack_time}, D={self._decay_time}, "
            f"S={self._sustain_level}@{self._sustain_time}s, R={self._release_time})"
        )
