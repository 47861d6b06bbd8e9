"""Envelope follower and ADSR generators.

Counterpart of ``pygmu2_tpu.models.envelopes``:
- EnvelopePE      (reference: src/pygmu2/envelope_pe.py:25-271) — causal
  attack/release follower, PEAK or windowed-RMS detection, lookahead by
  pulling the future.
- AdsrGatedPE     (reference: src/pygmu2/adsr_pe.py:30-193) — gate-driven
  ADSR with linear segments, IDLE/ATTACK/DECAY/SUSTAIN/RELEASE.
- AdsrTriggeredPE (reference: src/pygmu2/adsr_pe.py:199-335) — one-shot
  ADSR with a fixed sustain time, restarted by triggers.

The symmetric follower (attack == release) is a linear one-pole on the
parallel ``ops/linrec.affine_scan_1``; the asymmetric follower runs in
``ops/envelope.envelope_ar_scan`` for any channel count. Both ADSRs run
the state machine in ``ops/adsr.adsr_scan`` for any number of gate edges;
its kernel takes the edge-parallel order of the JAX package's closed form
(``ops/adsr_block.py``), serial over the edges only, and equals the
per-sample machine bit for bit.
AdsrTriggeredPE with a sustain outside 1 .. 2**24 - 2 samples runs, as the
JAX PE does, the absolute-clock machine of its ``lax.scan`` branch
(``ops/adsr.adsr_clock_scan``). All are hand-written kernels on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.models.modes import DetectionMode
from pygmu2_tpu_torch.ops import adsr as _adsr
from pygmu2_tpu_torch.ops import envelope as _envelope
from pygmu2_tpu_torch.ops.linrec import affine_scan_1
from pygmu2_tpu_torch.ops.phase import prefix_sum
from pygmu2_tpu_torch.ops.xla_math import sqrtf

# ADSR stage codes.
_IDLE, _ATTACK, _DECAY, _SUSTAIN, _RELEASE = 0, 1, 2, 3, 4


class EnvelopePE(ProcessingElement):
    """Attack/release envelope follower with optional lookahead."""

    def state_decays(self) -> bool:
        return True  # follower state converges within a few time-constants

    def __init__(
        self,
        source: ProcessingElement,
        attack: float = 0.01,
        release: float = 0.1,
        lookahead: float = 0.0,
        mode: DetectionMode = DetectionMode.PEAK,
    ):
        self._source = source
        self._attack = max(0.0, attack)
        self._release = max(0.0, release)
        self._lookahead = max(0.0, min(lookahead, self._attack))
        self._mode = mode

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def attack(self) -> float:
        return self._attack

    @property
    def release(self) -> float:
        return self._release

    @property
    def lookahead(self) -> float:
        return self._lookahead

    @property
    def mode(self) -> DetectionMode:
        return self._mode

    def _fills_own_edges(self) -> bool:
        # IIR state rings past the source extent: the reference keeps
        # filtering the zero-padded input through its carried state, so
        # the decay tail is audible. Opt out of the engine's zero-fill.
        return True

    def inputs(self) -> list[ProcessingElement]:
        return [self._source]

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        return self._source.extent()

    @staticmethod
    def _rms(x, window: int):
        """Centered moving RMS over the block with edge-replicate padding
        (scipy.ndimage.uniform_filter1d(mode='nearest')).

        The mean is a difference of two prefix sums ``window`` apart, which
        amplifies their rounding: the prefix sum is :func:`prefix_sum`,
        the JAX package's ``jnp.cumsum`` on the CPU bit for bit."""
        if window <= 1:
            return x
        left = window // 2
        right = window - 1 - left
        sq = x * x
        padded = torch.cat([sq[:1].expand(left, -1), sq, sq[-1:].expand(right, -1)])
        csum = torch.cat([torch.zeros_like(sq[:1]), prefix_sum(padded)])
        # XLA divides by a constant as a product with its reciprocal, and
        # its square root is correctly rounded
        mean = (csum[window:] - csum[:-window]) * float(np.float32(1.0 / window))
        return sqrtf(torch.clamp(mean, min=0.0))

    def _trace(self, ctx):
        sr = ctx.sample_rate
        look = int(self._lookahead * sr)
        x = torch.abs(ctx.pull(self._source, shift=look))
        if self._mode == DetectionMode.RMS:
            x = self._rms(x, max(1, int(min(0.01, self._attack) * sr)))

        atk = 1.0 - math.exp(-1.0 / (self._attack * sr)) if self._attack > 0 else 1.0
        rel = 1.0 - math.exp(-1.0 / (self._release * sr)) if self._release > 0 else 1.0
        env0, _ = ctx.state(
            self, init=lambda: torch.zeros((x.shape[1],), dtype=prec.AUDIO, device=ctx.device)
        )
        if atk == rel:  # a linear one-pole: parallel in time
            y = affine_scan_1(torch.full_like(x, 1.0 - atk), atk * x, env0)
            final = y[-1]
        else:
            y, final = _envelope.envelope_ar_scan(x, env0, atk=atk, rel=rel)
        ctx.set_state(self, final)
        return y

    def __repr__(self) -> str:
        return (
            f"EnvelopePE(source={type(self._source).__name__}, "
            f"attack={self._attack}, release={self._release}, "
            f"lookahead={self._lookahead}, mode={self._mode.value})"
        )


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
        y, ns, env_next = _adsr.adsr_scan(gate.to(torch.float32).contiguous(), kst, **kw)
        ctx.set_state(
            self,
            {
                "stage": ns[0].to(torch.int32),
                "env": env_next.to(prec.WIDE),
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
        kw = self._slopes()
        t0 = ctx.start
        if not 1 < S < (1 << 24):
            # outside the float32 count's range, the JAX PE's lax.scan
            # branch: an absolute clock, its state carried as it is
            y, (stage, env, ends) = _adsr.adsr_clock_scan(
                trig.to(torch.float32).contiguous(), st["stage"], st["env"],
                st["sustain_ends_at"], t0=t0, sustain_samples=self._sustain_samples, **kw,
            )
            ctx.set_state(self, {"stage": stage, "env": env, "sustain_ends_at": ends})
            return y[:, None]
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
        y, ns, env_next = _adsr.adsr_scan(
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
                "env": env_next.to(prec.WIDE),
                "sustain_ends_at": ends.to(prec.INDEX),
            },
        )
        return y[:, None]

    def __repr__(self) -> str:
        return (
            f"AdsrTriggeredPE(A={self._attack_time}, D={self._decay_time}, "
            f"S={self._sustain_level}@{self._sustain_time}s, R={self._release_time})"
        )
