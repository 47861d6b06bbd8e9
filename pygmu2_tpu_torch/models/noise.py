"""NoisePE — white / pink / brown noise source.

Counterpart of ``pygmu2_tpu.models.noise`` (reference:
src/pygmu2/noise_pe.py:28-171). White noise is a counter-based hash of
the absolute sample index (block-invariant, parallel — see
:mod:`pygmu2_tpu_torch.ops.noise`). Pink runs the Paul Kellet 7-lane filter as
six *parallel* first-order affine scans plus a one-sample-delayed white
term (the reference loops per sample in Python); brown is the reference's
clipped random-walk integrator, run exactly in parallel as a composed-
clamp associative scan (ops/linrec.clamp_accum_scan).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import SourcePE
from pygmu2_tpu_torch.models.modes import NoiseMode
from pygmu2_tpu_torch.ops.linrec import affine_scan_1, clamp_accum_scan
from pygmu2_tpu_torch.ops.noise import hash_u32, white_uniform
from pygmu2_tpu_torch.ops.xla_math import fmaf

# Paul Kellet pink filter: six one-pole lanes (decay, drive) + direct and
# delayed-white taps.
_PINK_A = np.array([0.99886, 0.99332, 0.96900, 0.86650, 0.55000, -0.7616], np.float32)
_PINK_C = np.array(
    [0.0555179, 0.0750759, 0.1538520, 0.3104856, 0.5329522, -0.0168980], np.float32
)
_PINK_DIRECT = 0.5362
_PINK_DELAYED = 0.115926
_PINK_NORM = 0.11


@functools.lru_cache(maxsize=None)
def _pink_coeffs(device):
    """The lanes' (decay, drive) on ``device``, copied there once (a copy
    to the card in every block would synchronize the stream)."""
    return torch.from_numpy(_PINK_A).to(device), torch.from_numpy(_PINK_C).to(device)


class NoisePE(SourcePE):
    """Seeded noise source, mono, infinite extent."""

    def __init__(
        self,
        min_value: float = -1.0,
        max_value: float = 1.0,
        seed: int | None = None,
        mode: NoiseMode = NoiseMode.WHITE,
    ):
        if max_value < min_value:
            raise ValueError("NoisePE requires max_value >= min_value")
        self._min_value = float(min_value)
        self._max_value = float(max_value)
        self._seed = seed
        self._mode = mode

    def state_decays(self) -> bool:
        # white: no state; pink: six one-pole lanes (|a| < 1) over a
        # counter-hashed (pure-of-t) white source — decays. Brown is a
        # clipped random walk: NOT decaying.
        return self._mode != NoiseMode.BROWN

    @property
    def min_value(self) -> float:
        return self._min_value

    @property
    def max_value(self) -> float:
        return self._max_value

    @property
    def seed(self) -> int | None:
        return self._seed

    @property
    def mode(self) -> NoiseMode:
        return self._mode

    def is_pure(self) -> bool:
        # Colored modes carry filter state (API parity: always False).
        return False

    def channel_count(self) -> int:
        return 1

    def _compute_extent(self) -> Extent:
        return Extent(None, None)

    def _white(self, ctx):
        return white_uniform(ctx.times(), seed=self._seed or 0)

    def _trace(self, ctx):
        scaled = self._min_value != -1.0 or self._max_value != 1.0
        if self._mode == NoiseMode.WHITE and scaled:
            # XLA folds (x 2^-31 - 1 + 1) 0.5 span into x (2^-32 span), the
            # hash word x times one constant, and fuses the offset
            word = hash_u32(ctx.times(), seed=self._seed or 0).to(torch.float32)
            span = float(np.float32(self._max_value - self._min_value))
            out = fmaf(word, 2.0 ** -32 * span, float(np.float32(self._min_value)))
            return out[:, None]
        if self._mode == NoiseMode.WHITE:
            out = self._white(ctx)
        elif self._mode == NoiseMode.PINK:
            out = self._trace_pink(ctx)
        elif self._mode == NoiseMode.BROWN:
            out = self._trace_brown(ctx)
        else:
            raise ValueError(f"Unknown NoiseMode: {self._mode}")
        if scaled:
            span = self._max_value - self._min_value
            out = (out + 1.0) * 0.5 * span + self._min_value
        return out.to(prec.AUDIO)[:, None]

    def _trace_pink(self, ctx):
        w = self._white(ctx)  # (T,)
        dev = ctx.device
        # six independent one-pole lanes: parallel over lanes and time
        b0, _ = ctx.state(self, init=lambda: torch.zeros((6,), dtype=torch.float32, device=dev))
        a, c = _pink_coeffs(dev)
        lanes = affine_scan_1(a.expand(ctx.duration, 6), w[:, None] * c, b0)
        ctx.set_state(self, lanes[-1])
        # Kellet sums the updated lanes plus direct white plus the
        # previous sample's white tap, recomputed from the index hash
        w_prev = white_uniform(ctx.times() - 1, seed=self._seed or 0)
        pink = lanes.sum(dim=-1) + w * _PINK_DIRECT + w_prev * _PINK_DELAYED
        return pink * _PINK_NORM

    def _trace_brown(self, ctx):
        w = self._white(ctx)
        last, _ = ctx.state(
            self, init=lambda: torch.zeros((), dtype=torch.float32, device=ctx.device)
        )
        # the clipped random walk y[t] = clamp(y[t-1] + 0.02 w[t], -1, 1),
        # exactly parallel as a composed-clamp scan
        out = clamp_accum_scan(w * 0.02, -1.0, 1.0, last)
        ctx.set_state(self, out[-1])
        return out

    def __repr__(self) -> str:
        return (
            f"NoisePE(mode={self._mode.value}, "
            f"range=[{self._min_value}, {self._max_value}])"
        )
