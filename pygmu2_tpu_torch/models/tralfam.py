"""TralfamPE — spectral scramble.

Counterpart of ``pygmu2_tpu.models.tralfam`` (reference:
src/pygmu2/tralfam_pe.py:25-148): FFT the whole finite source, keep the
magnitudes, randomize the phases, IFFT; serve slices of the result.

The scramble is a fixed function of the source, so it is built once, on
the host in numpy (as the JAX package builds it), from a render of the
source made in the engine's host prelude on the program's device; the
random phases come from the counter-based hash (reproducible by seed).
Each block is a gather from the result, uploaded once per device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.ops.noise import white_uniform_np


class TralfamPE(ProcessingElement):
    """Keep the source's spectrum, scramble its phase."""

    def __init__(
        self,
        source: ProcessingElement,
        seed: int | None = None,
        normalize_peak: float | None = None,
    ):
        self._source = source
        self._seed = seed
        if normalize_peak is not None and (
            normalize_peak <= 0 or not math.isfinite(normalize_peak)
        ):
            raise ValueError(
                f"normalize_peak must be a positive finite number, got {normalize_peak!r}"
            )
        self._normalize_peak = normalize_peak
        self._mog_np: np.ndarray | None = None
        self._mog: dict[torch.device, torch.Tensor] = {}

    def inputs(self) -> list[ProcessingElement]:
        return [self._source]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        return self._source.extent()

    def _prepare_host(self, device) -> None:
        """Engine host-prelude hook: build the scramble before the first
        block, rendering the source on ``device``."""
        ext = self._source.extent()
        if ext.start is not None and ext.end is not None and ext.end > ext.start:
            self._mogrified(torch.device(device))

    def _mogrified(self, device: torch.device) -> torch.Tensor:
        """The scramble on ``device``; built on the host at the first call
        (the source rendered once, on ``device``)."""
        if self._mog_np is None:
            ext = self._source.extent()
            n = ext.end - ext.start
            x = np.asarray(self._source.render(ext.start, n, device=device).data)
            C = x.shape[1]
            analysis = np.fft.fft(x, axis=0)
            magnitudes = np.abs(analysis)
            idx = np.arange(n, dtype=np.int64)[:, None] * C + np.arange(C)
            phases = (white_uniform_np(idx, seed=self._seed or 0) + 1.0) * np.pi
            mangled = magnitudes * np.exp(1j * phases)
            mog = np.real(np.fft.ifft(mangled, axis=0)).astype(np.float32)
            if self._normalize_peak is not None:
                peak = np.abs(mog).max()
                if peak > 0:
                    mog = mog * (self._normalize_peak / peak)
            self._mog_np = np.ascontiguousarray(mog, dtype=np.float32)
        table = self._mog.get(device)
        if table is None:
            table = torch.from_numpy(self._mog_np).to(device)
            self._mog[device] = table
        return table

    def _trace(self, ctx):
        ext = self._source.extent()
        if ext.start is None or ext.end is None:
            raise ValueError(
                f"{type(self).__name__} requires finite source extent; got {ext}"
            )
        n = ext.end - ext.start
        if n <= 0:
            raise ValueError(
                f"{type(self).__name__} requires positive extent duration"
            )
        mogrified = self._mogrified(ctx.device)
        # the engine masks outside the extent
        return mogrified[(ctx.times() - ext.start).clamp(0, n - 1)]

    def __repr__(self) -> str:
        return f"TralfamPE(source={type(self._source).__name__}, seed={self._seed})"
