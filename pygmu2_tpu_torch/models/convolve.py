"""FFT convolution and convolution reverb.

Counterpart of ``pygmu2_tpu.models.convolve``:
- ConvolvePE (reference: src/pygmu2/convolve_pe.py:41-349) — streaming
  FFT convolution. Like the reference's overlap-save, the (L−1)-sample
  input history is carried in engine state (zeroed on a non-contiguous
  request, matching convolve_pe.py:254-256) and the source is pulled
  contiguously for exactly ``[start, start + duration)`` — so a stateful
  source is rendered once per block on its natural stream. Unlike the
  reference's sequential per-hop loop, every frame of one block
  transforms in a single batched rfft·H·irfft.
- ReverbPE (reference: src/pygmu2/reverb_pe.py:27-138) — composite:
  ``out = (1−mix)·dry + (mix/ir_energy)·(dry ∗ ir)``. The IR's energy
  is measured in the engine's host prelude, from a render of the IR on the
  program's device, and sets the wet gain before the first block.
"""

from __future__ import annotations

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.models.basic import ConstantPE, GainPE, MixPE
from pygmu2_tpu_torch.models.holds import CachePE
from pygmu2_tpu_torch.ops.fftconv import framed_conv, next_pow2 as _next_pow2


class ConvolvePE(ProcessingElement):
    """``y = x * h`` with an FIR whose extent must be ``Extent(0, N)``."""

    def state_decays(self) -> bool:
        return True  # finite FIR history: halo >= len(fir) - 1 is exact

    def state_affine(self) -> bool:
        # The carried input history enters the convolution linearly and
        # the next history is a slice of [hist; x] — affine, zero init.
        return True

    def __init__(
        self,
        src: ProcessingElement,
        fir: ProcessingElement,
        *,
        fft_size: int | None = None,
    ):
        self._src = src
        self._fir = fir
        self._fft_size_arg = int(fft_size) if fft_size is not None else None
        self._validate_fir_extent()

    def _validate_fir_extent(self) -> None:
        filt_ext = self._fir.extent()
        if filt_ext.start is None or filt_ext.start != 0 or filt_ext.end is None:
            raise ValueError(
                f"ConvolvePE filter extent must be finite and start at 0, got {filt_ext}"
            )
        self._fir_len = int(filt_ext.end)
        if self._fir_len < 1:
            raise ValueError("ConvolvePE filter must be non-empty")
        if self._fft_size_arg is not None and self._fft_size_arg < self._fir_len:
            raise ValueError(
                f"fft_size ({self._fft_size_arg}) must be >= filter length "
                f"({self._fir_len})"
            )

    @property
    def src(self) -> ProcessingElement:
        return self._src

    @property
    def fir(self) -> ProcessingElement:
        return self._fir

    @property
    def fft_size(self) -> int | None:
        # 2x the FIR keeps the overlap-save hop >= fir_len + 1 (the
        # reference's max(2048, L) default degenerates to hop == 1 when
        # L is a power of two; reference: convolve_pe.py:226-231)
        return self._fft_size_arg or _next_pow2(max(2048, 2 * self._fir_len))

    @staticmethod
    def ir_energy_norm(filter_pe: ProcessingElement, device="cuda") -> float:
        """sqrt(Σ h²) of a finite IR rendered on ``device``, or 1.0 when
        unbounded/near-zero."""
        extent = filter_pe.extent()
        if extent.start is None or extent.end is None:
            return 1.0
        data = filter_pe.render(extent.start, extent.end - extent.start, device=device).data
        norm = float(np.sqrt(np.sum(data.astype(np.float64) ** 2)))
        return norm if norm > 1e-10 else 1.0

    def inputs(self) -> list[ProcessingElement]:
        return [self._src, self._fir]

    def is_pure(self) -> bool:
        # Stateful: carries the (L−1)-sample input history between blocks.
        return False

    def channel_count(self) -> int | None:
        src_ch = self._src.channel_count()
        filt_ch = self._fir.channel_count()
        if src_ch is None and filt_ch is None:
            return None
        if src_ch is None:
            return filt_ch
        if filt_ch is None or int(filt_ch) == 1:
            return src_ch
        if int(src_ch) == 1:
            return int(filt_ch)
        return src_ch

    def _compute_extent(self) -> Extent:
        src_ext = self._src.extent()
        if self._fir_len < 1:
            return Extent(0, 0)
        if src_ext.end is None:
            return Extent(src_ext.start, None)
        return Extent(src_ext.start, int(src_ext.end + self._fir_len - 1))

    def _trace(self, ctx):
        T = ctx.duration
        L = self._fir_len
        tail = L - 1

        h = ctx.pull_abs(self._fir, 0, L)  # (L, filt_ch)
        filt_ch = h.shape[1]

        # Pull the source for exactly [start, start+T): a stateful source
        # streams contiguously (its carried state advances block-to-block),
        # and any sibling pull of the same window dedups in the trace memo.
        x = ctx.pull(self._src)
        src_ch = x.shape[1]

        # Channel-matching rules (reference: convolve_pe.py:114-144).
        if filt_ch == 1:
            out_ch = src_ch
        elif src_ch == 1:
            out_ch = filt_ch
            x = x.repeat(1, filt_ch)
        elif filt_ch == src_ch:
            out_ch = src_ch
        else:
            raise ValueError(
                f"ConvolvePE filter channels ({filt_ch}) must match src "
                f"channels ({src_ch}), or be mono, or pair with a mono source."
            )

        if tail > 0:
            # Carried (L−1)-sample input history, zeroed on the first or
            # any non-contiguous request (reference: convolve_pe.py:254-256
            # clears its tail on a gap).
            hist, _ = ctx.state(
                self,
                init=lambda: torch.zeros((tail, int(out_ch)), dtype=prec.AUDIO,
                                         device=ctx.device),
            )
            x = torch.cat([hist.to(x.dtype), x])
            ctx.set_state(self, x[T:])

        return framed_conv(x, h, T, nfft=self.fft_size)

    def __repr__(self) -> str:
        return (
            f"ConvolvePE(src={type(self._src).__name__}, "
            f"fir={type(self._fir).__name__}, fft_size={self._fft_size_arg})"
        )


class ReverbPE(ProcessingElement):
    """Convolution reverb: dry/wet mix of the source and source∗IR."""

    def __init__(
        self,
        source: ProcessingElement,
        ir: ProcessingElement,
        mix=0.5,
        *,
        normalize_ir: bool = True,
        fft_size: int | None = None,
    ):
        self._source = CachePE(source)
        self._ir = ir
        self._mix = mix
        self._normalize_ir = bool(normalize_ir)
        self._fft_size = fft_size
        if isinstance(mix, ProcessingElement):
            mix_ch = mix.channel_count()
            if mix_ch is not None and int(mix_ch) != 1:
                raise ValueError(f"mix PE must be mono, got {mix_ch} channels")
        else:
            mix = float(mix)
            if not (0.0 <= mix <= 1.0):
                raise ValueError(f"mix must be in [0.0, 1.0], got {mix}")
        self._ir_energy = None if self._normalize_ir else 1.0
        wet = ConvolvePE(self._source, ir, fft_size=fft_size)
        # the wet gain's scale (1 / the IR's energy) is set in _prepare_host
        if isinstance(self._mix, ProcessingElement):
            dry_gain = MixPE(ConstantPE(1.0), GainPE(self._mix, -1.0))
            wet_gain: ProcessingElement | float = self._mix
            if self._normalize_ir:
                wet_gain = self._energy_gain = GainPE(wet_gain, 1.0)
        else:
            dry_gain = 1.0 - float(self._mix)
            wet_gain = float(self._mix)
        self._wet = GainPE(wet, wet_gain)
        self._out = MixPE(GainPE(self._source, dry_gain), self._wet)

    def _prepare_host(self, device) -> None:
        """Engine host-prelude hook: measure the IR's energy (a render of
        the IR on ``device``) and scale the wet gain by its inverse."""
        if self._ir_energy is not None:
            return
        self._ir_energy = ConvolvePE.ir_energy_norm(self._ir, device)
        if isinstance(self._mix, ProcessingElement):
            self._energy_gain._gain = 1.0 / self._ir_energy
        else:
            self._wet._gain = float(self._mix) / self._ir_energy

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def ir(self) -> ProcessingElement:
        return self._ir

    @property
    def mix(self):
        return self._mix

    def inputs(self) -> list[ProcessingElement]:
        return [self._out]

    def is_pure(self) -> bool:
        return self._out.is_pure()

    def channel_count(self) -> int | None:
        return self._out.channel_count()

    def _compute_extent(self) -> Extent:
        return self._out.extent()

    def _trace(self, ctx):
        return ctx.pull(self._out)

    def __repr__(self) -> str:
        mix = (
            type(self._mix).__name__
            if isinstance(self._mix, ProcessingElement)
            else self._mix
        )
        return f"ReverbPE(ir={type(self._ir).__name__}, mix={mix})"
