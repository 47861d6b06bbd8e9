"""Spatialization: channel adaptation, panning, and binaural HRTF.

Counterpart of ``pygmu2_tpu.models.spatial`` (reference:
src/pygmu2/spatial_pe.py:34-671): ``SpatialPE`` converts an M-channel
source to N channels via a strategy object:

- SpatialAdapter        — pure up/downmix rules (mono↔stereo↔quad …).
- SpatialLinear         — linear L/R pan, azimuth scalar-or-PE.
- SpatialConstantPower  — sin/cos pan law, azimuth scalar-or-PE.
- SpatialHRTF           — KEMAR binaural rendering; nearest-neighbor
  (elevation, azimuth) selection, negative azimuth mirrors L/R, batched
  FFT convolution (``ops/fftconv.framed_conv``: cuFFT on the card; no
  carried tail — the engine pulls the history, as ConvolvePE's window).

The pan laws take XLA's CPU arithmetic: the channel mean is a sum times
``1/C``, the pan angle's sine and cosine are glibc's
(``ops/xla_math.sincosf``).

Strategies implement ``trace(ctx, source)`` (the trace-time analog of the
reference's snippet-based ``render``). Azimuth/elevation must be static
for HRTF (switching IRs mid-render would click; same rule as reference).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from pygmu2_tpu_torch.assets import get_kemar_dir, kemar_entries
from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.config import handle_error
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.logger import get_logger
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.ops import xla_math
from pygmu2_tpu_torch.ops.fftconv import framed_conv
from pygmu2_tpu_torch.utils import wavio

_log = get_logger(__name__)


def _channel_sum(x):
    """The (T,) sum of a (T, C) block's channels, added in channel order
    as XLA's CPU program reduces them."""
    total = x[:, 0]
    for c in range(1, x.shape[1]):
        total = total + x[:, c]
    return total


def _mean(x):
    """The channel mean of a (T, C) block as (T, 1): the sum times 1/C, as
    XLA's CPU program computes ``jnp.mean``."""
    C = x.shape[1]
    if C == 1:
        return x
    return (_channel_sum(x) * float(np.float32(1.0 / C)))[:, None]


class SpatialMethod(ABC):
    """Strategy carrying the parameters of one spatialization technique."""

    @property
    @abstractmethod
    def output_channels(self) -> int:
        """Number of output channels this method produces."""

    @abstractmethod
    def trace(self, ctx, source: ProcessingElement):
        """Build the spatialized output (ctx.duration, output_channels)."""

    def inputs(self) -> list[ProcessingElement]:
        """Dynamic PE parameters (for graph validation/lifecycle)."""
        return []


class SpatialAdapter(SpatialMethod):
    """M→N channel conversion without positioning."""

    def __init__(self, channels: int):
        if channels < 1:
            raise ValueError(
                f"SpatialAdapter: channels must be >= 1 (got {channels})"
            )
        self._channels = int(channels)

    @property
    def output_channels(self) -> int:
        return self._channels

    def trace(self, ctx, source: ProcessingElement):
        x = ctx.pull(source)
        src_ch = x.shape[1]
        out_ch = self._channels
        if src_ch == out_ch:
            return x
        if src_ch == 1:
            return x.repeat(1, out_ch)
        if out_ch == 1:
            return _mean(x)
        if src_ch == 2 and out_ch == 4:
            center = _mean(x)
            return torch.cat([x, center, center], dim=1)
        if src_ch > out_ch:
            # Keep the first out_ch channels; fold the rest into the last.
            head = x[:, :out_ch].clone()
            rest = x[:, out_ch:]
            if rest.shape[1]:
                head[:, -1] += _mean(rest)[:, 0]
            return head
        # src_ch < out_ch: copy what exists, zero the rest.
        pad = x.new_zeros((x.shape[0], out_ch - src_ch))
        return torch.cat([x, pad], dim=1)

    def __repr__(self) -> str:
        return f"SpatialAdapter(channels={self._channels})"


class _PanMethod(SpatialMethod):
    """Shared azimuth plumbing for the two pan laws."""

    def __init__(self, azimuth):
        self.azimuth = azimuth

    @property
    def output_channels(self) -> int:
        return 2

    def inputs(self) -> list[ProcessingElement]:
        if isinstance(self.azimuth, ProcessingElement):
            return [self.azimuth]
        return []

    def _gains(self, ctx):
        az = ctx.param(self.azimuth, dtype=prec.AUDIO).clamp(-90.0, 90.0)
        return az

    def trace(self, ctx, source: ProcessingElement):
        x = ctx.pull(source)
        C = x.shape[1]
        if isinstance(self.azimuth, ProcessingElement):
            mono = _mean(x)[:, 0]
            left, right = self._pan_law(self._gains(ctx))
            return torch.stack([mono * left, mono * right], dim=1)
        # A constant azimuth: XLA folds the gains at compile time (float32
        # host arithmetic) and the mean's 1/C into them
        az = torch.full((), float(np.float32(self.azimuth)), dtype=prec.AUDIO).clamp(-90.0, 90.0)
        gains = [float(g) for g in self._pan_law_const(az)]
        if C == 1:
            return torch.stack([x[:, 0] * gains[0], x[:, 0] * gains[1]], dim=1)
        inv_c = np.float32(1.0 / C)
        total = _channel_sum(x)
        return torch.stack([total * float(inv_c * np.float32(g)) for g in gains], dim=1)

    def __repr__(self) -> str:
        az = (
            type(self.azimuth).__name__
            if isinstance(self.azimuth, ProcessingElement)
            else f"{float(self.azimuth):.1f}"
        )
        return f"{type(self).__name__}(azimuth={az})"


class SpatialLinear(_PanMethod):
    """Linear pan (center dip); azimuth −90…+90."""

    def _pan_law(self, az):
        # the division by 180 is a product by its float32 reciprocal, and
        # 1 - pan one fused multiply-add
        shifted = az + 90.0
        inv = float(np.float32(1.0 / 180.0))
        return xla_math.fmaf(-shifted, inv, 1.0), shifted * inv

    def _pan_law_const(self, az):
        pan = (az + 90.0) * float(np.float32(1.0 / 180.0))
        return 1.0 - pan, pan


class SpatialConstantPower(_PanMethod):
    """Constant-power sin/cos pan."""

    def _pan_law(self, az):
        angle = ((az + 90.0) / 2.0) * float(np.float32(np.pi / 180.0))
        sin, cos = xla_math.sincosf(angle)
        return cos, sin

    _pan_law_const = _pan_law


class SpatialHRTF(SpatialMethod):
    """KEMAR binaural rendering (static azimuth/elevation)."""

    _entries_cache: list[tuple[int, int, str]] | None = None

    def __init__(self, azimuth, elevation=0.0):
        if isinstance(azimuth, ProcessingElement) or isinstance(
            elevation, ProcessingElement
        ):
            raise ValueError(
                "SpatialHRTF: azimuth and elevation must be static (float or "
                "int). Dynamic values would switch impulse responses during "
                "rendering and cause discontinuities."
            )
        self.azimuth = float(azimuth)
        self.elevation = float(elevation)
        self._ir: np.ndarray | None = None
        self._ir_on: dict = {}
        self._warned_sr_mismatch = False

    @property
    def output_channels(self) -> int:
        return 2

    @classmethod
    def entries(cls) -> list[tuple[int, int, str]]:
        if cls._entries_cache is None:
            cls._entries_cache = kemar_entries()
        return cls._entries_cache

    @staticmethod
    def hrtf_filename_for(azimuth: float, elevation: float) -> str:
        """Nearest KEMAR file by squared (elevation, azimuth) distance.

        The set covers 0°–180° azimuth; negative azimuth mirrors via L/R
        swap at render time.
        """
        az = min(180.0, abs(float(azimuth)))
        elev = float(elevation)
        entries = SpatialHRTF.entries()
        if not entries:
            raise FileNotFoundError(
                f"KEMAR HRTF dataset not found at {get_kemar_dir()}"
            )
        best = min(entries, key=lambda e: (e[0] - elev) ** 2 + (e[1] - az) ** 2)
        return best[2]

    def _load_ir(self, sample_rate: int) -> np.ndarray:
        if self._ir is not None:
            return self._ir
        filename = self.hrtf_filename_for(self.azimuth, self.elevation)
        data, sr = wavio.read_wav(get_kemar_dir() / filename)
        if data.shape[1] == 1:
            data = np.tile(data, (1, 2))
        if self.azimuth < 0:
            data = data[:, ::-1]  # mirror hemisphere: swap L/R
        if sr != sample_rate and not self._warned_sr_mismatch:
            self._warned_sr_mismatch = True
            handle_error(
                f"SpatialHRTF: KEMAR IR rate {sr} != render rate "
                f"{sample_rate}; spatial cues will shift.",
                fatal=False,
            )
        self._ir = np.ascontiguousarray(data, dtype=np.float32)
        return self._ir

    def _ir_tensor(self, sample_rate: int, device):
        """The IR on ``device``, copied there once (a copy to the card in
        every block would synchronize the stream)."""
        key = str(device)
        if key not in self._ir_on:
            self._ir_on[key] = torch.from_numpy(self._load_ir(sample_rate).copy()).to(device)
        return self._ir_on[key]

    def trace(self, ctx, source: ProcessingElement):
        ir = self._ir_tensor(ctx.sample_rate, ctx.device)  # (L, 2)
        L = ir.shape[0]
        x = ctx.pull(source, shift=-(L - 1), duration=ctx.duration + L - 1)
        mono = _mean(x)
        stereo = mono.repeat(1, 2)
        return framed_conv(stereo, ir, ctx.duration)

    def __repr__(self) -> str:
        return f"SpatialHRTF(azimuth={self.azimuth}, elevation={self.elevation})"


class SpatialPE(ProcessingElement):
    """Convert/position the source using a SpatialMethod strategy."""

    def __init__(self, source: ProcessingElement, *, method: SpatialMethod):
        if method is None:
            raise ValueError("SpatialPE: method is required")
        if not isinstance(method, SpatialMethod):
            raise TypeError(
                f"SpatialPE method must be a SpatialMethod, got {type(method)}"
            )
        self._source = source
        self._method = method

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def method(self) -> SpatialMethod:
        return self._method

    def inputs(self) -> list[ProcessingElement]:
        return [self._source, *self._method.inputs()]

    def is_pure(self) -> bool:
        # HRTF rendering is stateless here, but keep parity with the
        # reference (its fftconvolve carries a tail → impure).
        return not isinstance(self._method, SpatialHRTF)

    def channel_count(self) -> int:
        return self._method.output_channels

    def _compute_extent(self) -> Extent:
        ext = self._source.extent()
        if isinstance(self._method, SpatialHRTF):
            # Convolution tail extends the extent like ConvolvePE.
            ir = self._method._load_ir(self.sample_rate or 44100)
            if ext.end is not None:
                ext = Extent(ext.start, ext.end + ir.shape[0] - 1)
        for pe in self._method.inputs():
            ext = ext.intersection(pe.extent()) or ext
        return ext

    def _trace(self, ctx):
        return self._method.trace(ctx, self._source)

    def __repr__(self) -> str:
        return f"SpatialPE(source={type(self._source).__name__}, method={self._method!r})"
