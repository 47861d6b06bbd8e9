"""File I/O processing elements (counterpart of ``pygmu2_tpu.models.io_pes``).

- WavReaderPE  (reference: src/pygmu2/wav_reader_pe.py:20) — WAV source,
  finite extent (0, frames), zero-fill outside.
- WavWriterPE  (reference: src/pygmu2/wav_writer_pe.py:21) — passthrough
  tap writing to a WAV file; impure.
- AudioReaderPE (reference: src/pygmu2/audio_reader_pe.py:40) — decodes at
  start, resamples to the global rate, optional peak normalization.

Readers decode the whole file on the host at first use and upload it to a
device once, at the first render there; a block is a gather from that
table. The writer publishes each block through the engine's state and
takes it on the host in its block hook (``_eng_on_block``): after every
block in ``Program.run``, and all at once after the last block in
``render_scan``, whose blocks then stay on the device until one download.
WAV decoding is the port's own RIFF codec (utils/wavio.py), FLAC its own
decoder (utils/flacio.py); other compressed formats (mp3/ogg) use
``miniaudio`` when present.
"""

from __future__ import annotations

import numpy as np
import torch

from pygmu2_tpu_torch.core.config import handle_error
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import ProcessingElement, SourcePE
from pygmu2_tpu_torch.utils import wavio


class _DecodedSource(SourcePE):
    """Shared render logic for sources backed by a decoded buffer."""

    _buffer: np.ndarray | None = None  # (frames, channels) float32
    _tables: dict  # device -> the decoded buffer there

    def _ensure_data(self) -> None:
        raise NotImplementedError

    def _table(self, device: torch.device) -> torch.Tensor:
        table = self._tables.get(device)
        if table is None:
            self._ensure_data()
            table = torch.from_numpy(self._buffer).to(device)
            self._tables[device] = table
        return table

    def _trace(self, ctx):
        table = self._table(ctx.device)
        n = table.shape[0]
        # the engine masks outside the extent, so clamped edges never leak
        return table[ctx.times().clamp(0, n - 1)]


class WavReaderPE(_DecodedSource):
    """WAV file source. Extent is ``(0, frames)``; zeros outside."""

    def __init__(self, path: str):
        self._path = str(path)
        self._frame_count: int | None = None
        self._channels: int | None = None
        self._file_sample_rate: int | None = None
        self._buffer = None
        self._tables = {}

    @property
    def path(self) -> str:
        return self._path

    @property
    def file_sample_rate(self) -> int | None:
        self._ensure_data()
        return self._file_sample_rate

    @property
    def sample_rate(self) -> int | None:
        if self._sample_rate is not None:
            return self._sample_rate
        return self.file_sample_rate

    def _ensure_data(self) -> None:
        if self._buffer is None:
            data, sr = wavio.read_wav(self._path)
            self._buffer = np.ascontiguousarray(data, dtype=np.float32)
            self._frame_count = data.shape[0]
            self._channels = data.shape[1]
            self._file_sample_rate = sr
            if self._sample_rate is not None and sr != self._sample_rate:
                handle_error(
                    f"WavReaderPE: file rate {sr} != global rate "
                    f"{self._sample_rate}; playing at the wrong speed.",
                    fatal=False,
                )

    def _on_start(self) -> None:
        self._ensure_data()

    def channel_count(self) -> int:
        self._ensure_data()
        return int(self._channels)

    def _compute_extent(self) -> Extent:
        self._ensure_data()
        return Extent(0, int(self._frame_count))

    def __repr__(self) -> str:
        return f"WavReaderPE(path='{self._path}')"


class AudioReaderPE(_DecodedSource):
    """Multi-format reader: decodes fully at start, resamples to the global
    rate, optionally normalizes peaks to ``max_level_db``."""

    def __init__(self, path: str, max_level_db: float | None = None):
        self._path = str(path)
        self._max_level_db = max_level_db
        self._buffer = None
        self._file_sample_rate: int | None = None
        self._tables = {}

    @property
    def path(self) -> str:
        return self._path

    @property
    def file_sample_rate(self) -> int:
        self._ensure_data()
        return int(self._file_sample_rate)

    def channel_count(self) -> int:
        self._ensure_data()
        return self._buffer.shape[1]

    def _compute_extent(self) -> Extent:
        self._ensure_data()
        return Extent(0, self._buffer.shape[0])

    def _on_start(self) -> None:
        self._ensure_data()

    def _decode(self) -> tuple[np.ndarray, int]:
        lower = self._path.lower()
        if lower.endswith(".wav"):
            return wavio.read_wav(self._path)
        try:
            import miniaudio
        except ImportError:
            miniaudio = None
        # a module without decode_file is not a usable codec
        if miniaudio is not None and not hasattr(miniaudio, "decode_file"):
            miniaudio = None
        if miniaudio is not None:
            decoded = miniaudio.decode_file(self._path)
            data = np.asarray(decoded.samples, dtype=np.float32) / 32768.0
            data = data.reshape(-1, decoded.nchannels)
            return data, decoded.sample_rate
        if lower.endswith(".flac"):
            from pygmu2_tpu_torch.utils import flacio

            return flacio.read_flac(self._path)
        raise RuntimeError(
            f"AudioReaderPE: decoding {self._path} requires the "
            "'miniaudio' package (not installed); WAV and FLAC files "
            "work without it."
        )

    def _ensure_data(self) -> None:
        if self._buffer is not None:
            return
        data, sr = self._decode()
        self._file_sample_rate = sr
        target = self._sample_rate
        if target is not None and sr != target:
            from math import gcd

            from scipy.signal import resample_poly

            g = gcd(int(target), int(sr))
            data = resample_poly(data, int(target) // g, int(sr) // g, axis=0)
        if self._max_level_db is not None:
            peak = float(np.max(np.abs(data))) if data.size else 0.0
            if peak > 0:
                data = data * (10.0 ** (self._max_level_db / 20.0) / peak)
        self._buffer = np.ascontiguousarray(data, dtype=np.float32)

    def __repr__(self) -> str:
        if self._max_level_db is not None:
            return (
                f"AudioReaderPE(path='{self._path}', "
                f"max_level_db={self._max_level_db})"
            )
        return f"AudioReaderPE(path='{self._path}')"


class WavWriterPE(ProcessingElement):
    """Passthrough tap that appends every rendered block to a WAV file.

    Impure (file side effect). Blocks reach the file in render order
    through the engine's block hook. The file opens on start and is
    written on stop.
    """

    _SUBTYPE_MAP = {
        "PCM_16": "pcm16",
        "PCM_24": "pcm24",
        "PCM_32": "pcm32",
        "FLOAT": "float32",
    }

    def __init__(
        self,
        source: ProcessingElement,
        path: str,
        sample_rate: int | None = None,
        subtype: str = "PCM_16",
    ):
        self._source = source
        self._path = str(path)
        self._output_sample_rate = sample_rate
        self._subtype = subtype
        self._fmt = self._SUBTYPE_MAP.get(subtype, "float32")
        self._chunks: list[np.ndarray] = []
        self._frames_written = 0
        self._open = False

    @property
    def path(self) -> str:
        return self._path

    @property
    def frames_written(self) -> int:
        return self._frames_written

    @property
    def source(self) -> ProcessingElement:
        return self._source

    def inputs(self) -> list[ProcessingElement]:
        return [self._source]

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        return self._source.extent()

    def _on_start(self) -> None:
        self._chunks = []
        self._frames_written = 0
        self._open = True

    def _on_stop(self) -> None:
        if self._open:
            self._flush()
        self._open = False

    def _flush(self) -> None:
        data = (
            np.concatenate(self._chunks, axis=0)
            if self._chunks
            else np.zeros((0, self.channel_count() or 1), np.float32)
        )
        sr = self._output_sample_rate or self.sample_rate or 44100
        wavio.write_wav(self._path, data, sr, fmt=self._fmt)

    def _eng_on_block(self, block) -> None:
        """Engine block hook: append one rendered block (on the host)."""
        if isinstance(block, torch.Tensor):
            block = block.cpu().numpy()
        if self._open:
            self._chunks.append(np.array(block, dtype=np.float32))
            self._frames_written += block.shape[0]

    def _trace(self, ctx):
        x = ctx.pull(self._source)
        # publish the block through the state; the engine hands it to
        # _eng_on_block after the block (Program.run) or the render
        # (render_scan)
        ctx.state(self, init=lambda: torch.zeros_like(x))
        ctx.set_state(self, x)
        return x

    def __repr__(self) -> str:
        return f"WavWriterPE(source={type(self._source).__name__}, path='{self._path}')"
