"""WAV file codec (pure numpy + stdlib); a copy of ``pygmu2_tpu.utils.wavio``.

The reference uses libsndfile via the ``soundfile`` package for WAV I/O
(reference: src/pygmu2/wav_reader_pe.py:20, wav_writer_pe.py:21). That
package is not a dependency of this project, so this module implements the RIFF/WAVE
container directly: PCM 16/24/32-bit and IEEE float32/float64, mono or
multichannel, plus WAVE_FORMAT_EXTENSIBLE headers.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavInfo:
    sample_rate: int
    channels: int
    frames: int
    fmt: str  # "pcm16" | "pcm24" | "pcm32" | "float32" | "float64"


def _parse_chunks(raw: bytes):
    if len(raw) < 12 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        body = raw[pos + 8 : pos + 8 + size]
        yield cid, body
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float32 array (frames, channels), sample_rate)."""
    with open(path, "rb") as f:
        raw = f.read()

    fmt_body = None
    data_body = None
    for cid, body in _parse_chunks(raw):
        if cid == b"fmt ":
            fmt_body = body
        elif cid == b"data":
            data_body = body
    if fmt_body is None or data_body is None:
        raise ValueError("WAV file missing fmt or data chunk")

    (tag, channels, sample_rate, _byte_rate, _block_align, bits) = struct.unpack_from(
        "<HHIIHH", fmt_body, 0
    )
    if tag == _WAVE_FORMAT_EXTENSIBLE:
        # Actual format lives in the first 2 bytes of the subformat GUID.
        if len(fmt_body) < 40:
            raise ValueError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
        tag = struct.unpack_from("<H", fmt_body, 24)[0]

    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        data = np.frombuffer(data_body, dtype="<" + np.dtype(dtype).char)
        out = data.astype(np.float32)
    elif tag == _WAVE_FORMAT_PCM:
        if bits == 16:
            out = np.frombuffer(data_body, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            out = np.frombuffer(data_body, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(data_body, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            val = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            out = val.astype(np.float32) / 8388608.0
        elif bits == 8:
            out = (
                np.frombuffer(data_body, dtype=np.uint8).astype(np.float32) - 128.0
            ) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag: 0x{tag:04x}")

    frames = len(out) // channels
    return out[: frames * channels].reshape(frames, channels), sample_rate


def wav_info(path) -> WavInfo:
    """Header-only probe (reads the whole file; WAVs are small enough)."""
    data, sr = read_wav(path)
    return WavInfo(sample_rate=sr, channels=data.shape[1], frames=data.shape[0], fmt="float32")


def write_wav(path, data: np.ndarray, sample_rate: int, fmt: str = "float32") -> None:
    """Write (frames, channels) audio to a WAV file.

    ``fmt``: "float32" (default, lossless for our pipeline), "pcm16",
    "pcm24", or "pcm32".
    """
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    frames, channels = arr.shape

    if fmt == "float32":
        tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        payload = arr.astype("<f4").tobytes()
    elif fmt == "pcm16":
        tag, bits = _WAVE_FORMAT_PCM, 16
        clipped = np.clip(arr, -1.0, 1.0 - 1.0 / 32768.0)
        payload = (clipped * 32768.0).round().astype("<i2").tobytes()
    elif fmt == "pcm24":
        tag, bits = _WAVE_FORMAT_PCM, 24
        clipped = np.clip(arr, -1.0, 1.0 - 1.0 / 8388608.0)
        val = (clipped * 8388608.0).round().astype(np.int32)
        b = np.empty((val.size, 3), dtype=np.uint8)
        flat = val.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        payload = b.tobytes()
    elif fmt == "pcm32":
        tag, bits = _WAVE_FORMAT_PCM, 32
        clipped = np.clip(arr, -1.0, 1.0 - 1.0 / 2147483648.0)
        payload = (clipped * 2147483648.0).round().astype("<i4").tobytes()
    else:
        raise ValueError(f"unsupported format: {fmt}")

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt_chunk = struct.pack(
        "<HHIIHH", tag, channels, sample_rate, byte_rate, block_align, bits
    )
    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        fmt_chunk += struct.pack("<H", 0)  # cbSize

    chunks = b""
    chunks += b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
    if len(fmt_chunk) & 1:
        chunks += b"\x00"
    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        # fact chunk is required for non-PCM formats.
        chunks += b"fact" + struct.pack("<II", 4, frames)
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        chunks += b"\x00"

    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)
