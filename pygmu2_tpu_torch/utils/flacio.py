"""Self-contained FLAC codec (no native dependencies).

A copy of ``pygmu2_tpu.utils.flacio`` (numpy only): the port cannot import
it, because importing any module of the JAX package loads JAX.

The reference decodes compressed audio (MP3/FLAC/OGG) through the
``miniaudio`` C library (reference: src/pygmu2/audio_reader_pe.py:40-161).
This image ships no audio codec library at all, so ``AudioReaderPE``
gets a built-in FLAC path: a spec-conformant subset decoder plus a small
encoder used for fixtures and round-trip tests.

Decoder coverage (everything libFLAC's default encoder emits):
- STREAMINFO + skipped metadata blocks
- fixed & variable blocking, UTF-8 coded frame/sample numbers
- CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes, wasted bits
- partitioned Rice residuals, both 4-bit and 5-bit parameter methods,
  escape partitions
- independent / left-side / right-side / mid-side channel decorrelation
- CRC-8 (frame header) and CRC-16 (whole frame) verification

Encoder (fixture-grade, always spec-valid): 16-bit, independent
channels, FIXED order 0-2 chosen per subframe by residual magnitude,
single-partition Rice residuals.

Host-side file parsing stays plain Python/NumPy by design — it feeds
device-resident buffers once at start (see the port's models/io_pes.py).
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

__all__ = ["read_flac", "write_flac", "flac_info"]


# --------------------------------------------------------------------------
# CRCs (FLAC frame polynomials)
# --------------------------------------------------------------------------

def _crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    tab = np.zeros(256, np.uint32)
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        tab[i] = c & mask
    return tab


_CRC8_TAB = _crc_table(0x07, 8)
_CRC16_TAB = _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_CRC8_TAB[(c ^ b) & 0xFF])
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ int(_CRC16_TAB[((c >> 8) ^ b) & 0xFF])
    return c


# --------------------------------------------------------------------------
# Bit I/O
# --------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader with byte-position tracking (for CRCs)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.bytepos = pos
        self.bitbuf = 0
        self.nbits = 0

    def _fill(self, need: int) -> None:
        while self.nbits < need:
            if self.bytepos >= len(self.data):
                raise EOFError("FLAC: unexpected end of stream")
            self.bitbuf = (self.bitbuf << 8) | self.data[self.bytepos]
            self.bytepos += 1
            self.nbits += 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill(n)
        self.nbits -= n
        v = (self.bitbuf >> self.nbits) & ((1 << n) - 1)
        self.bitbuf &= (1 << self.nbits) - 1
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count zero bits up to the terminating one bit."""
        q = 0
        while True:
            if self.nbits == 0:
                self._fill(1)
            # fast path: whole cached chunk is zeros
            if self.bitbuf == 0:
                q += self.nbits
                self.nbits = 0
                continue
            top = self.nbits - self.bitbuf.bit_length()
            q += top
            self.nbits -= top + 1
            self.bitbuf &= (1 << self.nbits) - 1
            return q

    def align(self) -> None:
        self.nbits = 0
        self.bitbuf = 0

    def tell_byte(self) -> int:
        """Byte offset of the next unread bit (must be aligned)."""
        assert self.nbits % 8 == 0
        return self.bytepos - self.nbits // 8


class _BitWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def pad_to_byte(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------

_BLOCKSIZE_TAB = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}
_SAMPLE_RATE_TAB = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_SAMPLE_SIZE_TAB = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _read_utf8_number(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    if n < 1 or n > 6:
        raise ValueError("FLAC: invalid UTF-8 coded number")
    v = b0 & (mask - 1)
    for _ in range(n):
        c = br.read(8)
        if (c & 0xC0) != 0x80:
            raise ValueError("FLAC: invalid UTF-8 continuation")
        v = (v << 6) | (c & 0x3F)
    return v


def _read_residual(br: _BitReader, blocksize: int, order: int) -> list[int]:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"FLAC: reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read(4)
    nparts = 1 << po
    if blocksize % nparts:
        raise ValueError("FLAC: partition order does not divide block size")
    out: list[int] = []
    for p in range(nparts):
        count = blocksize // nparts - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            raw = br.read(5)
            if raw == 0:
                out.extend([0] * count)
            else:
                out.extend(br.read_signed(raw) for _ in range(count))
        else:
            for _ in range(count):
                q = br.read_unary()
                u = (q << param) | br.read(param)
                out.append((u >> 1) ^ -(u & 1))  # un-zigzag
    return out


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("FLAC: subframe padding bit set")
    ftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted
    if ftype == 0:  # CONSTANT
        v = br.read_signed(bps)
        out = np.full(blocksize, v, np.int64)
    elif ftype == 1:  # VERBATIM
        out = np.array([br.read_signed(bps) for _ in range(blocksize)],
                       np.int64)
    elif 8 <= ftype <= 12:  # FIXED
        order = ftype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        resid = _read_residual(br, blocksize, order)
        coeffs = _FIXED_COEFFS[order]
        samples = list(warm)
        for r in resid:
            pred = sum(c * samples[-i - 1] for i, c in enumerate(coeffs))
            samples.append(pred + r)
        out = np.array(samples, np.int64)
    elif ftype >= 32:  # LPC
        order = ftype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        prec_ = br.read(4) + 1
        if prec_ == 16:
            raise ValueError("FLAC: invalid LPC precision")
        shift = br.read(5)
        if shift >= 16:  # 5-bit signed; negative shifts are invalid
            raise ValueError("FLAC: negative LPC shift")
        coeffs = [br.read_signed(prec_) for _ in range(order)]
        resid = _read_residual(br, blocksize, order)
        samples = list(warm)
        for r in resid:
            acc = sum(c * samples[-i - 1] for i, c in enumerate(coeffs))
            samples.append((acc >> shift) + r)
        out = np.array(samples, np.int64)
    else:
        raise ValueError(f"FLAC: reserved subframe type {ftype}")
    if wasted:
        out = out << wasted
    return out


def _decode_frame(data: bytes, pos: int, info: dict):
    hdr_start = pos
    br = _BitReader(data, pos)
    if br.read(14) != 0x3FFE:
        raise ValueError("FLAC: lost frame sync")
    if br.read(1):
        raise ValueError("FLAC: reserved frame-header bit set")
    variable = br.read(1)
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1):
        raise ValueError("FLAC: reserved frame-header bit set")
    _read_utf8_number(br)  # frame / sample number (we decode in order)
    del variable

    if bs_code == 0:
        raise ValueError("FLAC: reserved block-size code")
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = _BLOCKSIZE_TAB[bs_code]

    if sr_code == 0:
        pass  # STREAMINFO rate
    elif sr_code in _SAMPLE_RATE_TAB:
        pass
    elif sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    else:
        raise ValueError("FLAC: invalid sample-rate code")

    if ss_code == 0:
        bps = info["bits_per_sample"]
    elif ss_code in _SAMPLE_SIZE_TAB:
        bps = _SAMPLE_SIZE_TAB[ss_code]
    else:
        raise ValueError("FLAC: reserved sample-size code")

    crc8_stored = br.read(8)
    if _crc8(data[hdr_start:br.tell_byte() - 1]) != crc8_stored:
        raise ValueError("FLAC: frame header CRC-8 mismatch")

    if ch_code <= 7:
        nch = ch_code + 1
        subs = [_decode_subframe(br, blocksize, bps) for _ in range(nch)]
        chans = subs
    elif ch_code in (8, 9, 10):
        a = _decode_subframe(br, blocksize, bps + (1 if ch_code == 9 else 0))
        b = _decode_subframe(br, blocksize, bps + (0 if ch_code == 9 else 1))
        if ch_code == 8:  # left-side
            left, side = a, b
            right = left - side
        elif ch_code == 9:  # right-side
            side, right = a, b
            left = side + right
        else:  # mid-side
            mid, side = a, b
            mid2 = (mid << 1) | (side & 1)
            left = (mid2 + side) >> 1
            right = (mid2 - side) >> 1
        chans = [left, right]
    else:
        raise ValueError(f"FLAC: reserved channel assignment {ch_code}")

    br.align()
    end = br.tell_byte()
    crc16_stored = struct.unpack(">H", data[end:end + 2])[0]
    if _crc16(data[hdr_start:end]) != crc16_stored:
        raise ValueError("FLAC: frame CRC-16 mismatch")
    block = np.stack(chans, axis=1)  # (blocksize, channels)
    return block, bps, end + 2


def _parse_stream(path: str):
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC stream (missing fLaC marker)")
    pos = 4
    info = None
    while True:
        if pos + 4 > len(data):
            raise ValueError("FLAC: truncated metadata")
        hdr = struct.unpack(">I", data[pos:pos + 4])[0]
        last = bool(hdr >> 31)
        btype = (hdr >> 24) & 0x7F
        blen = hdr & 0xFFFFFF
        body = data[pos + 4:pos + 4 + blen]
        pos += 4 + blen
        if btype == 0:  # STREAMINFO
            (min_bs, max_bs) = struct.unpack(">HH", body[0:4])
            sr_chan_bits_total = int.from_bytes(body[10:18], "big")
            info = {
                "min_blocksize": min_bs,
                "max_blocksize": max_bs,
                "sample_rate": sr_chan_bits_total >> 44,
                "channels": ((sr_chan_bits_total >> 41) & 0x7) + 1,
                "bits_per_sample": ((sr_chan_bits_total >> 36) & 0x1F) + 1,
                "total_samples": sr_chan_bits_total & ((1 << 36) - 1),
                "md5": body[18:34],
            }
        elif btype == 127:
            raise ValueError("FLAC: invalid metadata block type")
        if last:
            break
    if info is None:
        raise ValueError("FLAC: missing STREAMINFO")
    return data, pos, info


def flac_info(path: str) -> dict:
    """STREAMINFO fields of ``path`` (no frame decoding)."""
    _, _, info = _parse_stream(path)
    return dict(info)


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Decode ``path`` fully. Returns ``((frames, channels) float32 in
    [-1, 1], sample_rate)`` — the same contract as ``wavio.read_wav``."""
    data, pos, info = _parse_stream(path)
    blocks = []
    total = 0
    want = info["total_samples"]
    while pos < len(data) and (want == 0 or total < want):
        block, bps, pos = _decode_frame(data, pos, info)
        blocks.append(block)
        total += block.shape[0]
    if not blocks:
        pcm = np.zeros((0, info["channels"]), np.float32)
    else:
        pcm_i = np.concatenate(blocks, axis=0)
        if want:
            pcm_i = pcm_i[: int(want)]
        scale = float(1 << (info["bits_per_sample"] - 1))
        pcm = (pcm_i.astype(np.float64) / scale).astype(np.float32)
    return np.ascontiguousarray(pcm), int(info["sample_rate"])


# --------------------------------------------------------------------------
# Encoder (fixture-grade)
# --------------------------------------------------------------------------

def _utf8_number(n: int) -> bytes:
    """FLAC's UTF-8-style varint (same framing as UTF-8 code points)."""
    if n < 0x80:
        return bytes([n])
    # k continuation bytes hold 6k bits; the lead byte holds 6 - k bits.
    for k in range(1, 7):
        if n < (1 << (6 * k + (6 - k))):
            break
    lead_prefix = (0xFF << (7 - k)) & 0xFF
    parts = [lead_prefix | (n >> (6 * k))]
    for i in range(k - 1, -1, -1):
        parts.append(0x80 | ((n >> (6 * i)) & 0x3F))
    return bytes(parts)


def _best_fixed_order(x: np.ndarray) -> int:
    best, best_cost = 0, None
    r = x.astype(np.int64)
    for order in range(3):
        if order > 0:
            r = np.diff(r)
        if len(r) == 0:
            cost = 0
        else:
            cost = int(np.abs(r).sum())
        if best_cost is None or cost < best_cost:
            best, best_cost = order, cost
    return best


def _rice_param(resid: np.ndarray) -> int:
    if len(resid) == 0:
        return 0
    mean = float(np.abs(resid).mean())
    k = 0
    while (1 << k) < mean + 1 and k < 14:
        k += 1
    return k


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int) -> None:
    x = x.astype(np.int64)
    if len(x) and np.all(x == x[0]):
        bw.write(0, 1)
        bw.write(0, 6)  # CONSTANT
        bw.write(0, 1)
        bw.write(int(x[0]), bps)
        return
    order = _best_fixed_order(x)
    resid = x.copy()
    for _ in range(order):
        resid = np.diff(resid)
    bw.write(0, 1)
    bw.write(8 + order, 6)  # FIXED
    bw.write(0, 1)  # no wasted bits
    for w in x[:order]:
        bw.write(int(w), bps)
    # residual: method 0 (4-bit rice), partition order 0
    bw.write(0, 2)
    bw.write(0, 4)
    k = _rice_param(resid)
    if k >= 15:
        # escape partition: raw bps-bit residuals
        bw.write(0xF, 4)
        raw = max(1, int(np.abs(resid).max()).bit_length() + 1)
        bw.write(raw, 5)
        for r in resid:
            bw.write(int(r), raw)
        return
    bw.write(k, 4)
    for r in resid:
        u = (int(r) << 1) ^ (int(r) >> 63)  # zigzag
        bw.write_unary(u >> k)
        bw.write(u, k)


def write_flac(
    path: str,
    data: np.ndarray,
    sample_rate: int,
    *,
    blocksize: int = 4096,
) -> None:
    """Encode float32/int16 ``(frames, channels)`` data as 16-bit FLAC."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    if data.dtype.kind == "f":
        pcm = np.clip(np.round(data * 32768.0), -32768, 32767).astype(np.int32)
    else:
        pcm = data.astype(np.int32)
    frames, nch = pcm.shape
    if not 1 <= nch <= 8:
        raise ValueError(f"write_flac: unsupported channel count {nch}")
    bps = 16

    md5 = hashlib.md5()
    md5.update(pcm.astype("<i2").tobytes())

    frames_out = []
    for fi, start in enumerate(range(0, max(frames, 1), blocksize)):
        chunk = pcm[start:start + blocksize]
        n = chunk.shape[0]
        if n == 0:
            break
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)  # fixed blocking
        bw.write(7, 4)  # block size: 16-bit at end of header
        bw.write(0, 4)  # sample rate: from STREAMINFO
        bw.write(nch - 1, 4)  # independent channels
        bw.write(4, 3)  # 16 bits per sample
        bw.write(0, 1)
        for b in _utf8_number(fi):
            bw.write(b, 8)
        bw.write(n - 1, 16)
        bw.pad_to_byte()
        hdr = bw.getvalue()
        hdr += bytes([_crc8(hdr)])

        bw = _BitWriter()
        for c in range(nch):
            _encode_subframe(bw, chunk[:, c], bps)
        bw.pad_to_byte()
        body = bw.getvalue()
        frame = hdr + body
        frame += struct.pack(">H", _crc16(frame))
        frames_out.append(frame)

    si = bytearray()
    si += struct.pack(">HH", min(blocksize, max(frames, 16)), blocksize)
    si += (0).to_bytes(3, "big") * 2  # min/max frame size: unknown
    packed = (sample_rate << 44) | ((nch - 1) << 41) | ((bps - 1) << 36) | frames
    si += packed.to_bytes(8, "big")
    si += md5.digest()
    header = b"fLaC" + struct.pack(">I", (1 << 31) | len(si)) + bytes(si)
    with open(path, "wb") as fh:
        fh.write(header + b"".join(frames_out))
