"""Programmatic SF2 writer: build small valid SoundFonts in memory.

Copy of ``pygmu2_tpu.soundfont.build`` (numpy only, so the PyTorch port
imports no JAX).

Used by tests and benchmarks (the reference mirror ships no .sf2 asset),
and handy for generating fixture instruments: N sine/harmonic samples with loops, one
instrument+preset per sample bank. Also doubles as a test of the parser
(round-trip through both our parser and the reference's).
"""

from __future__ import annotations

import struct

import numpy as np

# Generator opcodes used by the builder.
GEN_START_LOOP = 2
GEN_PAN = 17
GEN_DELAY_VOL = 33
GEN_ATTACK_VOL = 34
GEN_HOLD_VOL = 35
GEN_DECAY_VOL = 36
GEN_SUSTAIN_VOL = 37
GEN_RELEASE_VOL = 38
GEN_INSTRUMENT = 41
GEN_KEY_RANGE = 43
GEN_EXCLUSIVE_CLASS = 57
GEN_VEL_RANGE = 44
GEN_INITIAL_ATTEN = 48
GEN_SAMPLE_ID = 53
GEN_SAMPLE_MODES = 54
GEN_FILTER_CUTOFF = 8


def _chunk(cid: bytes, body: bytes) -> bytes:
    pad = b"\x00" if len(body) % 2 else b""
    return cid + struct.pack("<I", len(body)) + body + pad


def _list_chunk(list_type: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", list_type + body)


def _zstr(text: str, length: int) -> bytes:
    raw = text.encode("ascii")[: length - 1]
    return raw + b"\x00" * (length - len(raw))


def make_looped_sample(
    freq: float = 261.63, sr: int = 44100, harmonics: int = 4, cycles: int = 8
) -> np.ndarray:
    """A band-limited waveform with an integer number of cycles (clean loop)."""
    period = int(round(sr / freq))
    n = period * cycles
    t = np.arange(n) / sr
    x = np.zeros(n)
    f0 = sr / period  # exact loopable frequency
    for k in range(1, harmonics + 1):
        x += np.sin(2 * np.pi * k * f0 * t) / k
    x /= np.abs(x).max()
    return (x * 0.8 * 32767).astype(np.int16)


def build_sf2(
    samples: list[dict] | None = None,
    name: str = "TestFont",
    multizone: bool = False,
) -> bytes:
    """Build an SF2. Each sample dict:
    {data: int16 array, rate: int, root_key: int, loop: bool,
     attack_tc/hold_tc/decay_tc/release_tc/sustain_cb: optional generators,
     key_lo, key_hi: optional key range}
    One preset (bank 0, patch i) per sample — or, with ``multizone``,
    ONE preset (bank 0, patch 0) whose single instrument has one
    key-ranged zone per sample (the shape of real GM instruments:
    a piano preset spanning many samples across the keyboard).
    """
    if samples is None:
        samples = [{"data": make_looped_sample(), "rate": 44100, "root_key": 60, "loop": True}]

    # ---- sdta: concatenated sample data with 46-sample guard gaps ----
    wave_parts = []
    offsets = []
    pos = 0
    for s in samples:
        data = np.asarray(s["data"], np.int16)
        offsets.append((pos, pos + len(data)))
        wave_parts.append(data)
        wave_parts.append(np.zeros(46, np.int16))
        pos += len(data) + 46
    wave = np.concatenate(wave_parts)
    sdta = _list_chunk(b"sdta", _chunk(b"smpl", wave.astype("<i2").tobytes()))

    # ---- INFO ----
    info = _list_chunk(
        b"INFO",
        _chunk(b"ifil", struct.pack("<HH", 2, 1))
        + _chunk(b"isng", _zstr("EMU8000", 8))
        + _chunk(b"INAM", _zstr(name, 20)),
    )

    # ---- pdta ----
    phdr = b""
    pbag = b""
    pgen = b""
    inst = b""
    ibag = b""
    igen = b""
    shdr = b""
    pmod = b"\x00" * 10  # terminal modulator record
    imod = b"\x00" * 10

    for i, s in enumerate(samples):
        start, end = offsets[i]
        loop_margin = min(len(s["data"]) // 4, 4096)
        loop_start = s.get("loop_start", start + loop_margin)
        loop_end = s.get("loop_end", end)
        # shdr record
        shdr += _zstr(f"smp{i}", 20) + struct.pack(
            "<IIIIIBbHH",
            start,
            end,
            loop_start,
            loop_end,
            s["rate"],
            s.get("root_key", 60),
            s.get("pitch_correction", 0),
            s.get("sample_link", 0),  # linked sample index (stereo pairs)
            s.get("sample_type", 1),  # 1=MONO, 2=RIGHT, 4=LEFT
        )

        # instrument zone generators (key/vel range first, sample id last)
        gens = []
        if "key_lo" in s:
            gens.append((GEN_KEY_RANGE, s["key_lo"] | (s["key_hi"] << 8)))
        for gen_id, key in [
            (GEN_ATTACK_VOL, "attack_tc"),
            (GEN_HOLD_VOL, "hold_tc"),
            (GEN_DECAY_VOL, "decay_tc"),
            (GEN_RELEASE_VOL, "release_tc"),
            (GEN_SUSTAIN_VOL, "sustain_cb"),
            (GEN_FILTER_CUTOFF, "cutoff_cents"),
            (GEN_PAN, "pan"),
            (GEN_EXCLUSIVE_CLASS, "exclusive_class"),
        ]:
            if key in s:
                gens.append((gen_id, s[key]))
        gens.append(
            (
                GEN_SAMPLE_MODES,
                s.get("loop_mode", 1 if s.get("loop", True) else 0),
            )
        )
        gens.append((GEN_SAMPLE_ID, i))

        ibag += struct.pack("<HH", len(igen) // 4, 0)
        for oper, amount in gens:
            igen += struct.pack("<Hh", oper, amount)
        if not multizone:
            inst += _zstr(f"inst{i}", 20) + struct.pack("<H", i)

            # preset: one zone pointing at the instrument
            phdr += _zstr(f"preset{i}", 20) + struct.pack(
                "<HHHIII", s.get("patch", i), s.get("bank", 0), i, 0, 0, 0
            )
            pbag += struct.pack("<HH", len(pgen) // 4, 0)
            pgen += struct.pack("<Hh", GEN_INSTRUMENT, i)

    if multizone:
        # one instrument holding every zone above; one preset at patch 0
        inst += _zstr("inst0", 20) + struct.pack("<H", 0)
        phdr += _zstr("preset0", 20) + struct.pack("<HHHIII", 0, 0, 0, 0, 0, 0)
        pbag += struct.pack("<HH", len(pgen) // 4, 0)
        pgen += struct.pack("<Hh", GEN_INSTRUMENT, 0)
        n_inst = 1
    else:
        n_inst = len(samples)

    k = len(samples)
    # terminal records
    phdr += _zstr("EOP", 20) + struct.pack("<HHHIII", 0, 0, n_inst, 0, 0, 0)
    pbag += struct.pack("<HH", len(pgen) // 4, 0)
    pgen += struct.pack("<Hh", 0, 0)
    inst += _zstr("EOI", 20) + struct.pack("<H", k)
    ibag += struct.pack("<HH", len(igen) // 4, 0)
    igen += struct.pack("<Hh", 0, 0)
    shdr += _zstr("EOS", 20) + b"\x00" * 26

    pdta = _list_chunk(
        b"pdta",
        _chunk(b"phdr", phdr)
        + _chunk(b"pbag", pbag)
        + _chunk(b"pmod", pmod)
        + _chunk(b"pgen", pgen)
        + _chunk(b"inst", inst)
        + _chunk(b"ibag", ibag)
        + _chunk(b"imod", imod)
        + _chunk(b"igen", igen)
        + _chunk(b"shdr", shdr),
    )

    body = b"sfbk" + info + sdta + pdta
    return b"RIFF" + struct.pack("<I", len(body)) + body
