"""The benchmark workload of ``bench.py``, built on the port's own modules.

Copy of ``bench.py``'s ``build_font_bytes``, ``build_midi_bytes`` and
``build_workload`` (``bench.py`` imports the JAX package): a 128-voice
chord over 16 channels, rendered at 44.1 kHz with block 1024, through
the small font (1,398 samples) or the large multizone font (~1M
samples). ``build_midi_bytes(repeats=15)`` is the 60 s piece.
"""

import struct


def build_font_bytes(large: bool = False) -> bytes:
    """The benchmark font. ``large=False``: the round-1/2 toy font
    (~1.4k samples, rides the resident fused kernel). ``large=True``: a
    realistic-size multi-preset font (~1M samples — the TimGM6mb asset
    class; stripped from the mirror, so synthesized) that exercises the
    windowed-DMA oscillator."""
    from pygmu2_tpu_torch.soundfont.build import build_sf2, make_looped_sample

    if not large:
        return build_sf2(
            [
                {
                    "data": make_looped_sample(261.63, harmonics=6),
                    "rate": 44100,
                    "root_key": 60,
                    "loop": True,
                    "attack_tc": -9000,
                    "release_tc": -4000,
                }
            ]
        )
    samples = []
    for i in range(12):
        freq = 110.0 * 2 ** (i / 4.0)
        cycles = int(40000 * (1 + i % 3) / (44100 / freq))
        samples.append(
            {
                "data": make_looped_sample(
                    freq, harmonics=5, cycles=max(cycles, 4)
                ),
                "rate": 44100,
                "root_key": 45 + 3 * i,
                "key_lo": 0 if i == 0 else 44 + 3 * i,
                "key_hi": 127 if i == 11 else 43 + 3 * (i + 1),
                "loop": (i % 4 != 3),
                "attack_tc": -9000,
                "release_tc": -4000,
            }
        )
    # one preset, key-ranged zones across the keyboard — the shape of a
    # real GM instrument (multi-sample piano)
    return build_sf2(samples, multizone=True)


def build_midi_bytes(repeats: int = 1, period: float = 4.0,
                     note_len: float = 2.0) -> bytes:
    """128-voice chord spread over 16 channels, re-struck ``repeats``
    times every ``period`` seconds (repeats=1: the headline 3 s score
    with note-offs at 2.0 s)."""
    events = []
    keys = [48, 52, 55, 60, 64, 67, 72, 76]
    for rep in range(repeats):
        t0 = rep * period if repeats > 1 else 0.0
        for ch in range(16):
            for k in keys:
                events.append((t0, 0x90 | ch, k + (ch % 3), 100))
        for ch in range(16):
            for k in keys:
                events.append((t0 + note_len, 0x80 | ch, k + (ch % 3), 0))

    def varint(v):
        out = [v & 0x7F]
        v >>= 7
        while v:
            out.append(0x80 | (v & 0x7F))
            v >>= 7
        return bytes(reversed(out))

    resolution, bpm = 480, 120
    tick_per_sec = resolution * bpm / 60.0
    body = b""
    last = 0
    for t, status, d1, d2 in events:
        tick = int(round(t * tick_per_sec))
        body += varint(tick - last) + bytes([status, d1, d2])
        last = tick
    body += varint(0) + b"\xff\x2f\x00"
    return (
        b"MThd"
        + struct.pack(">ihhh", 6, 0, 1, resolution)
        + b"MTrk"
        + struct.pack(">i", len(body))
        + body
    )


def build_workload(large_font: bool = False):
    from pygmu2_tpu_torch.soundfont import (
        MidiFile,
        SoundFont,
        Synthesizer,
        SynthesizerSettings,
    )

    font = SoundFont(build_font_bytes(large=large_font))
    midi = MidiFile(build_midi_bytes())
    synth = Synthesizer(
        font,
        SynthesizerSettings(
            sample_rate=44100, block_size=1024, maximum_polyphony=128
        ),
    )
    return synth, midi
