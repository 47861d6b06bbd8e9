"""The benchmark workload of ``bench.py``, built on the port's own modules.

Copy of ``bench.py``'s ``build_font_bytes``, ``build_midi_bytes`` and
``build_workload`` (``bench.py`` imports the JAX package): a 128-voice
chord over 16 channels, rendered at 44.1 kHz with block 1024, through
the small font (1,398 samples) or the large multizone font (~1M
samples). ``build_midi_bytes(repeats=15)`` is the 60 s piece.

``build_high_midi_bytes`` is the port's copy of
``benchmarks/benchmark_large_font_bend.py:musical_events`` (staggered
pentatonic arpeggios over 16 channels, pitch bends, mod-wheel ramps) with
every key four octaves up (keys 88-120): a lead or whistle line far above
its samples' roots. Through the large font (top zone rooted at key 78) its
notes reach ~42 semitones above their root, a pitch-ratio bound of ~11,
beyond the JAX package's windowed kernel (8), so the audio pass is
unfused.
"""

import struct

# semitones the high-register score lies above the bend benchmark's keys
HIGH_TRANSPOSE = 48


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
    return _midi_bytes(events)


def build_high_midi_bytes(seconds: float) -> bytes:
    """The high-register score: ``musical_events(seconds)`` of
    ``benchmarks/benchmark_large_font_bend.py`` with every key
    ``HIGH_TRANSPOSE`` semitones higher."""
    events = []
    scale = [0, 2, 4, 7, 9]  # pentatonic
    for ch in range(16):
        # mod wheel ramp early in the piece
        events.append((0.01 * ch, 0xB0 | ch, 0x01, 20 + ch * 6))
    t = 0.0
    i = 0
    while t < seconds - 0.35:
        ch = i % 16
        key = HIGH_TRANSPOSE + 40 + (i * 7) % 24 + scale[i % len(scale)]
        events.append((t, 0x90 | ch, key, 70 + (i * 13) % 50))
        events.append((t + 0.30, 0x80 | ch, key, 0))
        # a bend on this channel while the note sounds (14-bit center 8192)
        bend = 8192 + ((-1) ** i) * (900 + (i * 371) % 2600)
        events.append((t + 0.10, 0xE0 | ch, bend & 0x7F, (bend >> 7) & 0x7F))
        events.append((t + 0.28, 0xE0 | ch, 0x00, 0x40))  # re-center
        t += 0.045
        i += 1
    events.sort(key=lambda e: e[0])
    return _midi_bytes(events)


def _midi_bytes(events) -> bytes:
    """A one-track MIDI file of (seconds, status, data1, data2) events at
    480 ticks per beat and 120 bpm."""

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


def build_workload(large_font: bool = False, device="cuda"):
    """``bench.build_workload``: (synthesizer, score); the synthesizer's
    streaming engine runs on ``device``."""
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
        device=device,
    )
    return synth, midi


def audio_pass_rows(synth, midi, seconds: float, device):
    """The fused audio pass's (B, P) control rows for the first ``seconds``
    of ``midi`` through ``synth`` (the control pass on ``device``), as
    ``offline.render_midi_offline`` forms them: (rows, wave, N). Resets the
    synth."""
    from pygmu2_tpu_torch.soundfont import offline as off
    from pygmu2_tpu_torch.soundfont.convert import schedule_to_torch, to_torch

    par, ch, snap, _nb = synth.build_schedule(midi, seconds)
    planes, flags = schedule_to_torch(par, ch, snap, device)
    ctrl = off._control_device(*planes, synth.block_size, flags,
                               int(synth._minimum_voice_duration), float(synth.sample_rate))
    wave = to_torch(synth._wave, device)
    rows = dict(off._gain_rows(ctrl, synth.master_volume), **off._osc_rows(ctrl, wave))
    synth.reset()
    return rows, wave, synth.block_size
