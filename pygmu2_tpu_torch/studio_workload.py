"""The studio workload: a sound-design graph over files on disk.

A user of the PE graph builds this kind of graph to design a sound from
recordings: a looped recording played through a tape head under a live
rate control, one-shot hits cut from a compressed copy and sequenced, a
wavetable drone, brown noise that follows the loop's loudness, a phase
scramble of a stretch of the recording, all through a compressor and a
convolution reverb into a WAV file. It drives every mechanism of the
engine's live half: the writer's block hook, the live control's and the
tape's version guard, the host prelude (TralfamPE, ReverbPE's IR energy).

:func:`build_studio` takes a package namespace ``pg`` — ``pygmu2_tpu_torch`` or the
JAX package ``pygmu2_tpu`` — so the same graph can be built from either
and the two renders compared; both set the sample rate to 44.1 kHz. The
files are made with numpy from a seed (:func:`make_files`); nothing is
downloaded.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SR = 44100
SOURCE_SECONDS = 30.0  # the recording
IR_SECONDS = 2.0  # the reverb's impulse response
N_HITS = 32
HIT_SECONDS = 0.25
HIT_DELAY = 0.375 * SR + 0.37  # samples: the hits' delay, a fractional one
DRONE_TABLE = 2048  # samples in one cycle of the drone's wavetable


def make_files(directory, seed: int = 0, source_seconds: float = SOURCE_SECONDS) -> dict:
    """Write the workload's files into ``directory``: the recording as a
    float32 stereo WAV (``src.wav``) and as FLAC (``src.flac``, by the
    port's ``flacio.write_flac``), and a 2 s stereo impulse response
    (``ir.wav``: seeded noise under exp(-t / 0.4 s)). Returns their
    paths by name."""
    from pygmu2_tpu_torch.utils import flacio, wavio

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(round(source_seconds * SR))
    # plucked notes of five partials struck every 0.5-1.5 s (each partial
    # decays within 8 s), plus a little air
    src = np.zeros((n, 2))
    at = 0.0
    while at < source_seconds:
        f0 = 110.0 * 2.0 ** (rng.integers(0, 24) / 12.0)
        i0 = int(round(at * SR))
        age = np.arange(min(n - i0, 8 * SR)) / SR
        for k in range(1, 6):
            amp = rng.uniform(0.05, 0.25) / k
            pan = rng.uniform(0.2, 0.8)
            tone = amp * np.sin(2 * np.pi * f0 * k * age + rng.uniform(0, 2 * np.pi))
            tone *= np.exp(-age / rng.uniform(0.2, 1.0))
            src[i0:i0 + age.size, 0] += (1 - pan) * tone
            src[i0:i0 + age.size, 1] += pan * tone
        at += rng.uniform(0.5, 1.5)
    src += 0.01 * rng.standard_normal((n, 2))
    src = (0.8 * src / np.abs(src).max()).astype(np.float32)
    ir_n = int(round(IR_SECONDS * SR))
    ir = rng.standard_normal((ir_n, 2)) * np.exp(-np.arange(ir_n) / (0.4 * SR))[:, None]
    paths = {"src.wav": directory / "src.wav", "src.flac": directory / "src.flac",
             "ir.wav": directory / "ir.wav"}
    wavio.write_wav(paths["src.wav"], src, SR, fmt="float32")
    flacio.write_flac(str(paths["src.flac"]), src, SR)
    wavio.write_wav(paths["ir.wav"], ir.astype(np.float32), SR, fmt="float32")
    return {k: str(v) for k, v in paths.items()}


def drone_table(seed: int = 0) -> np.ndarray:
    """(DRONE_TABLE, 2) float32: one cycle of a band-limited wave, its
    eight harmonics' amplitudes drawn per channel."""
    rng = np.random.default_rng(seed + 1)
    ph = 2 * np.pi * np.arange(DRONE_TABLE) / DRONE_TABLE
    table = np.zeros((DRONE_TABLE, 2))
    for c in range(2):
        for k in range(1, 9):
            table[:, c] += rng.uniform(0.2, 1.0) / k * np.sin(k * ph + rng.uniform(0, 2 * np.pi))
    return (table / np.abs(table).max()).astype(np.float32)


def readers(pg, files: dict) -> dict:
    """The graph's file readers over ``files`` (from :func:`make_files`):
    the recording (``src``, WAV), its FLAC copy (``flac``, decoded once,
    on the host) and the impulse response (``ir``). Readers are pure, so
    graphs built again may share them."""
    pg.set_sample_rate(SR)
    return {"src": pg.WavReaderPE(files["src.wav"]), "flac": pg.AudioReaderPE(files["src.flac"]),
            "ir": pg.WavReaderPE(files["ir.wav"])}


def build_studio(pg, seconds: float, sources: dict, out_path: str | None = None, seed: int = 0):
    """The studio graph, ``seconds`` long at 44.1 kHz, over ``sources``,
    the file readers from :func:`readers`. Returns ``(root, parts)``: the root is a
    WavWriterPE writing ``out_path`` (FLOAT) or, without a path, the graph
    it would write; ``parts`` holds the live controls by name (``rate``:
    the tape's ControlPE, ``tape``: its TimeWarpPE, ``loop``: the loop it
    plays, ``writer``)."""
    pg.set_sample_rate(SR)
    total = int(round(seconds * SR))
    rng = np.random.default_rng(seed + 2)

    # the loop: the middle of the recording, crossfaded at its seam
    reader = sources["src"]
    n_src = reader.extent().end
    loop = pg.LoopPE(reader, n_src // 6, n_src - n_src // 6, crossfade_seconds=0.05)
    rate = pg.ControlPE(1.0)
    tape = pg.TimeWarpPE(loop, rate=rate, max_rate=2.0,
                         interpolation=pg.InterpolationMode.CUBIC)

    # the hits: 32 quarter-second slices of the FLAC copy, evenly sequenced,
    # a fractional delay behind
    flac = sources["flac"]
    hit_n = int(round(HIT_SECONDS * SR))
    hits = pg.SequencePE([
        (pg.SlicePE(flac, int(rng.integers(0, n_src - hit_n)), hit_n,
                    fade_in_seconds=0.005, fade_out_seconds=0.05),
         int(round(k * total / N_HITS)))
        for k in range(N_HITS)
    ])
    hits = pg.DelayPE(hits, HIT_DELAY)

    # the drone: a wavetable at 55 Hz, cubic, wrapped
    drone = pg.WavetablePE(pg.ArrayPE(drone_table(seed)),
                           pg.GainPE(pg.IdentityPE(), DRONE_TABLE * 55.0 / SR),
                           pg.InterpolationMode.CUBIC, pg.OutOfBoundsMode.WRAP)

    # air: brown noise on both channels, as loud as the loop's RMS (a
    # WindowPE pulls a halo around each block, which only a pure source
    # such as the loop can serve; the tape is stateful)
    both = pg.ArrayPE(np.ones((1, 2), np.float32), pg.ExtendMode.HOLD_BOTH)
    noise = pg.GainPE(both, pg.NoisePE(seed=seed, mode=pg.NoiseMode.BROWN))
    air = pg.GainPE(noise, pg.WindowPE(loop, 0.05, pg.WindowMode.RMS))

    # a phase-scrambled 2 s stretch of the recording, a sixth of the way in
    stretch = pg.SlicePE(reader, n_src // 3, min(2 * SR, n_src // 3))
    scrambled = pg.DelayPE(pg.TralfamPE(stretch, seed=seed), total // 6)

    mix = pg.MixPE(pg.GainPE(tape, 0.5), pg.GainPE(hits, 0.6), pg.GainPE(drone, 0.15),
                   pg.GainPE(air, 0.5), pg.GainPE(scrambled, 0.4))
    comp = pg.CompressorPE(mix, threshold=-18.0, ratio=4.0, attack=0.005, release=0.1)
    wet = pg.ReverbPE(comp, sources["ir"], mix=0.25)
    out = pg.CropPE(wet, 0, total)
    parts = {"rate": rate, "tape": tape, "loop": loop}
    if out_path is not None:
        out = parts["writer"] = pg.WavWriterPE(out, out_path, subtype="FLOAT")
    return out, parts
