"""The generative stereo performance: the PE-graph workload of the
generative and control PEs, spatialised.

:func:`build_performance` takes a package namespace ``pg`` —
``pygmu2_tpu_torch`` or the JAX package ``pygmu2_tpu`` — so the same
graph can be built from either and the two renders compared. It sets the
sample rate to 44.1 kHz. The performance is 60 s of stereo
(``PERFORMANCE_SECONDS``; 2,646,000 frames, 162 blocks of 16384); every
shape of the graph is fixed by that length and by ``seed`` (numpy), and
``seconds`` only crops it, so a shorter render is the head of the full
one. Four voices, mixed:

- **lead**: 120 seeded MIDI pitches (48–72, 0.5 s each), tuned in just
  intonation, glide through a PortamentoPE (ramps up to 80 ms) into a
  7-voice SuperSawPE, a LadderPE whose cutoff is a SMOOTH RandomPE at
  2 Hz over 400–4000 Hz, gated by an AdsrGatedPE on a 2 Hz gate, placed by
  the KEMAR HRTF at 30° azimuth;
- **bass**: an AnalogOscPE rectangle at half the glide, its duty a
  PiecewisePE 0.1 → 0.5 → 0.9 over the performance, panned at constant
  power by an 8 Hz WALK RandomPE over ±45°;
- **percussion**: a RandomSelectPE on a 4 Hz trigger picks one of four
  0.1 s clips (white noise, a BLIT saw, an AnalogOsc sawtooth, a seeded
  array) with weights 4:2:1:1, its level an 8 Hz triggered WALK, placed
  by the HRTF at −60° azimuth and 10° elevation;
- **accents**: a ONE_SHOT TriggerPE on a 1 Hz gate over a 0.3 s saw, a
  TriggerRestartPE on a 0.5 Hz trigger over a 0.5 s AnalogOsc and a
  ResetPE of a 1 s saw on a 0.25 Hz trigger, panned linearly by a
  SAMPLE_HOLD RandomPE triggered at 1 Hz.

On the card the ladder and the ADSR run their kernels
(``csrc/ladder_scan.cu``, ``csrc/adsr_scan.cu``) once a block each, and
the HRTFs their FFTs on cuFFT; every other PE runs in plain tensor ops.
"""

from __future__ import annotations

import numpy as np

SR = 44100
PERFORMANCE_SECONDS = 60.0
BLOCK = 16384
N_NOTES = 120
NOTE_SECONDS = 0.5


def melody(seed: int = 0) -> np.ndarray:
    """The lead's MIDI pitches: ``N_NOTES`` seeded integers in 48..72."""
    return np.random.default_rng(seed).integers(48, 73, N_NOTES)


def _drum(seed: int, n: int) -> np.ndarray:
    """(n, 1) float32: a seeded noise burst under a 30 ms exponential decay."""
    rng = np.random.default_rng(seed)
    env = np.exp(-np.arange(n) / (0.03 * SR))
    return (0.8 * env * rng.uniform(-1.0, 1.0, n)).astype(np.float32)[:, None]


def build_performance(pg, seconds: float = PERFORMANCE_SECONDS, seed: int = 0):
    """The performance's graph, cropped to ``seconds`` at 44.1 kHz.

    Returns the stereo root (a CropPE of the four voices' MixPE)."""
    pg.set_sample_rate(SR)
    full = int(round(PERFORMANCE_SECONDS * SR))
    note = int(round(NOTE_SECONDS * SR))
    clip = int(round(0.1 * SR))

    # lead: the glide in Hz, just intonation
    freqs = pg.pitch_to_freq(melody(seed), temperament=pg.JustIntonation())
    notes = [(float(f), i * note, note) for i, f in enumerate(freqs)]
    glide = pg.PortamentoPE(notes, max_ramp_seconds=0.08, ramp_fraction=0.3)
    saw = pg.SuperSawPE(glide, amplitude=0.3, voices=7, detune_cents=18.0, seed=seed + 1)
    cutoff = pg.RandomPE(2.0, 400.0, 4000.0, pg.RandomMode.SMOOTH, seed=seed + 2)
    ladder = pg.LadderPE(saw, cutoff, 0.4)
    env = pg.AdsrGatedPE(pg.PeriodicGate(2.0), 0.01, 0.1, 0.6, 0.15)
    lead = pg.SpatialPE(pg.GainPE(ladder, env), method=pg.SpatialHRTF(30.0))

    # bass: half the glide, the duty swept over the performance
    duty = pg.PiecewisePE([(0, 0.1), (full // 2, 0.5), (full, 0.9)],
                          extend_mode=pg.ExtendMode.HOLD_BOTH)
    bass = pg.GainPE(pg.AnalogOscPE(pg.GainPE(glide, 0.5), duty), 0.2)
    pan = pg.RandomPE(8.0, -45.0, 45.0, pg.RandomMode.WALK, seed=seed + 3)
    bass = pg.SpatialPE(bass, method=pg.SpatialConstantPower(pan))

    # percussion: four 0.1 s clips, chosen on a 4 Hz trigger
    clips = [
        pg.CropPE(pg.NoisePE(seed=seed + 5), 0, clip),
        pg.CropPE(pg.BlitSawPE(440.0, 0.5), 0, clip),
        pg.CropPE(pg.AnalogOscPE(330.0, 0.5, "sawtooth"), 0, clip),
        pg.ArrayPE(_drum(seed + 6, clip)),
    ]
    hits = pg.RandomSelectPE(pg.PeriodicTrigger(4.0), clips, weights=[4, 2, 1, 1],
                             seed=seed + 4)
    level = pg.RandomPE(1.0, 0.1, 0.6, pg.RandomMode.WALK, seed=seed + 7,
                        trigger=pg.PeriodicTrigger(8.0), step_size=0.3)
    perc = pg.SpatialPE(pg.GainPE(hits, level), method=pg.SpatialHRTF(-60.0, elevation=10.0))

    # accents: three clip players, panned by a held random azimuth
    one_shot = pg.TriggerPE(pg.PeriodicGate(1.0), pg.CropPE(pg.BlitSawPE(880.0, 0.3), 0,
                                                             int(0.3 * SR)))
    restart = pg.TriggerRestartPE(pg.PeriodicTrigger(0.5),
                                  pg.CropPE(pg.AnalogOscPE(660.0, 0.3), 0, int(0.5 * SR)))
    reset = pg.ResetPE(pg.CropPE(pg.BlitSawPE(220.0, 0.2), 0, SR), pg.PeriodicTrigger(0.25))
    az = pg.RandomPE(1.0, -60.0, 60.0, pg.RandomMode.SAMPLE_HOLD, seed=seed + 8,
                     trigger=pg.PeriodicTrigger(1.0))
    accents = pg.SpatialPE(pg.GainPE(pg.MixPE(one_shot, restart, reset), 0.3),
                           method=pg.SpatialLinear(az))

    return pg.CropPE(pg.MixPE(lead, bass, perc, accents), 0, int(round(seconds * SR)))
