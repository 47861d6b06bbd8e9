"""PyTorch port, host half: SF2 parsing and the offline event simulation.

The port carries numpy-only copies of the JAX package's SF2 parser and
event machine (``pygmu2_tpu_torch.soundfont``); their output must equal
the JAX package's exactly — the schedule is the input of every later
stage, so any drift here would show up as audio differences downstream.
"""

import numpy as np
import pytest
import torch

import bench
from pygmu2_tpu import soundfont as jsf
from pygmu2_tpu_torch import bench_workload
from pygmu2_tpu_torch import soundfont as tsf
from tests.test_soundfont import build_midi

torch.set_num_threads(1)

SETTINGS = dict(sample_rate=44100, block_size=256, maximum_polyphony=32)


@pytest.fixture(scope="module")
def fonts():
    return {large: bench.build_font_bytes(large=large) for large in (False, True)}


def _random_score(seed: int, seconds: float):
    """Seeded score on 4 channels: note on/off, pitch bends, modulation,
    volume, pan, expression, hold pedal and program changes."""
    rng = np.random.default_rng(seed)
    events = []
    for ch in range(4):
        events.append((0.0, 0xC0 | ch, int(rng.integers(0, 2)), 0))
    held = []
    for t in np.sort(rng.uniform(0.0, seconds, 120)):
        ch = int(rng.integers(0, 4))
        kind = rng.integers(0, 8)
        if kind < 3 or not held:
            key = int(rng.integers(36, 96))
            events.append((t, 0x90 | ch, key, int(rng.integers(1, 128))))
            held.append((ch, key))
        elif kind == 3:
            c, k = held.pop(int(rng.integers(0, len(held))))
            events.append((t, 0x80 | c, k, 0))
        elif kind == 4:
            events.append((t, 0xE0 | ch, int(rng.integers(0, 128)),
                           int(rng.integers(0, 128))))
        else:
            cc = [0x01, 0x07, 0x0A, 0x0B, 0x40][int(rng.integers(0, 5))]
            events.append((t, 0xB0 | ch, cc, int(rng.integers(0, 128))))
    return build_midi(events)


def _assert_same_schedule(a, b):
    par_a, ch_a, snap_a, nb_a = a
    par_b, ch_b, snap_b, nb_b = b
    assert nb_a == nb_b
    np.testing.assert_array_equal(snap_a, snap_b)
    assert par_a.keys() == par_b.keys() and ch_a.keys() == ch_b.keys()
    for k in par_a:
        assert par_a[k].dtype == par_b[k].dtype, k
        np.testing.assert_array_equal(par_a[k], par_b[k], err_msg=k)
    for k in ch_a:
        assert ch_a[k].dtype == ch_b[k].dtype, k
        np.testing.assert_array_equal(ch_a[k], ch_b[k], err_msg=k)


@pytest.mark.parametrize("large", [False, True])
def test_soundfont_parse_equal(fonts, large):
    a = jsf.SoundFont(fonts[large])
    b = tsf.SoundFont(fonts[large])
    np.testing.assert_array_equal(np.asarray(a.wave_data), np.asarray(b.wave_data))
    assert [(p.name, p.bank_number, p.patch_number) for p in a.presets] == [
        (p.name, p.bank_number, p.patch_number) for p in b.presets
    ]
    for ia, ib in zip(a.instruments, b.instruments, strict=True):
        assert len(ia.regions) == len(ib.regions)
        for ra, rb in zip(ia.regions, ib.regions):
            np.testing.assert_array_equal(ra._gs, rb._gs)
            assert ra.sample_modes == rb.sample_modes


def test_bench_workload_builders_equal():
    assert bench_workload.build_font_bytes() == bench.build_font_bytes()
    assert bench_workload.build_midi_bytes(repeats=3) == bench.build_midi_bytes(
        repeats=3
    )


@pytest.mark.parametrize("large", [False, True])
def test_bench_schedule_equal(large):
    j_synth, j_midi = bench.build_workload(large)
    t_synth, t_midi = bench_workload.build_workload(large)
    np.testing.assert_array_equal(np.asarray(j_synth._wave), t_synth._wave)
    _assert_same_schedule(
        j_synth.build_schedule(j_midi, 3.0), t_synth.build_schedule(t_midi, 3.0)
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_random_score_schedule_equal(fonts, seed):
    midi_bytes = _random_score(seed, 1.5)
    font = fonts[True]
    j = jsf.Synthesizer(jsf.SoundFont(font), jsf.SynthesizerSettings(**SETTINGS))
    t = tsf.Synthesizer(tsf.SoundFont(font), tsf.SynthesizerSettings(**SETTINGS))
    _assert_same_schedule(
        j.build_schedule(jsf.MidiFile(midi_bytes), 1.6),
        t.build_schedule(tsf.MidiFile(midi_bytes), 1.6),
    )
    # the segmented simulation, segment by segment
    segs_j = j.build_schedule_segments(jsf.MidiFile(midi_bytes), 1.6, 37)
    segs_t = t.build_schedule_segments(tsf.MidiFile(midi_bytes), 1.6, 37)
    n = 0
    for a, b in zip(segs_j, segs_t, strict=True):
        _assert_same_schedule(a, b)
        n += 1
    assert n >= 3
