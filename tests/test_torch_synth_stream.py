"""PyTorch port, the streaming SoundFont synth against the JAX package's, on
the CPU (the port's plain versions; the JAX package's XLA branch).

The same fonts (``bench_workload.build_font_bytes``, ``soundfont.build``)
and scores go through both packages at small sizes (32 voices, block 64,
at most 1 s). Tolerances:

- ``Synthesizer._block_kernel``, one block from seeded voice state: audio
  within 2e-5 × max(1, peak); ``active``, ``released``, ``epoch`` equal;
  ``osc_pos`` within 1e-9;
- ``render_stereo`` and ``render_midi_schedule``: 2e-5, the JAX package's
  offline-against-scanned bound (tests/test_soundfont_offline.py);
- ``MidiFileSequencer.render`` against the JAX sequencer: 1e-4
  (tests/test_midi_sequencer_breadth.py); against the port's own
  ``render_midi_offline``: 2e-5 (tests/test_soundfont.py);
- ``render`` in uneven counts against one ``render_stereo``: bit for bit;
- ``compute_control``: the JAX package's bit for bit (numpy both);
  ``render_midi_offline_hostctl``: 2e-5 of the JAX package's.
"""

import struct

import numpy as np
import pytest
import torch

from pygmu2_tpu.soundfont import MidiFile as JMidiFile
from pygmu2_tpu.soundfont import MidiFileSequencer as JSequencer
from pygmu2_tpu.soundfont import SoundFont as JSoundFont
from pygmu2_tpu.soundfont import Synthesizer as JSynth
from pygmu2_tpu.soundfont import SynthesizerSettings as JSettings
from pygmu2_tpu.soundfont import offline as joff
from pygmu2_tpu_torch import bench_workload
from pygmu2_tpu_torch.soundfont import MidiFile, MidiFileSequencer, SoundFont, Synthesizer
from pygmu2_tpu_torch.soundfont import SynthesizerSettings
from pygmu2_tpu_torch.soundfont import offline as toff
from pygmu2_tpu_torch.soundfont import synthesizer as tsynth
from pygmu2_tpu_torch.soundfont.build import build_sf2, make_looped_sample
from tests.test_soundfont import build_midi

torch.set_num_threads(1)

SR = 44100
POLY = 32
BLOCK = 64


def _pair(font, block=BLOCK, poly=POLY):
    """The same font in both packages: (JAX synthesizer, the port's on the CPU)."""
    return (JSynth(JSoundFont(font), JSettings(block_size=block, maximum_polyphony=poly)),
            Synthesizer(SoundFont(font), SynthesizerSettings(block_size=block,
                                                             maximum_polyphony=poly),
                        device="cpu"))


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---- one block of the voice engine ------------------------------------------


def _block_inputs(N, seed):
    """Both synthesizers after the same seeded note-ons, note-offs and
    controllers, and seeded voice state: (jax synth, port synth, par, ch,
    dyn), the last three numpy."""
    js, ts = _pair(bench_workload.build_font_bytes(False), block=N)
    rng = np.random.default_rng(seed)
    for synth in (js, ts):
        r = np.random.default_rng(seed)
        for i in range(28):
            synth.note_on(i % 4, int(r.integers(36, 96)), int(r.integers(30, 127)))
        for i in range(6):
            synth.note_off(i % 4, int(r.integers(36, 96)))
        synth.process_midi_message(1, 0xE0, 0, 100)   # pitch bend up
        synth.process_midi_message(2, 0xB0, 1, 90)    # modulation wheel
        synth.process_midi_message(3, 0xB0, 10, 20)   # pan left
        synth.process_midi_message(0, 0xB0, 64, 127)  # hold pedal
    par = {k: v.copy() for k, v in ts._par.items()}
    for k, v in js._par.items():
        np.testing.assert_array_equal(par[k], v)
    ch = ts._channel_arrays()
    P = POLY
    span = np.maximum(par["smp_end"] - par["smp_start"], 1.0)
    vt = rng.integers(0, 300, P).astype(np.int32) * N
    vt[:4] = 0  # first blocks
    dyn = {
        "epoch": np.where(rng.random(P) < 0.3, -1, par["epoch"]).astype(np.int32),
        "active": rng.random(P) < 0.85,
        "voice_time": vt,
        "released": rng.random(P) < 0.3,
        "rel_t": (vt / SR * rng.random(P)).astype(np.float32),
        "rel_vol": rng.random(P).astype(np.float32),
        "rel_mod": rng.random(P).astype(np.float32),
        "osc_pos": par["smp_start"] + rng.random(P) * span * 1.2,
        "fx1": (rng.standard_normal(P) * 0.1).astype(np.float32),
        "fx2": (rng.standard_normal(P) * 0.1).astype(np.float32),
        "fy1": (rng.standard_normal(P) * 0.1).astype(np.float32),
        "fy2": (rng.standard_normal(P) * 0.1).astype(np.float32),
        "sm_cutoff": (par["cutoff"] * rng.uniform(0.6, 1.5, P)).astype(np.float32),
        "prev_gl": rng.uniform(0.0, 0.5, P).astype(np.float32),
        "prev_gr": rng.uniform(0.0, 0.5, P).astype(np.float32),
    }
    return js, ts, par, ch, dyn


@pytest.mark.parametrize("N", [64, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_kernel_matches_jax(N, seed):
    import jax

    js, ts, par, ch, dyn = _block_inputs(N, seed)
    want_dyn, want = jax.jit(js._block_kernel)(dyn, par, ch, np.float32(0.5))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in dyn.items()}
    got_dyn, got = ts._block_kernel(
        t, {k: torch.from_numpy(v) for k, v in par.items()},
        {k: torch.from_numpy(v) for k, v in ch.items()}, 0.5)
    want = np.asarray(want)
    assert got.shape == want.shape == (N, 2) and np.abs(want).max() > 1e-3
    _close(got.numpy(), want, 2e-5 * max(1.0, float(np.abs(want).max())))
    for k in ("active", "released", "epoch", "voice_time"):
        np.testing.assert_array_equal(got_dyn[k].numpy(), np.asarray(want_dyn[k]))
    assert got_dyn["osc_pos"].dtype == torch.float64
    _close(got_dyn["osc_pos"].numpy(), np.asarray(want_dyn["osc_pos"]), 1e-9)


# ---- whole renders -----------------------------------------------------------


def _looped_font(**kw):
    return build_sf2([{"data": make_looped_sample(261.63, harmonics=4), "rate": SR,
                       "root_key": 60, "loop": True, **kw}])


def _loop_until_note_off_font():
    font = build_sf2([{"data": make_looped_sample(261.63, cycles=8), "rate": SR,
                       "root_key": 60, "loop": True, "release_tc": -3000}])
    # loop mode LOOP_UNTIL_NOTE_OFF (3) in the igen record
    return font.replace(struct.pack("<Hh", 54, 1), struct.pack("<Hh", 54, 3))


def _retriggers():
    events = []
    for i in range(12):
        events.append((i * 0.08, 0x90, 60 + (i % 3), 100))
        events.append((i * 0.08 + 0.05, 0x80, 60 + (i % 3), 0))
    return events


# tests/test_soundfont_offline.py's scores, cut to at most 1 s: (font,
# events, seconds, polyphony)
SCORES = {
    "chord with note-offs": (
        lambda: _looped_font(attack_tc=-9000, release_tc=-5000),
        [(0.0, 0x90, 60, 100), (0.0, 0x90, 64, 90), (0.1, 0x90, 67, 80),
         (0.4, 0x80, 60, 0), (0.6, 0x80, 64, 0), (0.7, 0x80, 67, 0)], 0.9, POLY),
    "pitch bend and controllers": (
        lambda: build_sf2([{"data": make_looped_sample(220.0, harmonics=3), "rate": SR,
                            "root_key": 57, "loop": True}]),
        [(0.0, 0x90, 57, 100), (0.15, 0xE0, 0, 96), (0.3, 0xB0, 7, 70),
         (0.45, 0xE0, 0, 64), (0.6, 0x80, 57, 0)], 0.8, POLY),
    "no loop, the sample ends": (
        lambda: build_sf2([{"data": make_looped_sample(261.63, cycles=4), "rate": SR,
                            "root_key": 60, "loop": False}]),
        [(0.0, 0x90, 60, 100), (0.0, 0x90, 72, 100)], 0.3, POLY),
    "loop until note-off": (
        _loop_until_note_off_font, [(0.0, 0x90, 60, 100), (0.3, 0x80, 60, 0)], 0.6, POLY),
    "retrigger one slot": (
        lambda: _looped_font(release_tc=-7000), _retriggers(), 1.0, 8),
}


@pytest.fixture(scope="module")
def schedule_renders():
    """Each score through both packages' ``render_midi_schedule``."""
    out = {}
    for name, (font, events, seconds, poly) in SCORES.items():
        data, mb = font(), build_midi(events)
        js, ts = _pair(data, poly=poly)
        out[name] = (js.render_midi_schedule(JMidiFile(mb), seconds),
                     ts.render_midi_schedule(MidiFile(mb), seconds))
    return out


@pytest.mark.parametrize("name", list(SCORES))
def test_render_midi_schedule_matches_jax(schedule_renders, name):
    want, got = schedule_renders[name]
    _font, _events, seconds, _poly = SCORES[name]
    assert got.shape == want.shape == (int(round(seconds * SR)), 2)
    assert np.abs(want).max() > 1e-4
    _close(got, want, 2e-5)


def test_render_stereo_of_a_note_matches_jax():
    js, ts = _pair(_looped_font(attack_tc=-9000, release_tc=-5000))
    for synth in (js, ts):
        synth.note_on(0, 60, 100)
        synth.note_on(0, 67, 80)
    want, got = js.render_stereo(6000), ts.render_stereo(6000)
    for synth in (js, ts):
        synth.note_off(0, 60)
    want = np.concatenate([want, js.render_stereo(3000)])
    got = np.concatenate([got, ts.render_stereo(3000)])
    assert np.abs(want).max() > 1e-2
    _close(got, want, 2e-5)
    assert ts.active_voice_count == js.active_voice_count >= 1


def test_render_in_uneven_counts_equals_one_render():
    font = _looped_font(release_tc=-5000)
    one = Synthesizer(SoundFont(font), SynthesizerSettings(block_size=BLOCK,
                                                          maximum_polyphony=8),
                      device="cpu")
    parts = Synthesizer(SoundFont(font), SynthesizerSettings(block_size=BLOCK,
                                                            maximum_polyphony=8),
                        device="cpu")
    for synth in (one, parts):
        synth.note_on(0, 60, 100)
        synth.note_on(1, 64, 90)
    want = one.render_stereo(1000)
    left, right = np.zeros(1000, np.float32), np.zeros(1000, np.float32)
    at = 0
    for n in (1, 63, 64, 100, 7, 500, 265):
        parts.render(left, right, at, n)
        at += n
    np.testing.assert_array_equal(np.stack([left, right], axis=1), want)


def test_render_refuses_unequal_buffers():
    _js, ts = _pair(_looped_font())
    with pytest.raises(tsynth.MeltysynthError):
        ts.render(np.zeros(10, np.float32), np.zeros(11, np.float32))


# ---- no host sync inside render_midi_schedule's block loop -----------------


def test_render_midi_schedule_loop_does_not_sync(monkeypatch):
    """Inside the block loop nothing reads a tensor back to the host: the
    methods that would (``cpu``, ``item``, ``tolist``, ``numpy``, a tensor
    tested for truth or turned into a number) are counted while a block
    renders, and the render downloads once."""
    names = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__", "__float__",
             "__index__")
    calls = {n: 0 for n in names}
    state = {"in_block": False, "in_loop_calls": 0}
    for n in names:
        orig = getattr(torch.Tensor, n)

        def counted(self, *a, _n=n, _orig=orig, **kw):
            calls[_n] += 1
            if state["in_block"]:
                state["in_loop_calls"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, n, counted)
    orig_kernel = Synthesizer._block_kernel

    def block(self, *a, **kw):
        state["in_block"] = True
        try:
            return orig_kernel(self, *a, **kw)
        finally:
            state["in_block"] = False

    monkeypatch.setattr(Synthesizer, "_block_kernel", block)
    font, events, seconds, poly = SCORES["chord with note-offs"]
    _js, ts = _pair(font(), poly=poly)
    out = ts.render_midi_schedule(MidiFile(build_midi(events)), 0.3)
    assert np.abs(out).max() > 1e-3
    assert state["in_loop_calls"] == 0
    # the one download: out.cpu().numpy()
    assert calls["cpu"] == calls["numpy"] == 1 and sum(calls.values()) == 2


# ---- the sequencer -------------------------------------------------------------


def _simple_events():
    return [(0.0, 0x90, 60, 100), (0.5, 0x80, 60, 0), (0.5, 0x90, 64, 100),
            (1.0, 0x80, 64, 0)]


def _seq_pair(block=BLOCK, poly=8):
    js, ts = _pair(build_sf2([{"data": make_looped_sample(261.63), "rate": SR,
                               "root_key": 60, "loop": True}]), block=block, poly=poly)
    return JSequencer(js), MidiFileSequencer(ts)


def _seq_render(seq, n, calls=None):
    left, right = np.zeros(n, np.float32), np.zeros(n, np.float32)
    if calls is None:
        seq.render(left, right)
    else:
        at = 0
        for c in calls:
            seq.render(left, right, at, c)
            at += c
    return np.stack([left, right], axis=1)


def test_sequencer_window_matches_jax():
    """An offset/count window writes only its samples, as the JAX
    sequencer's, and the rest of the score follows in uneven calls."""
    mb = build_midi(_simple_events())
    outs = []
    for seq, midi in zip(_seq_pair(), (JMidiFile(mb), MidiFile(mb))):
        seq.play(midi)
        left = np.full(512, -9.0, np.float32)
        right = np.full(512, -9.0, np.float32)
        seq.render(left, right, offset=128, count=256)
        np.testing.assert_array_equal(left[:128], -9.0)
        np.testing.assert_array_equal(left[384:], -9.0)
        rest = _seq_render(seq, 30000, calls=(1000, 4096, 24904))
        outs.append((left, right, rest))
    (jl, jr, jrest), (tl, tr, trest) = outs
    assert np.abs(jrest).max() > 1e-2
    _close(tl, jl, 1e-4)
    _close(tr, jr, 1e-4)
    _close(trest, jrest, 1e-4)


def test_sequencer_offset_without_count_raises():
    _jseq, seq = _seq_pair()
    with pytest.raises(ValueError):
        seq.render(np.zeros(8, np.float32), np.zeros(8, np.float32), offset=2)


def test_sequencer_loop_matches_jax():
    mb = build_midi([(0.0, 0x90, 60, 100), (0.05, 0x80, 60, 0)])
    outs = []
    for seq, midi in zip(_seq_pair(), (JMidiFile(mb), MidiFile(mb))):
        seq.play(midi, loop=True)
        outs.append(_seq_render(seq, int(0.4 * SR)))
    want, got = outs
    assert np.abs(want[int(0.3 * SR):]).max() > 1e-3  # retriggered past one pass
    _close(got, want, 1e-4)


def test_sequencer_stop_matches_jax():
    mb = build_midi(_simple_events())
    outs = []
    for seq, midi in zip(_seq_pair(), (JMidiFile(mb), MidiFile(mb))):
        seq.play(midi)
        first = _seq_render(seq, int(0.2 * SR))
        seq.stop()
        outs.append(np.concatenate([first, _seq_render(seq, 4096)]))
    want, got = outs
    assert np.abs(want[-100:]).max() < 1e-3
    _close(got, want, 1e-4)


def test_sequencer_matches_its_offline_render():
    """The streamed sequencer against the port's own one-launch render, as
    tests/test_soundfont.py holds the JAX package's."""
    mb = build_midi([(0.0, 0x90, 60, 100), (0.0, 0x90, 64, 100), (0.0, 0x90, 67, 100),
                     (0.5, 0x80, 60, 0), (0.5, 0x80, 64, 0), (0.5, 0x80, 67, 0)])
    _jseq, seq = _seq_pair(poly=POLY)
    seq.play(MidiFile(mb))
    streamed = _seq_render(seq, int(round(0.7 * SR)))
    _jseq, seq2 = _seq_pair(poly=POLY)
    seq2.play(MidiFile(mb))
    offline = seq2.render_to_array(0.7, device="cpu")
    assert np.abs(offline).max() > 1e-2
    _close(streamed, offline, 2e-5)


# ---- the host control pass ---------------------------------------------------


@pytest.fixture(scope="module")
def hostctl_case():
    font, events, seconds, poly = SCORES["chord with note-offs"]
    return font(), build_midi(events), 0.7, poly


def test_compute_control_equals_jax(hostctl_case):
    font, mb, seconds, poly = hostctl_case
    js, ts = _pair(font, poly=poly)
    want = joff.compute_control(js, *js.build_schedule(JMidiFile(mb), seconds)[:3])
    got = toff.compute_control(ts, *ts.build_schedule(MidiFile(mb), seconds)[:3])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    loop = toff._compute_control_loop(ts, *ts.build_schedule(MidiFile(mb), seconds)[:3])
    np.testing.assert_array_equal(loop["alive"], got["alive"])


def test_render_midi_offline_hostctl_matches_jax(hostctl_case):
    font, mb, seconds, poly = hostctl_case
    js, ts = _pair(font, poly=poly)
    want = joff.render_midi_offline_hostctl(js, JMidiFile(mb), seconds)
    got = toff.render_midi_offline_hostctl(ts, MidiFile(mb), seconds, device="cpu")
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    _close(got, want, 2e-5)
