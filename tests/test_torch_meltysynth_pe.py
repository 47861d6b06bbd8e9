"""PyTorch port, MeltysynthPE and MidiInPE against the JAX package's: the
graphs of tests/test_live_midi_path.py (a MIDI drain mixed before the
synth, so an event fed before a block sounds in it), rendered block by
block through both packages on the CPU. Tolerance: 2e-5, the streaming
synth's (tests/test_torch_synth_stream.py).

The JAX graphs adapt the drain's mono silence to stereo with SpatialPE,
which the port does not have yet; the port's graphs use a two-line
adapter of this file (the drain's output is silence either way).
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.models import midi_in
from pygmu2_tpu_torch.soundfont import SoundFont, Synthesizer, SynthesizerSettings
from pygmu2_tpu_torch.soundfont.build import build_sf2, make_looped_sample

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _sample_rate():
    jpg.set_sample_rate(44100)
    tpg.set_sample_rate(44100)


class _Stereo(tpg.ProcessingElement):
    """The mono source on both channels."""

    def __init__(self, source):
        self._source = source

    def inputs(self):
        return [self._source]

    def channel_count(self):
        return 2

    def _compute_extent(self):
        return Extent(None, None)

    def _trace(self, ctx):
        return ctx.pull(self._source).expand(-1, 2)


def _font(tmp_path, name, freq, root):
    path = tmp_path / name
    path.write_bytes(build_sf2([{"data": make_looped_sample(freq, harmonics=3), "rate": 44100,
                                 "root_key": root, "loop": True}]))
    return str(path)


def _graph(pg, path):
    synth_pe = pg.MeltysynthPE(path, block_size=64)
    midi_pe = pg.MidiInPE(
        port_name=None,
        callback=lambda start, msg: synth_pe.synthesizer.process_midi_message(*msg),
    )
    if pg is jpg:
        midi_2ch = pg.SpatialPE(midi_pe, method=pg.SpatialAdapter(channels=2))
    else:
        midi_2ch = _Stereo(midi_pe)
    return pg.MixPE(midi_2ch, synth_pe), synth_pe, midi_pe


def _play(pg, path, script):
    """Run ``script`` (a list of ("render", start, n) and ("feed", msg)
    steps) through the package's graph; the rendered blocks in order."""
    graph, _synth_pe, midi_pe = _graph(pg, path)
    kw = {} if pg is jpg else {"device": "cpu"}
    out = []
    with pg.NullRenderer() as r:
        r.set_source(graph)
        r.start()
        for step in script:
            if step[0] == "feed":
                midi_pe.feed(step[1])
            else:
                out.append(np.asarray(graph.render(step[1], step[2], **kw).data))
    return out


def test_live_midi_to_audio_matches_jax(tmp_path):
    path = _font(tmp_path, "test.sf2", 261.63, 60)
    script = [("render", 0, 512), ("feed", (0, 0x90, 60, 100)), ("render", 512, 512),
              ("feed", (0, 0x80, 60, 0))] + [("render", k * 512, 512) for k in range(2, 40)]
    want, got = _play(jpg, path, script), _play(tpg, path, script)
    assert np.abs(got[0]).max() < 1e-7  # no events yet: silence
    assert np.abs(got[1]).max() > 1e-4 and got[1].shape == (512, 2)  # the note, at once
    assert np.abs(got[-1]).max() < 1e-3  # released and decayed
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)


def test_pull_order_midi_before_synth_matches_jax(tmp_path):
    """The mix pulls MidiInPE before MeltysynthPE, so an event fed before a
    block is audible within that block, as in the JAX package."""
    path = _font(tmp_path, "t2.sf2", 440.0, 69)
    script = [("render", 0, 256), ("feed", (0, 0x90, 69, 110)), ("render", 256, 256)]
    want, got = _play(jpg, path, script), _play(tpg, path, script)
    assert np.abs(got[1]).max() > 1e-4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)


def test_meltysynth_pe_equals_the_synthesizer(tmp_path):
    """The PE's blocks stay on the render's device and equal the
    synthesizer's own ``render_stereo`` bit for bit, across renders that
    split its blocks."""
    path = _font(tmp_path, "t3.sf2", 261.63, 60)
    pe = tpg.MeltysynthPE(path, block_size=64, program=0)
    assert pe.synthesizer is None and pe.channel_count() == 2 and not pe.is_pure()
    assert repr(pe).startswith("MeltysynthPE(soundfont_path=")
    with tpg.NullRenderer() as r:
        r.set_source(pe)
        r.start()
        pe.synthesizer.note_on(0, 60, 100)
        got = np.concatenate([np.asarray(pe.render(s, n, device="cpu").data)
                              for s, n in ((0, 100), (100, 28), (128, 500))])
        assert pe.synthesizer.device == torch.device("cpu")
    assert pe.synthesizer is None  # released at stop
    ref = Synthesizer(SoundFont.from_file(path), SynthesizerSettings(block_size=64),
                      device="cpu")
    ref.process_midi_message(0, 0xC0, 0, 0)
    ref.note_on(0, 60, 100)
    np.testing.assert_array_equal(got, ref.render_stereo(628))


def test_meltysynth_pe_missing_font(tmp_path):
    pe = tpg.MeltysynthPE(str(tmp_path / "missing.sf2"))
    with pytest.raises(FileNotFoundError):
        pe._on_start()


def test_midi_in_drains_in_order_once_a_block():
    got = []
    pe = tpg.MidiInPE(port_name=None, callback=lambda start, msg: got.append((start, msg)))
    assert pe.channel_count() == 1 and not pe.is_pure() and repr(pe) == "MidiInPE(port_name=default)"
    pe.feed("a")
    pe.feed("b")
    out = np.asarray(pe.render(128, 64, device="cpu").data)
    assert out.shape == (64, 1) and not out.any()
    pe.feed("c")
    pe.render(192, 64, device="cpu")
    assert got == [(128, "a"), (128, "b"), (192, "c")]


@pytest.mark.skipif(midi_in.mido is not None, reason="mido is installed here")
def test_midi_in_needs_mido_for_a_port():
    with pytest.raises(RuntimeError):
        tpg.MidiInPE(port_name="some port")
    tpg.MidiInPE(port_name="some port", require_mido=False)


def test_render_to_array_matches_jax(tmp_path):
    """A chord fed to the drain before ``render_to_array`` (which starts the
    PEs, so the synth exists when the first block drains it), as the
    card's smoke run drives it: 0.1 s at synth block 64 in render blocks of
    1024."""
    path = _font(tmp_path, "t4.sf2", 261.63, 60)
    outs = []
    for pg in (jpg, tpg):
        graph, _synth_pe, midi_pe = _graph(pg, path)
        graph = pg.CropPE(graph, 0, 4410)
        for key in (48, 55, 60, 64):
            midi_pe.feed((0, 0x90, key, 100))
        kw = {} if pg is jpg else {"device": "cpu"}
        outs.append(np.asarray(pg.render_to_array(graph, block=1024, **kw)))
    want, got = outs
    assert got.shape == want.shape == (4410, 2) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
