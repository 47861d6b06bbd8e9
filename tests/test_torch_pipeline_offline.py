"""PyTorch port: ``render_midi_offline(pipeline=K)`` on the CPU.

K > 1 renders the fused audio pass in K segments of blocks with the (4, P)
filter state carried between them; it must equal the one-pass render
within 1e-6 (tests/test_pipeline_offline.py:103's bound; the kernel's
plain version composes its segment states in another grouping across a
segment's edge: observed within 4.1e-7), for ragged splits, for K beyond
the block count (clamped), and on the int16 wire within one LSB. The
automatic choice (``pipeline=None``) renders in one pass, and the unfused
pass ignores ``pipeline``.
"""

import numpy as np
import pytest
import torch

from pygmu2_tpu_torch import bench_workload
from pygmu2_tpu_torch.soundfont import MidiFile, SoundFont, Synthesizer, SynthesizerSettings
from pygmu2_tpu_torch.soundfont import filter_kernels as fk
from pygmu2_tpu_torch.soundfont import offline as off
from pygmu2_tpu_torch.soundfont.build import build_sf2, make_looped_sample
from tests.test_soundfont import build_midi

torch.set_num_threads(1)

SR = 44100
SECONDS = 0.25  # 87 blocks of 128
EVENTS = [
    (0.0, 0x90, 60, 100),
    (0.0, 0x91, 64, 90),
    (0.02, 0x92, 67, 80),
    (0.12, 0x80, 60, 0),
    (0.15, 0x81, 64, 0),
]


@pytest.fixture(scope="module")
def font():
    return build_sf2([{"data": make_looped_sample(261.63, harmonics=4), "rate": SR,
                       "root_key": 60, "loop": True, "attack_tc": -9000,
                       "release_tc": -5000}])


def _render(font, pipeline, wire="f32"):
    synth = Synthesizer(SoundFont(font), SynthesizerSettings(block_size=128,
                                                             maximum_polyphony=128),
                        device="cpu")
    return off.render_midi_offline(synth, MidiFile(build_midi(EVENTS)), SECONDS, wire=wire,
                                   pipeline=pipeline, device="cpu")


@pytest.fixture(scope="module")
def one_pass(font):
    out = _render(font, 0)
    assert out.shape == (int(SECONDS * SR), 2) and np.abs(out).max() > 1e-3
    return out


@pytest.mark.parametrize("k", [2, 3, 4, 5, 7])
def test_segments_match_one_pass(font, one_pass, k):
    got = _render(font, k)
    assert got.shape == one_pass.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, one_pass, rtol=0, atol=1e-6)


def test_more_segments_than_blocks_clamps(font, one_pass, monkeypatch):
    calls = []
    real = fk.osc_filter_gain_mix

    def spy(rows, *a, **kw):
        calls.append(rows["ratio"].shape[0])
        return real(rows, *a, **kw)

    monkeypatch.setattr(fk, "osc_filter_gain_mix", spy)
    got = _render(font, 1000)
    np.testing.assert_allclose(got, one_pass, rtol=0, atol=1e-6)
    assert len(calls) == 87 and set(calls) == {1}  # one block a segment
    calls.clear()
    _render(font, 4)
    assert calls == [22, 22, 22, 21]  # ragged: the first n % K one longer


def test_int16_wire(font):
    mono = _render(font, 0, wire="int16")
    piped = _render(font, 4, wire="int16")
    assert mono.dtype == piped.dtype == np.int16 and np.abs(mono.astype(np.int32)).max() > 100
    assert np.abs(piped.astype(np.int32) - mono.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("pipeline", [None, 0, 1])
def test_one_pass_choices(font, one_pass, pipeline, monkeypatch):
    calls = []
    real = fk.osc_filter_gain_mix

    def spy(rows, *a, **kw):
        calls.append(rows["ratio"].shape[0])
        return real(rows, *a, **kw)

    monkeypatch.setattr(fk, "osc_filter_gain_mix", spy)
    np.testing.assert_array_equal(_render(font, pipeline), one_pass)
    assert calls == [87]  # one launch over every block


def test_unfused_pass_ignores_pipeline(monkeypatch):
    """A large font above its window takes the unfused pass in one pass."""
    def boom(*a, **kw):  # pragma: no cover - must not run
        raise AssertionError("the unfused pass was segmented")

    monkeypatch.setattr(off, "_render_segments", boom)
    synth, _ = bench_workload.build_workload(True)
    midi = MidiFile(bench_workload.build_high_midi_bytes(0.5))
    out = off.render_midi_offline(synth, midi, 0.5, pipeline=4, device="cpu")
    assert out.shape == (22050, 2) and np.isfinite(out).all()
