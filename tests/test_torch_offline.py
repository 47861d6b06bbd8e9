"""PyTorch port, the slice as a whole: ``render_midi_offline`` against the
JAX package's, on the bench workload (128 voices, block 1024) through
both bench fonts, on the CPU (the port's plain versions; the JAX
package's XLA branch).

Tolerances: 1e-4 against the JAX render (tests/test_bench_parity.py);
the int16 wire conversion exact, and the int16 render within the same
bound in LSBs; streamed against one pass 1e-5 (the JAX package's own
streamed bound).
"""

import numpy as np
import pytest
import torch

import bench
from pygmu2_tpu.soundfont import offline as joff
from pygmu2_tpu_torch import bench_workload
from pygmu2_tpu_torch.soundfont import MidiFileSequencer
from pygmu2_tpu_torch.soundfont import offline as toff

torch.set_num_threads(1)

SECONDS = 0.5


@pytest.fixture(scope="module", params=[False, True], ids=["small_font", "large_font"])
def renders(request):
    large = request.param
    synth, midi = bench.build_workload(large)
    jax_f32 = joff.render_midi_offline(synth, midi, SECONDS)
    t_synth, t_midi = bench_workload.build_workload(large)
    port_f32 = toff.render_midi_offline(t_synth, t_midi, SECONDS, device="cpu")
    return large, jax_f32, port_f32, (t_synth, t_midi)


def test_render_matches_jax(renders):
    _large, jax_f32, port_f32, _ = renders
    assert port_f32.shape == jax_f32.shape == (int(SECONDS * 44100), 2)
    assert port_f32.dtype == np.float32
    assert np.abs(jax_f32).max() > 1.0  # the chord sounds
    np.testing.assert_allclose(port_f32, jax_f32, rtol=0, atol=1e-4)


def test_int16_wire(renders):
    """The int16 conversion is the JAX package's bit for bit; against the
    JAX int16 render the bound is the float one in LSBs: 1e-4 * 32767 is
    3.3 LSB, plus one for the rounding step."""
    _large, jax_f32, port_f32, (synth, midi) = renders
    got = toff.render_midi_offline(synth, midi, SECONDS, wire="int16", device="cpu")
    assert got.dtype == np.int16 and got.shape == port_f32.shape
    np.testing.assert_array_equal(got, np.asarray(joff._to_wire(port_f32, "int16")))
    ref = np.asarray(joff._to_wire(jax_f32, "int16")).astype(np.int32)
    assert np.abs(got.astype(np.int32) - ref).max() <= 4


def test_streamed_matches_one_pass(renders):
    _large, _jax_f32, port_f32, (synth, midi) = renders
    got = toff.render_midi_offline_streamed(
        synth, midi, SECONDS, seg_blocks=5, device="cpu"
    )
    assert got.shape == port_f32.shape
    np.testing.assert_allclose(got, port_f32, rtol=0, atol=1e-5)


def test_sequencer_render_to_array(renders):
    _large, jax_f32, port_f32, (synth, midi) = renders
    seq = MidiFileSequencer(synth)
    silent = seq.render_to_array(SECONDS, device="cpu")
    assert silent.shape == port_f32.shape and not silent.any()
    seq.play(midi)
    got = seq.render_to_array(SECONDS, device="cpu")
    np.testing.assert_array_equal(got, port_f32)
    np.testing.assert_allclose(got, jax_f32, rtol=0, atol=1e-4)
    # the streaming render (the synthesizer's engine on its device) follows
    # the same score: its first two blocks against the one-pass render
    stream_synth, stream_midi = bench_workload.build_workload(_large, device="cpu")
    stream = MidiFileSequencer(stream_synth)
    stream.play(stream_midi)
    left, right = np.zeros(2048, np.float32), np.zeros(2048, np.float32)
    stream.render(left, right)
    np.testing.assert_allclose(np.stack([left, right], axis=1), port_f32[:2048], rtol=0,
                               atol=1e-4)
    seq.stop()
    assert not seq.render_to_array(0.01, device="cpu").any()
