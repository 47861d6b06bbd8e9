"""PyTorch port: ``browse``, the live MIDI demo and the public names,
against the JAX package on the CPU.

- ``browse`` renders to a WAV file and spawns the port's jog/shuttle
  player, ``python -m pygmu2_tpu_torch.utils.jogshuttle FILE`` (with
  ``--delete-on-close`` for a temp file); ``subprocess.Popen`` is patched,
  so no player starts. Its WAV is held to the JAX ``browse``'s WAV of the
  same graph within 1e-4, the repo's render bound.
- The MIDI demo's scripted arpeggio (``utils/meltysynth_midi_demo``),
  written by its ``main``, against the same arpeggio through the JAX
  package's API: 2e-5, the streaming synth's tolerance
  (tests/test_torch_meltysynth_pe.py).
- Every name of the JAX package's ``__all__`` is in the port's.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.utils.wavio import read_wav
from pygmu2_tpu_torch.utils import meltysynth_midi_demo as demo

torch.set_num_threads(1)


@pytest.fixture
def spawned(monkeypatch):
    """The commands ``subprocess.Popen`` was asked to start."""
    cmds = []
    monkeypatch.setattr(subprocess, "Popen", lambda cmd, *a, **k: cmds.append(list(cmd)))
    return cmds


def _graph(pg):
    pg.set_sample_rate(44100)
    lfo = pg.SinePE(frequency=3.0, amplitude=40.0)
    tone = pg.BiquadPE(pg.SinePE(frequency=pg.MixPE(pg.ConstantPE(330.0), lfo), amplitude=0.6),
                       1200.0, 0.9)
    return pg.CropPE(pg.GainPE(tone, 0.8), 0, 6000)


def test_browse_spawns_the_ports_player_with_the_render(tmp_path, spawned):
    port_wav, jax_wav = tmp_path / "port.wav", tmp_path / "jax.wav"
    tpg.browse(_graph(tpg), path=str(port_wav), device="cpu")
    assert spawned == [[sys.executable, "-m", "pygmu2_tpu_torch.utils.jogshuttle",
                        str(port_wav.resolve())]]
    jpg.browse(_graph(jpg), path=str(jax_wav))
    assert len(spawned) == 2 and "jogshuttle.py" in spawned[1][1]
    got, sr = read_wav(str(port_wav))
    want, jsr = read_wav(str(jax_wav))
    assert sr == jsr == 44100 and got.shape == want.shape == (6000, 1)
    assert np.abs(want).max() > 0.1
    assert float(np.abs(got.astype(np.float64) - want).max()) <= 1e-4


def test_browse_temp_file_is_deleted_by_the_player(spawned):
    tpg.browse(_graph(tpg), device="cpu")
    (cmd,) = spawned
    assert cmd[:3] == [sys.executable, "-m", "pygmu2_tpu_torch.utils.jogshuttle"]
    assert cmd[-1] == "--delete-on-close"
    data, sr = read_wav(cmd[3])
    assert data.shape == (6000, 1) and sr == 44100
    import os

    os.remove(cmd[3])  # what the player does when it closes


def test_browse_refuses_an_infinite_source(spawned):
    tpg.set_sample_rate(44100)
    with pytest.raises(RuntimeError, match="infinite"):
        tpg.browse(tpg.SinePE(frequency=440.0), device="cpu")
    assert spawned == []


def _jax_arpeggio(sf_path):
    """The demo's scripted branch through the JAX package's API."""
    jpg.set_sample_rate(44100)
    synth_pe = jpg.MeltysynthPE(sf_path, block_size=256)
    renderer = jpg.NullRenderer()
    renderer.set_source(synth_pe)
    renderer.start()
    synth = synth_pe.synthesizer
    chunks = []
    for i, key in enumerate(demo.ARPEGGIO):
        synth.note_on(0, key, 100)
        chunks.append(np.asarray(synth_pe.render(i * demo.NOTE_SAMPLES,
                                                 demo.NOTE_SAMPLES).data))
        synth.note_off(0, key)
    renderer.stop()
    return np.concatenate(chunks)


def test_midi_demo_wav_equals_the_jax_arpeggio(tmp_path):
    out = tmp_path / "demo.wav"
    assert demo.main(["--out", str(out), "--device", "cpu"]) == 0
    got, sr = read_wav(str(out))
    font = tmp_path / "demo.sf2"
    font.write_bytes(demo.demo_font_bytes())
    want = _jax_arpeggio(str(font))
    assert sr == 44100 and got.shape == want.shape == (7 * demo.NOTE_SAMPLES, 2)
    assert np.abs(want).max() > 0.05
    assert float(np.abs(got.astype(np.float64) - want).max()) <= 2e-5


def test_port_exports_every_public_name_of_the_jax_package():
    missing = sorted(set(jpg.__all__) - set(tpg.__all__))
    assert not missing, missing
    assert tpg.browse is tpg.utils.browse
