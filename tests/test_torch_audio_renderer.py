"""PyTorch port: AudioRenderer, ``play`` and ``play_offline`` driven
through a fake PortAudio backend on the CPU.

Audio equality only: what reaches the output stream must be the frames
``render_to_array`` renders, within 1e-5 (the renderer renders in its own
block sizes, and the graph's SuperSawPE scans its leaky integrators in a
tree that depends on the block: observed within 4.2e-7). Nothing here is paced by the wall clock: the
fake stream's callback runs only when the test calls it, after the feeder
thread has queued the whole render.
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu_torch as tpg
from pygmu2_tpu_torch.core import audio_renderer as ar_mod

torch.set_num_threads(1)


class FakeCallbackStop(Exception):
    pass


class FakeOutputStream:
    instances: list = []

    def __init__(self, samplerate, channels, blocksize, device=None, latency=None,
                 dtype="float32", callback=None, finished_callback=None):
        self.samplerate = samplerate
        self.channels = channels
        self.blocksize = blocksize
        self.device = device
        self.callback = callback
        self.finished_callback = finished_callback
        self.writes = []
        self.started = self.stopped = self.closed = False
        FakeOutputStream.instances.append(self)

    def start(self):
        self.started = True

    def drain(self):
        """Call the callback until it stops the stream (the test's DAC)."""
        while True:
            out = np.full((self.blocksize, self.channels), np.nan, np.float32)
            try:
                self.callback(out, self.blocksize, None, None)
            except FakeCallbackStop:
                break
            self.writes.append(out.copy())
        if self.finished_callback:
            self.finished_callback()

    def write(self, data):
        self.writes.append(np.asarray(data).copy())

    def stop(self):
        self.stopped = True

    def close(self):
        self.closed = True


class FakeSD:
    OutputStream = FakeOutputStream
    CallbackStop = FakeCallbackStop

    @staticmethod
    def query_devices():
        return [{"name": "fake in", "max_output_channels": 0},
                {"name": "fake out", "max_output_channels": 2}]


@pytest.fixture
def fake_sd(monkeypatch):
    tpg.set_sample_rate(44100)
    FakeOutputStream.instances = []
    monkeypatch.setattr(ar_mod, "_sd", FakeSD)
    return FakeSD


def _same(got, want):
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _graph(seconds=0.1):
    n = int(seconds * 44100)
    lead = tpg.SuperSawPE(tpg.PiecewisePE([(0, 110.0), (n, 440.0)],
                                          extend_mode=tpg.ExtendMode.HOLD_BOTH), 0.4, seed=1)
    pan = tpg.RandomPE(8.0, -45.0, 45.0, tpg.RandomMode.WALK, seed=2)
    return tpg.CropPE(tpg.SpatialPE(lead, method=tpg.SpatialConstantPower(pan)), 0, n)


def test_blocking_play_range(fake_sd):
    want = tpg.render_to_array(_graph(), device="cpu")
    r = tpg.AudioRenderer(blocksize=256, device="cpu", output_device=1)
    assert r.device == "cpu" and r.output_device == 1
    r.set_source(_graph())
    r.start()
    r.play_range(0, want.shape[0], chunk_size=1000)
    r.stop()
    (stream,) = FakeOutputStream.instances
    assert stream.device == 1 and stream.channels == 2 and stream.closed
    _same(np.concatenate(stream.writes), want)


def test_callback_streaming_matches_render_to_array(fake_sd):
    want = tpg.render_to_array(_graph(), device="cpu")
    r = tpg.AudioRenderer(blocksize=512, device="cpu")
    r.set_source(_graph())
    r.start()
    r.stream_start(batch_blocks=2, queue_seconds=1.0)
    r._feeder.join(timeout=120)  # the whole render queued
    assert not r._feeder.is_alive()
    (stream,) = FakeOutputStream.instances
    assert stream.started
    stream.drain()
    assert r.stream_wait(timeout=5) and r.stream_underruns == 0
    got = np.concatenate(stream.writes)
    n = want.shape[0]
    _same(got[:n], want)
    assert not got[n:].any()  # the last block's padding is silence
    assert r.stream_position == got.shape[0]
    r.stream_stop()
    r.stop()


def test_adaptive_batches_render_the_same_frames(fake_sd):
    want = tpg.render_to_array(_graph(0.2), device="cpu")
    r = tpg.AudioRenderer(blocksize=256, device="cpu")
    r.set_source(_graph(0.2))
    r.start()
    r.stream_start(queue_seconds=1.0)  # adaptive batch size
    r._feeder.join(timeout=120)
    (stream,) = FakeOutputStream.instances
    stream.drain()
    _same(np.concatenate(stream.writes)[:want.shape[0]], want)
    assert r.stream_batch >= 1
    r.stop()


def test_play_and_play_offline(fake_sd, tmp_path):
    want = tpg.render_to_array(_graph(), device="cpu")
    tpg.play(_graph(), device="cpu")
    (stream,) = FakeOutputStream.instances
    _same(np.concatenate(stream.writes), want)
    path = tmp_path / "out.wav"
    tpg.play_offline(_graph(), path=str(path), device="cpu")
    from pygmu2_tpu_torch.utils.wavio import read_wav

    data, sr = read_wav(path)
    assert sr == 44100
    _same(data, want)
    _same(np.concatenate(FakeOutputStream.instances[1].writes), want)
    tpg.play_offline(_graph(), omit_playback=True, device="cpu")
    assert len(FakeOutputStream.instances) == 2


def test_errors_and_device_queries(fake_sd, monkeypatch):
    r = tpg.AudioRenderer(device="cpu")
    r.set_source(tpg.SinePE(frequency=440.0))
    r.start()
    with pytest.raises(Exception):
        r.play_extent()  # infinite extent
    r.stop()
    assert tpg.AudioRenderer.get_default_device()["name"] == "fake out"
    assert len(tpg.AudioRenderer.list_devices()) == 2
    monkeypatch.setattr(ar_mod, "_sd", None)
    with pytest.raises(RuntimeError, match="sounddevice"):
        tpg.AudioRenderer.list_devices()
