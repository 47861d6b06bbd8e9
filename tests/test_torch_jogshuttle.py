"""PyTorch port: the jog/shuttle player's core (``pygmu2_tpu_torch.utils.
jogshuttle``) driven headless on the CPU, the counterparts of the 13 cases
of tests/test_jogshuttle.py.

The core drives the port's ``AudioRenderer`` (``device="cpu"``) over the
fake PortAudio of tests/test_torch_audio_renderer.py, whose stream here
also runs a pretend DAC: a thread that calls the stream's callback every
millisecond, as the JAX package's fake does, so the feeder keeps
rendering. The engine hook the scrubbing rides on, ``TimeWarpPE.seek``,
is checked on the port's Program directly.
"""

import threading
import time

import numpy as np
import pytest
import torch

import pygmu2_tpu_torch as pg
from pygmu2_tpu_torch.core import audio_renderer as ar_mod
from pygmu2_tpu_torch.core import engine
from pygmu2_tpu_torch.utils import jogshuttle as js
from pygmu2_tpu_torch.utils.wavio import write_wav
from test_torch_audio_renderer import FakeCallbackStop, FakeOutputStream, FakeSD

torch.set_num_threads(1)
SR = 44100


class PumpedStream(FakeOutputStream):
    """The fake stream with a pretend DAC: its callback fires every
    millisecond from start() until stop()."""

    def start(self):
        super().start()
        self._halt = threading.Event()
        if self.callback is None:
            return

        def run():
            while not self._halt.is_set():
                out = np.zeros((self.blocksize, self.channels), np.float32)
                try:
                    self.callback(out, self.blocksize, None, None)
                except FakeCallbackStop:
                    break
                time.sleep(0.001)
            if self.finished_callback:
                self.finished_callback()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        super().stop()
        if getattr(self, "_thread", None) is not None:
            self._halt.set()
            self._thread.join(timeout=2)


class PumpedSD(FakeSD):
    OutputStream = PumpedStream


@pytest.fixture
def wav_file(tmp_path):
    t = np.arange(SR) / SR  # 1 s of a 0.5 amplitude 220 Hz sine, mono
    data = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    path = tmp_path / "tone.wav"
    write_wav(str(path), data[:, None], SR)
    return str(path)


@pytest.fixture
def core(monkeypatch, wav_file):
    monkeypatch.setattr(ar_mod, "_sd", PumpedSD)
    c = js.JogShuttleCore(device="cpu")
    c.load_file(wav_file)
    yield c
    c.close()


# ---- the helpers ----


def test_rate_curve_roundtrip_and_endpoints():
    for rate in [-8.0, -1.0, -0.25, 0.0, 0.1, 1.0, 4.0, 8.0]:
        assert js.slider_to_rate(js.rate_to_slider(rate)) == pytest.approx(rate)
    assert js.slider_to_rate(js.SHUTTLE_MAX) == js.SHUTTLE_MAX
    assert js.slider_to_rate(-js.SHUTTLE_MAX) == -js.SHUTTLE_MAX
    # the power curve: half deflection is gentler than half the rate
    assert abs(js.slider_to_rate(js.SHUTTLE_MAX / 2)) < js.SHUTTLE_MAX / 2


def test_compute_peaks_bins_min_max(wav_file):
    peaks = js.compute_peaks(wav_file, target_width=100)
    assert peaks.shape == (100, 2)
    assert np.all(peaks[:, 0] <= peaks[:, 1])
    # full-scale bins of a 0.5 amplitude sine (441 samples a bin)
    assert np.allclose(peaks[:, 1], 0.5, atol=0.02)
    assert np.allclose(peaks[:, 0], -0.5, atol=0.02)


# ---- TimeWarpPE.seek, the engine hook ----


def _ramp_warp():
    pg.set_sample_rate(SR)
    return pg.TimeWarpPE(pg.CropPE(pg.IdentityPE(), 0, 10_000), rate=pg.ControlPE(1.0),
                         max_rate=8.0)


def test_timewarp_seek_jumps_tape_between_blocks():
    tw = _ramp_warp()  # the source's value is its index
    prog = engine.get_program(tw, 64, "cpu")
    b0 = prog.run(0).numpy()
    assert b0[0, 0] == pytest.approx(0.0) and b0[-1, 0] == pytest.approx(63.0)
    tw.seek(5000.0)
    assert tw.position == pytest.approx(5000.0)
    b1 = prog.run(64).numpy()  # a contiguous block: no gap reset
    assert b1[0, 0] == pytest.approx(5000.0, abs=1e-3)
    assert tw.position == pytest.approx(5064.0)


def test_seek_during_inflight_block_is_not_clobbered():
    """A seek that lands while a block renders survives the scatter of
    the block's states (the version guard of Program.run)."""
    tw = _ramp_warp()
    prog = engine.get_program(tw, 64, "cpu")
    prog.run(0)
    orig = prog._run

    def render_then_seek(start, states, bindings=None):  # the seek lands mid-render
        out = orig(start, states, bindings)
        tw.seek(5000.0)
        return out

    prog._run = render_then_seek
    prog.run(64)
    prog._run = orig
    assert tw.position == pytest.approx(5000.0), "the seek was overwritten"
    b = prog.run(128).numpy()
    assert b[0, 0] == pytest.approx(5000.0, abs=1e-3)


def test_timewarp_seek_before_first_render_sets_initial_position():
    tw = _ramp_warp()
    tw.seek(1234.0)
    out = engine.get_program(tw, 32, "cpu").run(0).numpy()
    assert out[0, 0] == pytest.approx(1234.0, abs=1e-3)


# ---- the transport through the port's AudioRenderer ----


def _wait_for(cond, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return False


def test_play_advances_and_pause_holds(core):
    assert core.total_frames == SR and not core.playing
    core.play()
    assert core.playing and core.rate == 1.0
    assert _wait_for(lambda: core.position > 2048), "the tape never advanced"
    core.pause()
    time.sleep(0.05)  # blocks in flight drain
    held = core.position
    time.sleep(0.15)
    # rate 0: the stream runs on, the tape holds
    assert core.position == pytest.approx(held, abs=1.0)
    assert not core.playing


def test_shuttle_curve_drives_rate_and_snap(core):
    val = core.shuttle_changed(4.0)
    assert val == 4.0 and core.rate == pytest.approx(js.slider_to_rate(4.0))
    val = core.shuttle_changed(0.2)  # inside the snap-to-zero band
    assert val == 0.0 and core.rate == 0.0
    core.shuttle_changed(-8.0)
    assert core.rate == pytest.approx(-8.0)


def test_spring_back_converges_to_rest(core):
    core.shuttle_rest = 1.0
    core.shuttle_value = js.SHUTTLE_MAX
    for _ in range(100):
        if core.spring_tick():
            break
    assert core.shuttle_value == pytest.approx(js.rate_to_slider(1.0))
    core.shuttle_released()
    assert core.rate == 1.0


def test_scrub_seeks_and_restores_stopped_state(core):
    assert not core.playing
    core.scrub_start(0.5)
    assert core.playing  # a scrub from a stop is heard
    assert core.position == pytest.approx(0.5 * SR, abs=4096)
    core.scrub_move(0.25)
    core.scrub_end()
    assert not core.playing  # stopped again after the scrub


def test_poll_auto_stops_at_end(core):
    core.play()
    core.seek(core.total_frames - 512)
    assert _wait_for(lambda: core.poll()["playing"] is False), "never stopped at the end"
    st = core.poll()
    assert st["pos"] <= core.total_frames and st["rate"] == 0.0


def test_stop_rewinds(core):
    core.play()
    _wait_for(lambda: core.position > 1024)
    core.stop()
    time.sleep(0.1)  # blocks in flight at rate 0 do not move the tape
    assert core.position == pytest.approx(0.0, abs=1.0)
    assert core.poll()["time"] == "00:00.000"


def test_reverse_rate_plays_backwards(core):
    core.seek(0.5 * SR)
    core.set_rate(-2.0)
    start = 0.5 * SR
    assert _wait_for(lambda: core.position < start - 2048), "the tape never moved back"
    core.pause()


def test_format_time():
    c = js.JogShuttleCore(device="cpu")
    c.sample_rate = SR
    assert c.format_time(0) == "00:00.000"
    assert c.format_time(SR * 61.5) == "01:01.500"
