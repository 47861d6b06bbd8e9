"""PyTorch port, the unfused SoundFont audio pass: the plain version of
``filter_gain_mix`` against the JAX package's Pallas kernel in interpret
mode, the pitch-ratio bound that routes a render to it, and the
high-register score through the large font against the JAX render, which
takes ``filter_gain_mix_pallas`` under ``FORCE_PALLAS_INTERPRET``.

Inputs come from numpy with a seed or from the in-repo score and font;
JAX stays on the CPU. Tolerances: the kernel 2e-5 * max(scale, 1)
(tests/test_filter_pallas.py); the render 1e-4 against JAX
(tests/test_bench_parity.py) and against the port's fused route; streamed
against one pass 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pygmu2_tpu.soundfont import MidiFile as JMidiFile
from pygmu2_tpu.soundfont import filter_pallas
from pygmu2_tpu.soundfont import offline as joff
from pygmu2_tpu.soundfont.filter_pallas import filter_gain_mix_pallas
from pygmu2_tpu_torch import bench_workload
from pygmu2_tpu_torch.soundfont import MidiFile
from pygmu2_tpu_torch.soundfont import filter_kernels as fk
from pygmu2_tpu_torch.soundfont import offline as toff
from pygmu2_tpu_torch.soundfont.convert import schedule_to_torch, to_torch

torch.set_num_threads(1)

SECONDS = 0.5


def _random_rows(B, P, seed):
    """Stable resonant filters, epochs starting mid-render, gain ramps."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.1, 0.95, (B, P))
    th = rng.uniform(0, np.pi, (B, P))
    rows = {
        "b0": rng.uniform(0.0, 0.3, (B, P)),
        "b1": rng.uniform(0.0, 0.5, (B, P)),
        "b2": rng.uniform(0.0, 0.3, (B, P)),
        "a1": -2.0 * r * np.cos(th),
        "a2": r**2,
        "freshf": (rng.uniform(0, 1, (B, P)) > 0.6).astype(np.float64),
        "pgl": rng.uniform(0, 0.5, (B, P)),
        "gl": rng.uniform(0, 0.5, (B, P)),
        "pgr": rng.uniform(0, 0.5, (B, P)),
        "gr": rng.uniform(0, 0.5, (B, P)),
    }
    rows["freshf"][0] = 1.0  # the first block is always fresh
    rows["gl"][-1] = rows["pgl"][-1]  # constant gains
    rows["gr"][:, :8] = rows["pgr"][:, :8] = 0.0  # inaudible voices
    return {k: v.astype(np.float32) for k, v in rows.items()}


@pytest.mark.parametrize("B,N,P", [(3, 256, 128), (5, 128, 128), (2, 1024, 128)])
def test_ref_matches_pallas(B, N, P):
    rng = np.random.default_rng(B * N)
    xt = rng.standard_normal((B * N, P)).astype(np.float32)
    rows = _random_rows(B, P, seed=N)
    want = np.asarray(filter_gain_mix_pallas(
        jnp.asarray(xt), {k: jnp.asarray(v) for k, v in rows.items()}, N, chunk=128,
        interpret=True))
    got = fk.filter_gain_mix_ref(torch.from_numpy(xt),
                                 {k: torch.from_numpy(v) for k, v in rows.items()}, N)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * max(scale, 1.0))


def test_wrapper_takes_plain_version_on_cpu():
    rows = {k: torch.from_numpy(v) for k, v in _random_rows(2, 128, seed=1).items()}
    xt = torch.from_numpy(np.random.default_rng(1).standard_normal((256, 128))
                          .astype(np.float32))
    before = fk.filter_gain_mix.launches
    assert torch.equal(fk.filter_gain_mix(xt, rows, 128), fk.filter_gain_mix_ref(xt, rows, 128))
    assert fk.filter_gain_mix.launches == before
    with pytest.raises(ValueError):
        fk.filter_gain_mix(xt[:200], rows, 128)  # T not a multiple of N
    with pytest.raises(ValueError):
        fk.filter_gain_mix(xt.to("meta"), {k: v.to("meta") for k, v in rows.items()}, 128)


@pytest.mark.parametrize("score", ["high", "bench"])
def test_ratio_bound_matches_jax(score):
    jsynth, jmidi = bench.build_workload(True)
    tsynth, tmidi = bench_workload.build_workload(True)
    if score == "high":
        data = bench_workload.build_high_midi_bytes(3.0)
        jmidi, tmidi = JMidiFile(data), MidiFile(data)
    par, ch, _snap, _nb = jsynth.build_schedule(jmidi, 3.0)
    want = joff._ratio_bound(jsynth, par, ch)
    par, ch, _snap, _nb = tsynth.build_schedule(tmidi, 3.0)
    got = toff._ratio_bound(par, ch)
    assert got == want
    assert (got > toff.WINDOW_RATIO_BUCKET) == (score == "high")
    assert toff.WINDOW_RATIO_BUCKET == joff.WINDOW_RATIO_BUCKET
    assert toff.OSC_KERNEL_MAX_WAVE == filter_pallas.OSC_KERNEL_MAX_WAVE


@pytest.fixture(scope="module")
def high_renders():
    """The high score through the large font, 0.5 s: (JAX render under
    FORCE_PALLAS_INTERPRET, the number of times the JAX program called
    filter_gain_mix_pallas while it was traced, the port's render)."""
    data = bench_workload.build_high_midi_bytes(SECONDS)
    jsynth, _ = bench.build_workload(True)
    calls = []
    orig = filter_pallas.filter_gain_mix_pallas

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    joff.FORCE_PALLAS_INTERPRET = True
    filter_pallas.filter_gain_mix_pallas = spy
    try:
        want = np.asarray(joff.render_midi_offline(jsynth, JMidiFile(data), SECONDS))
    finally:
        filter_pallas.filter_gain_mix_pallas = orig
        joff.FORCE_PALLAS_INTERPRET = False
    tsynth, _ = bench_workload.build_workload(True)
    got = toff.render_midi_offline(tsynth, MidiFile(data), SECONDS, device="cpu")
    return want, len(calls), got


def test_high_score_matches_jax(high_renders):
    want, jax_calls, got = high_renders
    assert jax_calls == 1  # the JAX render took the unfused kernel
    assert got.shape == want.shape == (int(SECONDS * 44100), 2)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_high_score_takes_unfused_route(monkeypatch):
    """The port's render launches the unfused pass, not the fused one."""
    taken = []
    monkeypatch.setattr(fk, "filter_gain_mix", lambda *a: taken.append("unfused")
                        or fk.filter_gain_mix_ref(*a))
    monkeypatch.setattr(fk, "osc_filter_gain_mix", lambda *a: taken.append("fused")
                        or fk.osc_filter_gain_mix_ref(*a))
    synth, _ = bench_workload.build_workload(True)
    toff.render_midi_offline(synth, MidiFile(bench_workload.build_high_midi_bytes(SECONDS)),
                             SECONDS, device="cpu")
    synth, midi = bench_workload.build_workload(True)
    toff.render_midi_offline(synth, midi, 0.1, device="cpu")
    assert taken == ["unfused", "fused"]


def test_unfused_route_matches_fused():
    """Both audio passes of the port on the high score's control rows."""
    synth, _ = bench_workload.build_workload(True)
    midi = MidiFile(bench_workload.build_high_midi_bytes(SECONDS))
    par, ch, snap, _nb = synth.build_schedule(midi, SECONDS)
    planes, flags = schedule_to_torch(par, ch, snap, "cpu")
    ctrl = toff._control_device(*planes, synth.block_size, flags,
                                int(synth._minimum_voice_duration), float(synth.sample_rate))
    wave = to_torch(synth._wave, "cpu")
    unfused, state = toff._audio_pass(ctrl, wave, synth.block_size, synth.master_volume,
                                      unfused=True)
    fused, _ = toff._audio_pass(ctrl, wave, synth.block_size, synth.master_volume)
    assert state is None and unfused.abs().max() > 0.05
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), rtol=0, atol=1e-4)


def test_high_score_streamed_matches_one_pass(high_renders):
    _want, _calls, got = high_renders
    synth, _ = bench_workload.build_workload(True)
    streamed = toff.render_midi_offline_streamed(
        synth, MidiFile(bench_workload.build_high_midi_bytes(SECONDS)), SECONDS,
        seg_blocks=5, device="cpu")
    np.testing.assert_allclose(streamed, got, rtol=0, atol=1e-5)
