"""PyTorch port, audio pass: ``osc_filter_gain_mix_ref`` against the JAX
package's Pallas kernels (interpret mode), and the linear-recurrence scan.

The rows come from the JAX package's host control pass over the bench
score at P=128 voices and block N=128, so both sides see identical
inputs. Small font: the JAX rows of ``offline._osc_rows`` into
``osc_filter_gain_mix_pallas``. Large font: the windowed-DMA kernel
``osc_window_filter_gain_mix_pallas`` takes ``window_osc_rows`` (loop-view
coordinates in the extended wavetable) while the port reads the original
wave with its own ``_osc_rows``. Tolerance 3e-5 x scale, as the JAX
package holds its own fused kernel to its XLA path
(tests/test_filter_pallas.py).

``osc_filter_gain_mix_cut`` (the CUDA kernel's order in torch ops) is held
to the plain version and the JAX kernel at the same tolerance, on the bench
rows and on seeded rows (``tests/test_torch_osc_rows.py``), with hand-offs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from test_torch_osc_rows import synthetic_rows
from pygmu2_tpu.ops.linrec import affine_scan_2 as jax_affine_scan_2
from pygmu2_tpu.soundfont import MidiFile, SoundFont, Synthesizer, SynthesizerSettings
from pygmu2_tpu.soundfont import offline as joff
from pygmu2_tpu.soundfont.filter_pallas import (
    osc_filter_gain_mix_pallas,
    osc_window_filter_gain_mix_pallas,
)
from pygmu2_tpu_torch.ops.linrec import affine_scan_2
from pygmu2_tpu_torch.soundfont import filter_kernels as fk
from pygmu2_tpu_torch.soundfont import offline as toff
from pygmu2_tpu_torch.soundfont.convert import to_torch

torch.set_num_threads(1)

N = 128
SECONDS = 0.1  # 35 blocks


def _case(large: bool):
    """(JAX control dict, JAX synth) for the bench score at block N."""
    synth = Synthesizer(
        SoundFont(bench.build_font_bytes(large=large)),
        SynthesizerSettings(sample_rate=44100, block_size=N, maximum_polyphony=128),
    )
    par, ch, snap, _nb = synth.build_schedule(
        MidiFile(bench.build_midi_bytes()), SECONDS
    )
    ctrl = joff.compute_control(synth, par, ch, snap)
    return ctrl, synth, (par, ch)


def _port_rows(ctrl_np, wave_t, master):
    ctrl_t = to_torch(ctrl_np, "cpu")
    return dict(toff._gain_rows(ctrl_t, master), **toff._osc_rows(ctrl_t, wave_t))


@pytest.fixture(scope="module")
def small():
    ctrl, synth, _ = _case(False)
    wave = np.asarray(synth._wave)
    master = float(synth.master_volume)
    ctrl_j = {k: jnp.asarray(v) for k, v in ctrl.items()}
    rows_j = dict(joff._gain_rows(ctrl_j, master), **joff._osc_rows(ctrl_j, jnp.asarray(wave)))
    return ctrl, wave, master, rows_j


def test_ref_matches_pallas_small_font(small):
    ctrl, wave, master, rows_j = small
    ref, st_ref = osc_filter_gain_mix_pallas(
        rows_j, jnp.asarray(wave), N, wave.shape[0], interpret=True
    )
    wave_t = torch.tensor(wave)
    got, st = fk.osc_filter_gain_mix_ref(_port_rows(ctrl, wave_t, master), wave_t, N)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.abs(ref).max() > 1.0  # the chord sounds
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5 * scale)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=0, atol=3e-5 * scale)


def test_ref_matches_window_pallas_large_font():
    ctrl, synth, (par, ch) = _case(True)
    master = float(synth.master_volume)
    bound = joff._ratio_bound(synth, par, ch)
    bucket = 2
    while bucket < bound:
        bucket *= 2
    win_w = joff.window_w(N, bucket)
    wave_ext = synth.wave_ext()
    ctrl_j = {k: jnp.asarray(v) for k, v in ctrl.items()}
    rows_j = dict(
        joff._gain_rows(ctrl_j, master),
        **joff.window_osc_rows(ctrl_j, win_w, int(wave_ext.shape[0])),
    )
    ref, st_ref = osc_window_filter_gain_mix_pallas(
        rows_j, wave_ext, N, win_w, interpret=True
    )
    wave_t = torch.tensor(np.asarray(synth._wave))
    got, st = fk.osc_filter_gain_mix_ref(_port_rows(ctrl, wave_t, master), wave_t, N)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5 * scale)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=0, atol=3e-5 * scale)


def test_state_handoff(small):
    """Two segments with the (4, P) state threaded equal one call; and a
    JAX kernel's state, converted, continues the port's second segment
    as the JAX kernel's own second segment does."""
    ctrl, wave, master, rows_j = small
    wave_t = torch.tensor(wave)
    rows = _port_rows(ctrl, wave_t, master)
    B = rows["ratio"].shape[0]
    cut = B // 2
    one, st_one = fk.osc_filter_gain_mix(rows, wave_t, N)
    o1, st1 = fk.osc_filter_gain_mix({k: v[:cut] for k, v in rows.items()}, wave_t, N)
    o2, st2 = fk.osc_filter_gain_mix(
        {k: v[cut:] for k, v in rows.items()}, wave_t, N, st1
    )
    # the plain scan groups its sums differently on either side of the
    # cut: the streamed-vs-one-pass bound of the offline render, 1e-5
    torch.testing.assert_close(torch.cat([o1, o2]), one, rtol=0, atol=1e-5)
    torch.testing.assert_close(st2, st_one, rtol=0, atol=1e-5)

    seg1 = {k: v[:cut] for k, v in rows_j.items()}
    seg2 = {k: v[cut:] for k, v in rows_j.items()}
    w_j = jnp.asarray(wave)
    _, jst1 = osc_filter_gain_mix_pallas(seg1, w_j, N, wave.shape[0], interpret=True)
    j2, _ = osc_filter_gain_mix_pallas(
        seg2, w_j, N, wave.shape[0], interpret=True, state=jst1
    )
    p2, _ = fk.osc_filter_gain_mix_ref(
        {k: v[cut:] for k, v in rows.items()}, wave_t, N,
        to_torch(np.asarray(jst1), "cpu"),
    )
    scale = max(float(np.abs(np.asarray(j2)).max()), 1.0)
    np.testing.assert_allclose(p2.numpy(), np.asarray(j2), rtol=0, atol=3e-5 * scale)


@pytest.mark.parametrize("with_s0", [False, True])
def test_affine_scan_2_matches_jax(with_s0):
    rng = np.random.default_rng(7)
    T, C = 300, 5
    r = rng.uniform(0.1, 0.95, (T, C))
    th = rng.uniform(0, np.pi, (T, C))
    planes = [
        2.0 * r * np.cos(th),
        -(r**2),
        np.ones((T, C)),
        np.zeros((T, C)),
        rng.standard_normal((T, C)),
        np.zeros((T, C)),
    ]
    planes = [p.astype(np.float32) for p in planes]
    s0 = rng.standard_normal((2, C)).astype(np.float32) if with_s0 else None
    ref = jax_affine_scan_2(
        *map(jnp.asarray, planes), s0=None if s0 is None else tuple(map(jnp.asarray, s0))
    )
    got = affine_scan_2(
        *map(torch.from_numpy, planes),
        s0=None if s0 is None else tuple(map(torch.from_numpy, s0)),
    )
    for g, j in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


# ---- the fused kernel's order in torch ops (osc_filter_gain_mix_cut) ----


def test_cut_matches_ref_and_pallas_small_font(small):
    """The bench score's rows (35 blocks of 128 samples: two groups of
    entering states, four blocks of 32 voices)."""
    ctrl, wave, master, rows_j = small
    ref, st_ref = osc_filter_gain_mix_pallas(rows_j, jnp.asarray(wave), N, wave.shape[0],
                                             interpret=True)
    wave_t = torch.tensor(wave)
    rows = _port_rows(ctrl, wave_t, master)
    got, st = fk.osc_filter_gain_mix_cut(rows, wave_t, N)
    plain, st_plain = fk.osc_filter_gain_mix_ref(rows, wave_t, N)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-5 * scale)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=0, atol=3e-5 * scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=3e-5 * scale)
    np.testing.assert_allclose(st.numpy(), st_plain.numpy(), rtol=0, atol=3e-5 * scale)


# (B, P, N, fresh blocks, held to the JAX kernel too: it takes P = 128
# only): N = 600 and 130 are not multiples of the kernel's 32-sample tile;
# 600 and 640 take two segments of a block, the last a part one; 40 blocks
# take two groups of entering states; P = 33 and 256 leave a part block of
# voices and take eight
CUT_CASES = {
    "B=1 P=33 N=600 fresh at block 0": (1, 33, 600, (0,), False),
    "B=5 P=33 N=640 fresh at block 2": (5, 33, 640, (2,), False),
    "B=4 P=128 N=640 fresh at blocks 0 and 2": (4, 128, 640, (0, 2), True),
    "B=40 P=1 N=130": (40, 1, 130, (), False),
    "B=3 P=256 N=256 fresh at block 2": (3, 256, 256, (2,), False),
}


@pytest.mark.parametrize("case", list(CUT_CASES))
def test_cut_matches_ref_and_hands_off(case):
    B, P, n, fresh, with_pallas = CUT_CASES[case]
    rows_np, wave, state = synthetic_rows(B, P, 4096, seed=B * P + n, fresh_blocks=fresh)
    rows = {k: torch.from_numpy(v) for k, v in rows_np.items()}
    wave_t, state_t = torch.from_numpy(wave), torch.from_numpy(state)
    got, st = fk.osc_filter_gain_mix_cut(rows, wave_t, n, state_t)
    ref, st_ref = fk.osc_filter_gain_mix_ref(rows, wave_t, n, state_t)
    scale = max(float(ref.abs().max()), 1.0)
    assert float(ref.abs().max()) > 0.1
    torch.testing.assert_close(got, ref, rtol=0, atol=3e-5 * scale)
    torch.testing.assert_close(st, st_ref, rtol=0, atol=3e-5 * scale)
    if with_pallas:
        rows_j = {k: jnp.asarray(v) for k, v in rows_np.items()}
        pal, st_pal = osc_filter_gain_mix_pallas(rows_j, jnp.asarray(wave), n, wave.shape[0],
                                                 interpret=True, state=jnp.asarray(state))
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=0, atol=3e-5 * scale)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_pal), rtol=0, atol=3e-5 * scale)
    if B > 1:  # two calls with the state handed on equal one call
        cut = B // 2
        o1, s1 = fk.osc_filter_gain_mix_cut({k: v[:cut] for k, v in rows.items()}, wave_t, n,
                                            state_t)
        o2, s2 = fk.osc_filter_gain_mix_cut({k: v[cut:] for k, v in rows.items()}, wave_t, n,
                                            s1)
        torch.testing.assert_close(torch.cat([o1, o2]), got, rtol=0, atol=1e-5)
        torch.testing.assert_close(s2, st, rtol=0, atol=1e-5)
