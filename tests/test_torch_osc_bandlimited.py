"""PyTorch port: SuperSawPE and AnalogOscPE against the JAX package on
the CPU, across two block splits.

Tolerances: 1e-4, the JAX tests' bound for the band-limited oscillators.
Observed: AnalogOscPE bit for bit in both waveforms, pure (phase from the
absolute sample index) and stateful (phase a float64 prefix sum of the
increments, in XLA's order: ``ops/phase.prefix_sum``); SuperSawPE within
1.85e-6 (its float64 phase sum is XLA's order too, but the voices' BLITs take
torch's float32 ``sin`` and the mix is torch's GEMV).
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg

torch.set_num_threads(1)

N = 6000


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _render(pg, graph, block):
    if pg is tpg:
        return tpg.render_to_array(graph, block=block, device="cpu")
    return np.asarray(pg.render_to_array(graph, block=block))


def _check(build, atol, blocks=(1000, 512)):
    """Both packages at each block size (a pure sawtooth re-anchors its
    integral at every block's analytic value, so it depends on the split)."""
    worst = 0.0
    for block in blocks:
        want = _render(jpg, build(jpg), block)
        assert np.abs(want).max() > 0.1
        got = _render(tpg, build(tpg), block)
        assert got.shape == want.shape and np.isfinite(got).all()
        worst = max(worst, float(np.abs(got.astype(np.float64) - want).max()))
    assert worst <= atol, worst
    return worst


def _glide(pg, lo, hi):
    return pg.PiecewisePE([(0, lo), (N, hi)], extend_mode=pg.ExtendMode.HOLD_BOTH)


SUPERSAWS = {
    "constant": lambda pg: pg.SuperSawPE(220.0, 0.5, seed=3),
    "glide_linear_mix": lambda pg: pg.SuperSawPE(_glide(pg, 110.0, 880.0), 0.5, voices=5,
                                                 mix_mode="linear", seed=1),
    "equal_no_random_phase": lambda pg: pg.SuperSawPE(330.0, voices=4, mix_mode="equal",
                                                      randomize_phase=False, channels=2),
    "one_voice": lambda pg: pg.SuperSawPE(440.0, voices=1, seed=0),
    "amp_pe": lambda pg: pg.SuperSawPE(150.0, _glide(pg, 0.2, 1.0), detune_cents=35.0, seed=7),
}


@pytest.mark.parametrize("name", sorted(SUPERSAWS))
def test_supersaw_matches_jax(name):
    _check(lambda pg: pg.CropPE(SUPERSAWS[name](pg), 0, N), atol=1e-4)


@pytest.mark.parametrize("waveform", ["rectangle", "sawtooth"])
@pytest.mark.parametrize("start", [0, 3000])
@pytest.mark.parametrize("freq,duty", [(440.0, 0.3), (1234.5, 0.7), (30.0, 0.02)])
def test_analog_osc_pure_bit_for_bit(waveform, start, freq, duty):
    worst = _check(lambda pg: pg.CropPE(pg.AnalogOscPE(freq, duty, waveform), start, N),
                   atol=1e-4)
    assert worst == 0.0


@pytest.mark.parametrize("waveform", ["rectangle", "sawtooth"])
def test_analog_osc_stateful_bit_for_bit(waveform):
    worst = _check(lambda pg: pg.CropPE(pg.AnalogOscPE(_glide(pg, 100.0, 2000.0),
                                                       _glide(pg, 0.1, 0.9), waveform,
                                                       channels=2), 0, N), atol=1e-4)
    assert worst == 0.0


def test_analog_osc_rejects_unknown_waveform():
    with pytest.raises(ValueError, match="waveform"):
        tpg.AnalogOscPE(440.0, waveform="triangle")
    assert tpg.AnalogOscPE(440.0).is_pure() and not tpg.AnalogOscPE(_glide(tpg, 1, 2)).is_pure()
    assert repr(tpg.SuperSawPE(220.0)) == repr(jpg.SuperSawPE(220.0))
