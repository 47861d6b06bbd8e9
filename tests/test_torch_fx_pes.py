"""PyTorch port, the effects chain's PEs: each against its JAX PE, and
each render cut into blocks against one block.

The port renders with ``device="cpu"`` (the kernels' plain versions); the
JAX package renders on the CPU backend, where its PEs take their
``lax.scan``, block-parallel and closed-form paths (KarplusStrongPE's
``ks_blocked`` for a fully active block with a string of 16 samples or
more, ReversePitchEchoPE's block path at a static unity pitch and an exact
block length). Tolerances: each PE 1e-5 of the JAX render, the reverse
echo 2e-5 (the JAX kernel test's own); block invariance 1e-6, the
parallel-scan filters 1e-5 (a cut changes their scan's segments).
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu_torch import patch_workload
from pygmu2_tpu_torch.core import engine as tengine

torch.set_num_threads(1)

N = 2000  # one block: one JAX compile per case
CUT = 700  # the port's blocks for the invariance check (N % CUT != 0)


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _saw(pg, channels=1, seed=5):
    return pg.ArrayPE(patch_workload.detuned_saws(N, seed=seed, channels=channels))


def _pulsed(pg, channels=1):
    """A saw whose level jumps: loud bursts over a quiet bed."""
    return pg.MixPE(
        pg.GainPE(_saw(pg, channels), pg.PeriodicGate(40.0, duty_cycle=0.4)),
        pg.GainPE(_saw(pg, channels, seed=6), 0.05),
    )


def _sweep(pg, center, depth, hz=3.0):
    return pg.MixPE(pg.ConstantPE(center), pg.SinePE(hz, amplitude=depth))


def _filters(pe_name, modes, freq, q, **kw):
    return {
        f"{pe_name.lower()}_{mode}": (
            lambda pg, mode=mode: getattr(pg, pe_name)(
                _saw(pg, 2), freq(pg), q, mode=getattr(pg.BiquadMode, mode.upper()), **kw
            )
        )
        for mode in modes
    }


PES = {
    "ks_long_string": lambda pg: pg.KarplusStrongPE(220.0, rho=0.999, seed=1),
    "ks_short_string": lambda pg: pg.KarplusStrongPE(4000.0, rho=0.99, seed=2),
    "ks_two_phase_stereo": lambda pg: pg.KarplusStrongPE(
        110.0, rho=0.9995, duration=900, rho_damping=0.98, seed=3, channels=2
    ),
    "envelope_peak": lambda pg: pg.EnvelopePE(_pulsed(pg), attack=0.002, release=0.03),
    "envelope_rms_stereo": lambda pg: pg.EnvelopePE(
        _pulsed(pg, 2), attack=0.005, release=0.05, mode=pg.DetectionMode.RMS
    ),
    "envelope_symmetric": lambda pg: pg.EnvelopePE(_pulsed(pg), attack=0.01, release=0.01),
    "envelope_lookahead": lambda pg: pg.EnvelopePE(
        _pulsed(pg), attack=0.005, release=0.05, lookahead=0.002
    ),
    "slew_linear": lambda pg: pg.SlewLimiterPE(
        pg.GainPE(pg.PeriodicGate(30.0), 800.0), 40000.0, 8000.0
    ),
    "slew_exponential": lambda pg: pg.SlewLimiterPE(
        _sweep(pg, 0.0, 1.0, 25.0), 2000.0, 300.0, mode=pg.SlewMode.EXPONENTIAL
    ),
    "sample_hold": lambda pg: pg.SampleHoldPE(
        pg.SinePE(7.0), pg.PeriodicTrigger(hz=90.0), initial_value=0.3
    ),
    "track_hold": lambda pg: pg.TrackHoldPE(
        pg.SinePE(11.0), pg.PeriodicGate(60.0, duty_cycle=0.3), initial_value=-0.2
    ),
    "compressor_rms": lambda pg: pg.CompressorPE(_pulsed(pg), threshold=-18.0, ratio=6.0),
    "compressor_peak_unlinked": lambda pg: pg.CompressorPE(
        _pulsed(pg, 2), threshold=-24.0, ratio=3.0, knee=0.0, attack=0.002,
        detection=pg.DetectionMode.PEAK, stereo_link=False,
    ),
    "limiter": lambda pg: pg.LimiterPE(_pulsed(pg, 2), ceiling=-14.0),
    "expander": lambda pg: pg.ExpanderPE(_pulsed(pg), threshold=-20.0, knee=6.0),
    "dynamics_expand": lambda pg: pg.DynamicsPE(
        _pulsed(pg), pg.EnvelopePE(_pulsed(pg), 0.001, 0.02), threshold=-20.0,
        ratio=2.0, knee=4.0, mode=pg.DynamicsMode.EXPAND,
    ),
    "echo_fifth_up": lambda pg: pg.ReversePitchEchoPE(
        _saw(pg), 0.01, 1.5, 0.6, max_delay_seconds=0.05
    ),
    "echo_static_unity_stereo": lambda pg: pg.ReversePitchEchoPE(
        _saw(pg, 2), 0.01, 1.0, 0.7, alternate_direction=1.0, max_delay_seconds=0.05
    ),
    "echo_modulated": lambda pg: pg.ReversePitchEchoPE(
        _saw(pg), _sweep(pg, 0.012, 0.004, 7.0), _sweep(pg, 1.2, 0.3, 5.0),
        _sweep(pg, 0.5, 0.3, 4.0), max_delay_seconds=0.02,  # first block: the cap
    ),
    **_filters(
        "BiquadPE", ["lowpass", "highpass", "bandpass", "notch", "allpass", "peaking",
                     "lowshelf", "highshelf"],
        lambda pg: 1200.0, 1.5, gain_db=6.0,
    ),
    "biquadpe_bandpass_swept": lambda pg: pg.BiquadPE(
        _saw(pg), _sweep(pg, 900.0, 500.0, 4.0), 6.0, mode=pg.BiquadMode.BANDPASS
    ),
    **_filters(
        "SVFilterPE", ["lowpass", "highpass", "bandpass", "notch", "peaking", "lowshelf",
                       "highshelf"],
        lambda pg: _sweep(pg, 1500.0, 700.0, 5.0), 2.0, gain_db=-4.0,
    ),
}

ECHO_TOL = 2e-5
SCAN_FILTERS = ("biquadpe", "svfilterpe")
# RMS detection pads each block's edges (as the JAX package does), so a
# render cut into blocks differs from one block: it is held to the JAX
# render cut the same way instead
BLOCK_DEPENDENT = ("envelope_rms_stereo", "compressor_rms")


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _port(graph, block, start=0):
    return tengine.render_scan(graph, start, N, block, device="cpu").numpy()


@pytest.mark.parametrize("name", sorted(PES))
def test_pe_matches_jax_and_is_block_invariant(name):
    want = np.asarray(jengine.render_scan(PES[name](jpg), 0, N, N))
    got = _port(PES[name](tpg), N)
    assert got.shape == want.shape and np.abs(want).max() > 1e-3
    tol = ECHO_TOL if name.startswith("echo") else 1e-5
    _close(got, want, tol)
    cut = _port(PES[name](tpg), CUT)
    if name in BLOCK_DEPENDENT:
        want_cut = np.asarray(jengine.render_scan(PES[name](jpg), 0, N, CUT))
        assert np.abs(want_cut - want).max() > 1e-4
        _close(cut, want_cut, tol)
    else:
        _close(cut, got, 1e-5 if name.startswith(SCAN_FILTERS) else 1e-6)


def test_ks_render_starting_before_zero():
    """A block that starts before t = 0: the string stays silent and still
    until 0, then plucks (the JAX package's sequential path)."""
    start = -300
    want = np.asarray(jengine.render_scan(PES["ks_long_string"](jpg), start, N, N))
    got = _port(PES["ks_long_string"](tpg), N, start=start)
    assert not got[:300].any() and np.abs(got[300:]).max() > 0.1
    _close(got, want, 1e-5)


def test_rho_for_decay_db_matches_jax():
    for seconds, f in ((2.0, 82.41), (0.5, 440.0), (10.0, 30.0)):
        assert tpg.rho_for_decay_db(seconds, f, 44100) == jpg.rho_for_decay_db(seconds, f, 44100)


def test_svfilter_refuses_allpass():
    with pytest.raises(ValueError, match="ALLPASS"):
        tpg.SVFilterPE(_saw(tpg), 1000.0, 1.0, mode=tpg.BiquadMode.ALLPASS)


if __name__ == "__main__":
    # ``python tests/test_torch_fx_pes.py`` prints the observed maxima: the
    # checks record their errors instead of asserting (against the JAX
    # render first, then the block-invariance check)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jpg.set_sample_rate(44100)
    tpg.set_sample_rate(44100)
    errors = []

    def _close(got, want, atol):  # noqa: F811
        errors.append(float(np.abs(got - want).max()))

    for name in sorted(PES):
        errors.clear()
        test_pe_matches_jax_and_is_block_invariant(name)
        print(f"{name}: vs JAX {errors[0]:.3g}, cut into blocks {errors[1]:.3g}")
    errors.clear()
    test_ks_render_starting_before_zero()
    print(f"ks starting before 0: vs JAX {errors[0]:.3g}")
