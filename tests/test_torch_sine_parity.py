"""PyTorch port: SinePE against the JAX package on the CPU, bit for bit.

The JAX package's SinePE computes ``amp * jnp.sin(ph32)``; XLA's CPU
program calls glibc's ``sinf`` there, which the port mirrors
(``ops/xla_math.sincosf``; torch's float32 ``sin`` differs by an ulp in
~5 % of values). On the closed-form path XLA folds ``(2π f t) / sr`` into
``t`` times one constant, and a MixPE that adds SinePE's product
contracts it into a fused multiply-add (as a GainPE's); the port does
both. Cases: both paths (a constant frequency: the closed form; a PE
frequency: the carried phase), a constant and a PE phase, several blocks,
two channels, and the sums MixPE contracts. The head of
``examples/05_flanging.py`` (a SinePE modulating DelayPE's delay; 1.64e-3
off the JAX render when the port took torch's ``sin``) within 1e-4, the
repo's render bound: observed 0.
"""

import numpy as np
import pytest
import torch

import _torch_examples as ex
import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu_torch.ops import trig, xla_math

torch.set_num_threads(1)
N = 20000

GRAPHS = {
    "closed_form": lambda pg: pg.SinePE(440.0, 0.7),
    "closed_form_odd_freq_phase": lambda pg: pg.SinePE(2718.1705948, 0.5, phase=6.0910139),
    "closed_form_negative_phase": lambda pg: pg.SinePE(1498.6294814, 0.9, phase=-1.0823789),
    "closed_form_lfo": lambda pg: pg.SinePE(0.3, 40.0),
    "closed_form_two_channels": lambda pg: pg.SinePE(82.7365248, 0.4, channels=2),
    "carried_constant_pe": lambda pg: pg.SinePE(pg.ConstantPE(220.0), 0.5, phase=1.0),
    "carried_fm": lambda pg: pg.SinePE(pg.MixPE(pg.ConstantPE(300.0), pg.SinePE(5.0, 40.0)),
                                       0.8),
    "carried_pe_phase": lambda pg: pg.SinePE(pg.SinePE(3.0, 50.0), 0.5,
                                             phase=pg.SinePE(1.0, 2.0)),
    "carried_pe_amplitude": lambda pg: pg.SinePE(pg.ConstantPE(660.0),
                                                 pg.SinePE(0.5, 0.3)),
    "mix_constant_plus_sine": lambda pg: pg.MixPE(pg.ConstantPE(50.0), pg.SinePE(0.3, 40.0)),
    "mix_unit_amplitude_first": lambda pg: pg.MixPE(pg.SinePE(2.0, 1.0), pg.SinePE(5.0, 40.0)),
    "mix_negative_unit_amplitude": lambda pg: pg.MixPE(pg.SinePE(2.0, -1.0),
                                                       pg.SinePE(5.0, 40.0)),
    "mix_three_sines": lambda pg: pg.MixPE(pg.SinePE(2.0, 0.5), pg.SinePE(5.0, 40.0),
                                           pg.SinePE(9.0, 3.0)),
    "mix_two_channels": lambda pg: pg.MixPE(pg.SinePE(2.0, 1.0, channels=2),
                                            pg.SinePE(5.0, 40.0, channels=2)),
    "mix_gain_and_sine": lambda pg: pg.MixPE(pg.GainPE(pg.SinePE(2.0, 0.5), 0.3),
                                             pg.SinePE(5.0, 40.0)),
    "sine_shared_by_two_sums": lambda pg: (lambda s: pg.MixPE(
        pg.MixPE(pg.ConstantPE(300.0), s), s))(pg.SinePE(5.0, 40.0)),
}


@pytest.fixture(autouse=True)
def _rates():
    jpg.set_sample_rate(44100)
    tpg.set_sample_rate(44100)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("block", [4096, 1500])
def test_sine_graph_bit_for_bit(name, block):
    build = GRAPHS[name]
    want = np.asarray(jpg.render_to_array(jpg.CropPE(build(jpg), 0, N), block=block))
    got = tpg.render_to_array(tpg.CropPE(build(tpg), 0, N), block=block, device="cpu")
    assert np.abs(want).max() > 0.1
    assert got.shape == want.shape
    assert np.array_equal(got, want), (int((got != want).sum()),
                                       float(np.abs(got.astype(np.float64) - want).max()))


def test_sinf_mirror_equals_xla_sin():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.uniform(-7.0, 7.0, 200_000).astype(np.float32)
    want = np.asarray(jax.jit(jnp.sin)(x))
    assert np.array_equal(xla_math.sincosf(torch.from_numpy(x))[0].numpy(), want)


def test_sinpi_folded_equals_jax():
    """The band-limited oscillators' sin(π x) (ops/trig.py)."""
    import jax

    from pygmu2_tpu.ops import trig as jtrig

    rng = np.random.default_rng(1)
    x = rng.uniform(-300.0, 300.0, 100_000)
    want = np.asarray(jax.jit(jtrig.sinpi_folded)(x))
    assert np.array_equal(trig.sinpi_folded(torch.from_numpy(x)).numpy(), want)


def test_flanging_head_within_render_bound(tmp_path):
    err, peak = ex.compare("05_flanging", tmp_path)
    assert peak > 0.1
    assert err <= 1e-4, err
