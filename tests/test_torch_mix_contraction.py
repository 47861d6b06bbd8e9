"""PyTorch port, MixPE against the JAX render bit for bit: where XLA's CPU
program contracts an input GainPE's product into the MixPE's sum.

The JAX package renders a block as one XLA program. Its CPU backend fuses
a float32 product whose one use is a sum into one fused multiply-add:
``MixPE(a, GainPE(b, g))`` is ``fma(b, g, a)``, rounded once. Read from
the optimised HLO and the object code of these graphs
(``XLA_FLAGS=--xla_dump_to=DIR --xla_dump_hlo_as_text``; a ``vfmadd``
where the block's loop fusion adds the product):

- a GainPE input with a scalar or a control-PE gain, first, middle or
  last, fuses into the first sum it enters, left to right;
- where both operands of a sum are such products, the left one fuses and
  the right one is rounded (``fma(a, ga, b * gb)``);
- a GainPE that feeds two consumers is rounded: no contraction;
- at the edge of the GainPE's extent, the samples outside it add zero.

The port's MixPE mirrors exactly that (``models/basic.MixPE._trace``,
``core/engine.TraceContext.pull_factors``). Each graph renders through
both packages in blocks of 1024 on the CPU and must agree bit for bit.
"""

import numpy as np
import pytest

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu_torch.core import engine as tengine

N = 4096
BLOCK = 1024


def _data():
    rng = np.random.default_rng(9)
    return {k: rng.uniform(-1, 1, (N, ch)).astype(np.float32)
            for k, ch in (("a", 1), ("b", 1), ("c", 1), ("k", 1), ("s", 2), ("t", 2))}


def _graphs(pg):
    d = _data()
    a, b, c, k, s, t = (pg.ArrayPE(d[x].copy()) for x in "abckst")
    shared = pg.GainPE(b, 2500.0)
    short = pg.ArrayPE(d["b"][:3000].copy())  # ends inside the third block
    # an ArrayPE that holds its last value past its end: never masked
    held = pg.ArrayPE(d["c"].copy(), extend_mode=pg.ExtendMode.HOLD_LAST)
    return {
        "gain last": pg.MixPE(a, pg.GainPE(b, 2500.0)),
        "gain first": pg.MixPE(pg.GainPE(b, 2500.0), a),
        "three, gain first": pg.MixPE(pg.GainPE(b, 0.7), a, c),
        "three, gain middle": pg.MixPE(a, pg.GainPE(b, 0.7), c),
        "three, gain last": pg.MixPE(a, c, pg.GainPE(b, 0.7)),
        "control gain": pg.MixPE(a, pg.GainPE(b, k)),
        "two gains": pg.MixPE(pg.GainPE(a, 0.3), pg.GainPE(b, 0.7)),
        "three gains": pg.MixPE(pg.GainPE(a, 0.3), pg.GainPE(b, 0.7), pg.GainPE(c, 1.9)),
        "gains second and third": pg.MixPE(a, pg.GainPE(b, 0.7), pg.GainPE(c, 1.9)),
        "constant plus gain": pg.MixPE(pg.ConstantPE(300.0), pg.GainPE(b, 2500.0)),
        "gain with two consumers": pg.MixPE(pg.MixPE(a, shared), pg.MixPE(c, shared)),
        "gain ending mid-block": pg.MixPE(a, pg.GainPE(short, 2500.0)),
        "stereo, mono control gain": pg.MixPE(s, pg.GainPE(t, k)),
        "held plus masked gain": pg.MixPE(held, pg.GainPE(b, 0.7)),
        "masked plus held gain": pg.MixPE(a, pg.GainPE(held, 0.7)),
        "constant, masked, gain": pg.MixPE(pg.ConstantPE(0.25), a, pg.GainPE(b, 0.7)),
        "masked gain, held gain": pg.MixPE(pg.GainPE(b, 0.7), pg.GainPE(held, 0.3)),
        "masked gain, short gain": pg.MixPE(pg.GainPE(b, 0.7), pg.GainPE(short, 0.3)),
        "no gain": pg.MixPE(a, b, c),
    }


NAMES = ["gain last", "gain first", "three, gain first", "three, gain middle",
         "three, gain last", "control gain", "two gains", "three gains",
         "gains second and third", "constant plus gain", "gain with two consumers",
         "gain ending mid-block", "stereo, mono control gain", "held plus masked gain",
         "masked plus held gain", "constant, masked, gain", "masked gain, held gain",
         "masked gain, short gain", "no gain"]
# Not mirrored: a scalar gain on a source whose program ends in a select of
# its own (the held ArrayPE zeroes t < 0): LLVM hoists the product into the
# select's arms, so the product reaches the sum masked and is not fused.
# The rule reads only the forms of the MixPE's inputs, not their sources'
# last ops; these renders differ by the product's rounding: at most one
# float32 ulp of the sum or the product, all below 2 here (1.19e-7).
UNMIRRORED = ["masked plus held gain", "masked gain, held gain"]


@pytest.fixture(scope="module")
def jax_renders():
    jpg.set_sample_rate(44100)
    return {name: np.asarray(jengine.render_scan(pe, 0, N, BLOCK))
            for name, pe in _graphs(jpg).items()}


def _port_render(name):
    tpg.set_sample_rate(44100)
    graphs = _graphs(tpg)
    assert list(graphs) == NAMES
    return tengine.render_scan(graphs[name], 0, N, BLOCK, device="cpu").numpy()


@pytest.mark.parametrize("name", [n for n in NAMES if n not in UNMIRRORED])
def test_mix_matches_jax_bit_for_bit(jax_renders, name):
    got, want = _port_render(name), jax_renders[name]
    assert got.shape == want.shape and np.abs(want).max() > 0.5
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", UNMIRRORED)
def test_unmirrored_mix_within_one_ulp(jax_renders, name):
    got, want = _port_render(name), jax_renders[name]
    assert got.shape == want.shape
    assert np.abs(want).max() < 2.0
    np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(np.float32(1.0)))


def test_contraction_is_what_separates_the_renders(jax_renders):
    """The graphs where XLA contracts differ from the product and the sum
    rounded apart (so the bit-for-bit checks above see the rule)."""
    d = _data()
    f32 = np.float32
    apart = d["a"] + d["b"] * f32(2500.0)
    assert np.any(apart != jax_renders["gain last"])
    shared = d["b"] * f32(2500.0)
    np.testing.assert_array_equal((d["a"] + shared) + (d["c"] + shared),
                                  jax_renders["gain with two consumers"])
