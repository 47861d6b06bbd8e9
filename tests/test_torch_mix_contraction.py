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
- at the edge of the GainPE's extent, the samples outside it add zero;
- a scalar gain's product on a source whose program ends in a zeroing
  select of its own (a HOLD_LAST or HOLD_FIRST ArrayPE) is hoisted into
  that select's arms: it fuses only with a constant or the same select;
- a consumer's mask over the MixPE (a CropPE's extent equal to, inside or
  beyond a masked gain's) changes none of this.

The port's MixPE mirrors exactly that (``models/basic.MixPE._trace``,
``core/engine.TraceContext.factors_of``). Each graph renders through
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
    held_b = pg.ArrayPE(d["b"].copy(), extend_mode=pg.ExtendMode.HOLD_LAST)
    # one that holds its first value before t = 0 and zeroes t >= n
    first = pg.ArrayPE(d["c"].copy(), extend_mode=pg.ExtendMode.HOLD_FIRST)
    both = pg.ArrayPE(d["c"].copy(), extend_mode=pg.ExtendMode.HOLD_BOTH)  # never selected
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
        "constant plus held gain": pg.MixPE(pg.ConstantPE(0.25), pg.GainPE(held, 0.7)),
        "held gain, masked": pg.MixPE(pg.GainPE(held, 0.7), a),
        "masked plus held-first gain": pg.MixPE(a, pg.GainPE(first, 0.7)),
        "masked plus held control gain": pg.MixPE(a, pg.GainPE(held, k)),
        "held plus held gain": pg.MixPE(held, pg.GainPE(held_b, 0.7)),
        # a consumer's mask (a CropPE's) equal to, inside and beyond the
        # masked gain's extent
        "crop to the gain's extent": pg.CropPE(pg.MixPE(both, pg.GainPE(short, 0.7)), 0, 3000),
        "crop inside the gain's extent": pg.CropPE(pg.MixPE(both, pg.GainPE(short, 0.7)), 0,
                                                   2000),
        "crop beyond the gain's extent": pg.CropPE(pg.MixPE(both, pg.GainPE(short, 0.7)), 0,
                                                   3500),
        "gain of the cropped mix": pg.GainPE(
            pg.CropPE(pg.MixPE(both, pg.GainPE(short, 0.7)), 0, 3000), 2.0),
        "masked, cropped to the gain's extent": pg.CropPE(pg.MixPE(a, pg.GainPE(short, 0.7)),
                                                          0, 3000),
    }


NAMES = ["gain last", "gain first", "three, gain first", "three, gain middle",
         "three, gain last", "control gain", "two gains", "three gains",
         "gains second and third", "constant plus gain", "gain with two consumers",
         "gain ending mid-block", "stereo, mono control gain", "held plus masked gain",
         "masked plus held gain", "constant, masked, gain", "masked gain, held gain",
         "masked gain, short gain", "no gain", "constant plus held gain",
         "held gain, masked", "masked plus held-first gain", "masked plus held control gain",
         "held plus held gain", "crop to the gain's extent", "crop inside the gain's extent",
         "crop beyond the gain's extent", "gain of the cropped mix",
         "masked, cropped to the gain's extent"]
# A scalar gain on a source whose program ends in a select of its own (the
# held ArrayPE zeroes t < 0, the HOLD_FIRST one t >= n): LLVM hoists the
# product into the select's arms, so the product reaches the sum selected,
# as a masked one does, and fuses only where the other operand is a constant
# or carries the same select; a control gain's product is not hoisted. The
# port's MixPE reads that select as the input's form
# (``ArrayPE._xla_select``, ``GainPE._xla_select``).
HOISTED = ["masked plus held gain", "masked gain, held gain", "constant plus held gain",
           "held gain, masked", "masked plus held-first gain", "held plus held gain"]


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


@pytest.mark.parametrize("name", [n for n in NAMES if n not in HOISTED])
def test_mix_matches_jax_bit_for_bit(jax_renders, name):
    got, want = _port_render(name), jax_renders[name]
    assert got.shape == want.shape and np.abs(want).max() > 0.5
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", HOISTED)
def test_hoisted_gain_mix_matches_jax_bit_for_bit(jax_renders, name):
    got, want = _port_render(name), jax_renders[name]
    assert got.shape == want.shape and np.abs(want).max() > 0.5
    np.testing.assert_array_equal(got, want)


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
