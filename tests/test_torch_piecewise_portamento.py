"""PyTorch port: PiecewisePE and PortamentoPE against the JAX package on
the CPU, across two block splits.

The JAX render is taken at one block size (the JAX package's own tests
hold it block-invariant); the port's at two. Both routes of PiecewisePE
are held: up to 1024 points the JAX package's
one-hot route (block-anchored float32 times, host ``1/len``; the port
gathers the segment's row where the JAX package picks it with an exact
one-hot matmul), beyond it the float64 searchsorted route. Every
TransitionType and ExtendMode, bit for bit: the curves take XLA's CPU
arithmetic (fused multiply-adds, XLA's own ``exp``, glibc's ``powf``,
``sinf`` and ``cosf``).
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg

torch.set_num_threads(1)

N = 4000
BLOCKS = (512, 1000)


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _render(pg, graph, block):
    if pg is tpg:
        return tpg.render_to_array(graph, block=block, device="cpu")
    return np.asarray(pg.render_to_array(graph, block=block))


def _points(n, span=3000, neg=False, seed=0):
    rng = np.random.default_rng(seed + n)
    t = np.sort(rng.choice(np.arange(span), n, replace=False)) + 100
    v = rng.uniform(-5.0 if neg else 0.1, 5.0, n)
    return [(int(a), float(b)) for a, b in zip(t, v)]


POINTS = {
    "one": [(700, 2.5)],
    "two": _points(2),
    "seven": _points(7),
    "signed": _points(20, neg=True),
    "dense_1500": _points(1500, span=3400),  # the searchsorted route
}
MODES = ["step", "linear", "exponential", "sigmoid", "constant_power"]
EXTEND = ["ZERO", "HOLD_FIRST", "HOLD_LAST", "HOLD_BOTH"]


def _check(build):
    want = _render(jpg, build(jpg), BLOCKS[-1])
    for block in BLOCKS:
        got = _render(tpg, build(tpg), block)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("points", sorted(POINTS))
@pytest.mark.parametrize("mode", MODES)
def test_piecewise_bit_for_bit(points, mode):
    pts = POINTS[points]
    _check(lambda pg: pg.CropPE(pg.PiecewisePE(pts, mode, pg.ExtendMode.HOLD_BOTH), 0, N))


@pytest.mark.parametrize("extend", EXTEND)
@pytest.mark.parametrize("points", ["one", "seven", "dense_1500"])
def test_piecewise_extend_modes(points, extend):
    pts = POINTS[points]
    _check(lambda pg: pg.SetExtentPE(pg.PiecewisePE(pts, "linear", getattr(pg.ExtendMode, extend),
                                                    channels=2), 0, N))


def test_piecewise_far_from_origin():
    """Breakpoints ~2^24 samples from the block: the block-anchored float32
    times stay exact near the block, and the routes agree."""
    base = 2**24 + 12345
    pts = [(base + t, v) for t, v in POINTS["seven"]]
    _check(lambda pg: pg.CropPE(pg.PiecewisePE(pts, "sigmoid", pg.ExtendMode.HOLD_BOTH),
                                base, N))


def test_powf_bit_for_bit():
    """glibc's ``powf`` (XLA's ``x ** y`` on the CPU) on seeded arguments."""
    import jax
    import jax.numpy as jnp

    from pygmu2_tpu_torch.ops import xla_math

    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(1e-3, 1e3, 60000), rng.uniform(0.9, 1.1, 20000),
                        [1.0, 2.0, 0.5, 3.0]]).astype(np.float32)
    y = np.concatenate([rng.uniform(0.0, 1.0, 40000), rng.uniform(-8.0, 8.0, 40000),
                        [0.0, 1.0, 0.5, 0.3]]).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: a ** b)(x, y))
    got = xla_math.powf(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)


def test_route_boundary():
    from pygmu2_tpu_torch.models import piecewise

    assert piecewise._MATMUL_MAX_POINTS == 1024
    for n in (1024, 1025):
        pts = _points(n, span=3500, seed=3)
        _check(lambda pg: pg.CropPE(pg.PiecewisePE(pts, "constant_power"), 0, N))


@pytest.mark.parametrize("ramp,frac", [(0.08, 0.3), (0.0, 0.0), (0.5, 1.0)])
def test_portamento_bit_for_bit(ramp, frac):
    rng = np.random.default_rng(7)
    starts = np.cumsum(rng.integers(300, 2000, 30))
    notes = [(float(f), int(s), int(d)) for f, s, d in
             zip(rng.uniform(80.0, 900.0, 30), starts, rng.integers(200, 2200, 30))]
    want = _render(jpg, jpg.CropPE(jpg.PortamentoPE(notes, ramp, frac, channels=2), 0, 40000),
                   16384)
    for block in (4096, 16384):
        got = _render(tpg, tpg.CropPE(tpg.PortamentoPE(notes, ramp, frac, channels=2), 0, 40000),
                      block)
        np.testing.assert_array_equal(got, want)
        assert want.shape == (40000, 2)
    port = tpg.PortamentoPE(notes, ramp, frac)
    jax = jpg.PortamentoPE(notes, ramp, frac)
    assert repr(port) == repr(jax) and port.notes == jax.notes
    assert port.inputs()[0].points == jax.inputs()[0].points
