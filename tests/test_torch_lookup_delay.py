"""PyTorch port: ops/interp, WavetablePE, TimeWarpPE, WindowPE and DelayPE
against the JAX package on the CPU.

Inputs are made with numpy from a seed; modulators (delays, indices,
rates) are ArrayPEs, so each PE's own arithmetic is held. The port mirrors
the op order of XLA's CPU program of each JAX PE (the interpolants'
fused multiply-adds, the folded window offset, XLA's cumsum, its
reciprocal products and its correctly rounded square root), so every
graph is held bit for bit. Block invariance of TimeWarpPE at 1e-3
(tests/test_physical_lookup.py:90).
"""

import jax
import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.ops import interp as jinterp
from pygmu2_tpu_torch.ops import interp as tinterp
from pygmu2_tpu_torch.ops import xla_math

torch.set_num_threads(1)

N = 2048
_rng = np.random.default_rng(0)
X = _rng.standard_normal((3000, 2)).astype(np.float32)
M = _rng.standard_normal((3000, 1)).astype(np.float32)
_t = np.arange(3000)
D = (100.0 + 40.0 * np.sin(_t / 300.0)).astype(np.float32)[:, None]  # delays
IDX = (249.5 + 249.5 * np.sin(_t / 97.0)).astype(np.float32)[:, None]  # table rows
R = (1.0 + 0.3 * np.sin(_t / 150.0)).astype(np.float32)[:, None]  # rates
R_BACK = (1.5 * np.cos(_t / 250.0)).astype(np.float32)[:, None]  # forward, then back


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _crop(pg, pe):
    return pg.CropPE(pe, 0, N)


GRAPHS = {
    "delay_int": lambda pg: _crop(pg, pg.DelayPE(pg.ArrayPE(X), 37)),
    "delay_float": lambda pg: _crop(pg, pg.DelayPE(pg.ArrayPE(X), 3.37)),
    "delay_float_cubic": lambda pg: _crop(pg, pg.DelayPE(
        pg.ArrayPE(X), 13.71, interpolation=pg.InterpolationMode.CUBIC)),
    "delay_negative_float": lambda pg: _crop(pg, pg.DelayPE(pg.ArrayPE(X), -21.6)),
    "delay_pe": lambda pg: _crop(pg, pg.DelayPE(pg.ArrayPE(X), pg.ArrayPE(D), max_delay=200)),
    "delay_pe_cubic": lambda pg: _crop(pg, pg.DelayPE(
        pg.ArrayPE(M), pg.ArrayPE(D), interpolation=pg.InterpolationMode.CUBIC,
        max_delay=150, min_delay=50)),
    "wavetable_zero": lambda pg: _crop(pg, pg.WavetablePE(
        pg.ArrayPE(X[:500]), pg.GainPE(pg.ArrayPE(IDX), 1.1))),
    "wavetable_cubic_wrap": lambda pg: _crop(pg, pg.WavetablePE(
        pg.ArrayPE(X[:500]), pg.GainPE(pg.IdentityPE(), 0.731),
        pg.InterpolationMode.CUBIC, pg.OutOfBoundsMode.WRAP)),
    "wavetable_clamp": lambda pg: _crop(pg, pg.WavetablePE(
        pg.ArrayPE(X[:500]), pg.GainPE(pg.IdentityPE(), 0.331),
        pg.InterpolationMode.LINEAR, pg.OutOfBoundsMode.CLAMP)),
    "wavetable_offset_table": lambda pg: _crop(pg, pg.WavetablePE(
        pg.SetExtentPE(pg.DelayPE(pg.ArrayPE(M[:400]), 100), 100, 500),
        pg.ArrayPE(IDX), pg.InterpolationMode.CUBIC, pg.OutOfBoundsMode.CLAMP)),
    "timewarp_const": lambda pg: _crop(pg, pg.TimeWarpPE(pg.ArrayPE(X), 1.37)),
    "timewarp_cubic": lambda pg: _crop(pg, pg.TimeWarpPE(
        pg.ArrayPE(X), 0.73, interpolation=pg.InterpolationMode.CUBIC)),
    "timewarp_array_rate": lambda pg: _crop(pg, pg.TimeWarpPE(
        pg.ArrayPE(X), pg.ArrayPE(R), max_rate=2.0)),
    "timewarp_negative_rate": lambda pg: _crop(pg, pg.TimeWarpPE(
        pg.ArrayPE(X), pg.ArrayPE(R_BACK), max_rate=1.5,
        interpolation=pg.InterpolationMode.CUBIC)),
    "timewarp_control": lambda pg: _crop(pg, pg.TimeWarpPE(
        pg.ArrayPE(X), pg.ControlPE(1.5), max_rate=2.0,
        interpolation=pg.InterpolationMode.CUBIC)),
    "timewarp_reverse_const": lambda pg: pg.TimeWarpPE(pg.ArrayPE(X), -0.9),
    "window_max": lambda pg: _crop(pg, pg.WindowPE(pg.ArrayPE(X), 0.002, pg.WindowMode.MAX)),
    "window_min": lambda pg: _crop(pg, pg.WindowPE(
        pg.ArrayPE(X), 0.002, pg.WindowMode.MIN, rectify=False)),
    "window_mean": lambda pg: _crop(pg, pg.WindowPE(pg.ArrayPE(X), 0.002, pg.WindowMode.MEAN)),
    "window_rms": lambda pg: _crop(pg, pg.WindowPE(pg.ArrayPE(X), 0.003, pg.WindowMode.RMS)),
}


def _render(pg, graph, block):
    if pg is tpg:
        return tpg.render_to_array(graph, block=block, device="cpu")
    return np.asarray(pg.render_to_array(graph, block=block))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_matches_jax(name):
    block = 300 if name.startswith("timewarp") else 512
    want = _render(jpg, GRAPHS[name](jpg), block)
    got = _render(tpg, GRAPHS[name](tpg), block)
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got, want)


# ---- ops/interp alone, against the JAX functions jitted (XLA's fused program)


@pytest.mark.parametrize("mode", ["linear", "cubic"])
@pytest.mark.parametrize("oob_zero", [True, False])
@pytest.mark.parametrize("per_channel", [False, True])
def test_interp_window_matches_jax(mode, oob_zero, per_channel):
    rng = np.random.default_rng(7)
    window = rng.standard_normal((300, 3)).astype(np.float32)
    shape = (700, 3) if per_channel else (700,)
    pos = rng.uniform(-5.0, 305.0, shape).astype(np.float32)
    fn = jax.jit(jinterp.interp_window, static_argnames=("mode", "oob_zero"))
    want = np.asarray(fn(window, pos, mode=mode, oob_zero=oob_zero))
    got = tinterp.interp_window(torch.from_numpy(window), torch.from_numpy(pos),
                                mode=mode, oob_zero=oob_zero).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["linear", "cubic"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_wrap_interp_matches_jax(mode, per_channel):
    rng = np.random.default_rng(8)
    table = rng.standard_normal((256, 2)).astype(np.float32)
    shape = (600, 2) if per_channel else (600,)
    phase = rng.uniform(-600.0, 900.0, shape).astype(np.float32)
    phase[:4] = np.array([-1e-30, -1e-6, -256.0, 255.99998], np.float32).reshape(
        (4,) + (1,) * (phase.ndim - 1))  # a phase that wraps to exactly W
    fn = jax.jit(jinterp.wrap_interp, static_argnames=("mode",))
    want = np.asarray(fn(table, phase, mode=mode))
    got = tinterp.wrap_interp(torch.from_numpy(table), torch.from_numpy(phase), mode=mode).numpy()
    np.testing.assert_array_equal(got, want)


def test_mod_is_exact_like_jnp_mod():
    x = np.random.default_rng(9).uniform(-1e6, 1e6, 5000).astype(np.float32)
    for m in (1.0, 7.25, 2048.0):
        want = np.asarray(jax.numpy.mod(x, np.float32(m)))
        got = xla_math.mod(torch.from_numpy(x), m).numpy()
        np.testing.assert_array_equal(got, want)


# ---- TimeWarpPE: extents, block invariance --------------------------------


@pytest.mark.parametrize("rate", [2.0, 0.5, -0.5, -2.0, 0.0, 1.37])
def test_timewarp_extent_matches_jax(rate):
    def build(pg):
        return pg.TimeWarpPE(pg.CropPE(pg.IdentityPE(), 10, 1000), rate=rate)

    e, f = build(tpg).extent(), build(jpg).extent()
    assert (e.start, e.end) == (f.start, f.end)


def test_timewarp_state_carry_across_blocks():
    def fresh():
        return tpg.TimeWarpPE(tpg.CropPE(tpg.IdentityPE(), 0, 4000), rate=1.5)

    one = fresh().render(0, 1000, device="cpu").data
    pe = fresh()
    parts = [pe.render(i * 250, 250, device="cpu").data for i in range(4)]
    np.testing.assert_allclose(np.concatenate(parts), one, atol=1e-3)
    np.testing.assert_allclose(one[:, 0], np.arange(1000) * 1.5, atol=1e-3)


def test_timewarp_array_rate_block_invariance():
    def fresh():
        return tpg.TimeWarpPE(tpg.ArrayPE(X), tpg.ArrayPE(R), max_rate=2.0,
                              interpolation=tpg.InterpolationMode.CUBIC)

    one = fresh().render(0, 2000, device="cpu").data
    pe = fresh()
    parts = [pe.render(i * 400, 400, device="cpu").data for i in range(5)]
    np.testing.assert_allclose(np.concatenate(parts), one, atol=1e-3)


def test_delay_extents_match_jax():
    for delay in (7, 3.37, -2.5):
        def build(pg):
            return pg.DelayPE(pg.CropPE(pg.IdentityPE(), 5, 50), delay)

        e, f = build(tpg).extent(), build(jpg).extent()
    assert (e.start, e.end) == (f.start, f.end)
