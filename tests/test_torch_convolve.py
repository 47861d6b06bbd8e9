"""PyTorch port: ops/fftconv.framed_conv, ConvolvePE and ReverbPE against the
JAX package on the CPU.

The FFTs are libraries' on both sides (pocketfft behind ``torch.fft``,
XLA's CPU FFT behind ``jnp.fft``), so the convolutions are held at
1e-5 × the output's peak, and each test logs the maximum it measured.
Block invariance at 1e-4, the JAX test's bound
(tests/test_convolve_dynamics.py:64).
"""

import logging

import jax
import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.ops import fftconv as jfftconv
from pygmu2_tpu_torch.ops import fftconv as tfftconv

torch.set_num_threads(1)
log = logging.getLogger(__name__)

_rng = np.random.default_rng(4)
X = _rng.standard_normal((3000, 2)).astype(np.float32)
H = (_rng.standard_normal((700, 2)) * np.exp(-np.arange(700) / 150.0)[:, None]).astype(np.float32)


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _render(pg, graph, block=512):
    if pg is tpg:
        return tpg.render_to_array(graph, block=block, device="cpu")
    return np.asarray(pg.render_to_array(graph, block=block))


def _hold(name, got, want):
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    log.info("%s: max abs err %.3g, peak %.3g", name, err, peak)
    assert got.shape == want.shape and peak > 0.1
    assert err <= 1e-5 * peak, f"{name}: {err} > 1e-5 x {peak}"


@pytest.mark.parametrize("L,C,hC,out_len,nfft", [
    (1, 1, 1, 300, None), (64, 2, 1, 1000, None), (700, 2, 2, 1500, None),
    (1024, 1, 1, 4096, None), (300, 2, 2, 900, 512), (200, 1, 1, 700, 256),
])
def test_framed_conv_matches_jax(L, C, hC, out_len, nfft):
    rng = np.random.default_rng(L + C)
    xw = rng.standard_normal((out_len + L - 1, C)).astype(np.float32)
    h = rng.standard_normal((L, hC)).astype(np.float32)
    fn = jax.jit(jfftconv.framed_conv, static_argnums=(2, 3))
    want = np.asarray(fn(xw, h, out_len, nfft))
    got = tfftconv.framed_conv(torch.from_numpy(xw), torch.from_numpy(h), out_len, nfft).numpy()
    _hold(f"framed_conv L={L} C={C} hC={hC} nfft={nfft}", got, want)
    direct = np.stack([np.convolve(xw[:, c], h[:, c % hC], "valid") for c in range(C)], 1)
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-4 * max(1.0, np.abs(direct).max()))


GRAPHS = {
    "mono_ir_stereo_src": lambda pg: pg.ConvolvePE(pg.ArrayPE(X), pg.ArrayPE(H[:, :1])),
    "stereo_ir_mono_src": lambda pg: pg.ConvolvePE(pg.ArrayPE(X[:, :1]), pg.ArrayPE(H)),
    "stereo_both": lambda pg: pg.ConvolvePE(pg.ArrayPE(X), pg.ArrayPE(H)),
    "one_tap": lambda pg: pg.ConvolvePE(pg.ArrayPE(X), pg.ArrayPE([0.5])),
    "fft_size": lambda pg: pg.ConvolvePE(pg.ArrayPE(X), pg.ArrayPE(H[:300]), fft_size=512),
    "reverb": lambda pg: pg.ReverbPE(pg.ArrayPE(X[:1500]), pg.ArrayPE(H), mix=0.3),
    "reverb_unnormalized": lambda pg: pg.ReverbPE(
        pg.ArrayPE(X[:1500]), pg.ArrayPE(H[:200]), mix=0.7, normalize_ir=False),
    "reverb_pe_mix": lambda pg: pg.CropPE(pg.ReverbPE(
        pg.ArrayPE(X[:1500]), pg.ArrayPE(H[:400, :1]),
        mix=pg.MixPE(pg.ConstantPE(0.5), pg.GainPE(pg.ArrayPE(X[:, :1]), 0.2))), 0, 1500),
    "reverb_of_stateful": lambda pg: pg.CropPE(pg.ReverbPE(
        pg.TimeWarpPE(pg.ArrayPE(X), 0.8), pg.ArrayPE(H[:100]), mix=0.5), 0, 2000),
}


@pytest.mark.parametrize("block", [256, 1024])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_matches_jax(name, block):
    want = _render(jpg, GRAPHS[name](jpg), block)
    got = _render(tpg, GRAPHS[name](tpg), block)
    _hold(f"{name} block {block}", got, want)


def test_convolve_block_invariance():
    """As tests/test_convolve_dynamics.py:55 holds the JAX PE."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, 4096).astype(np.float32)
    h = rng.uniform(-1, 1, 333).astype(np.float32)

    def fresh():
        return tpg.ConvolvePE(tpg.ArrayPE(x), tpg.ArrayPE(h))

    one = fresh().render(0, 4096, device="cpu").data
    pe = fresh()
    parts = [pe.render(i * 1024, 1024, device="cpu").data for i in range(4)]
    np.testing.assert_allclose(np.concatenate(parts), one, atol=1e-4)


def test_convolve_history_zeroed_on_a_gap():
    x = np.random.default_rng(2).uniform(-1, 1, (2000, 1)).astype(np.float32)
    h = np.ones((50, 1), np.float32)
    outs = []
    for pg in (jpg, tpg):
        pe = pg.ConvolvePE(pg.ArrayPE(x), pg.ArrayPE(h))
        kw = {"device": "cpu"} if pg is tpg else {}
        pe.render(0, 500, **kw)
        outs.append(pe.render(1000, 500, **kw).data)  # a gap: no history
    fresh = tpg.ConvolvePE(tpg.SetExtentPE(tpg.ArrayPE(x), 1000, 2000), tpg.ArrayPE(h))
    np.testing.assert_allclose(outs[1], fresh.render(1000, 500, device="cpu").data, atol=1e-5)
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5 * np.abs(outs[0]).max())


def test_ir_energy_and_extent_match_jax():
    irs = [pg.ArrayPE(H) for pg in (jpg, tpg)]
    want = jpg.ConvolvePE.ir_energy_norm(irs[0])
    assert tpg.ConvolvePE.ir_energy_norm(irs[1], device="cpu") == want
    assert tpg.ConvolvePE.ir_energy_norm(tpg.SinePE(1.0), device="cpu") == 1.0
    e, f = (pg.ConvolvePE(pg.ArrayPE(X), pg.ArrayPE(H)).extent() for pg in (tpg, jpg))
    assert (e.start, e.end) == (f.start, f.end) == (0, 3000 + 699)
    with pytest.raises(ValueError):
        tpg.ConvolvePE(tpg.ArrayPE(X), tpg.SinePE(3.0))
    with pytest.raises(ValueError):
        tpg.ReverbPE(tpg.ArrayPE(X), tpg.ArrayPE(H), mix=1.5)
