"""PyTorch port: the counter-based noise hash, NoisePE, clamp_accum_scan and
TralfamPE against the JAX package on the CPU.

Tolerances:
- the uint32 hash (done in int64 with 32-bit masks) and white noise, its
  range scaling included (XLA folds it into one fused multiply-add of the
  hash word), bit for bit;
- TralfamPE bit for bit: its scramble is numpy in both packages, over a
  source render that is bit for bit;
- BROWN and ``clamp_accum_scan`` at 2e-6, the JAX tests' own bound
  (tests/test_noise_pe.py:72): the port takes ``lax.associative_scan``'s
  tree, but XLA contracts the walk's ``0.02 w`` product into the scan's
  sums differently in each of its fusions (measured within 8.9e-8);
- PINK at 1e-5, the per-PE bound (its lanes scan in another order; within
  6e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.ops import linrec as jlinrec
from pygmu2_tpu.ops import noise as jnoise
from pygmu2_tpu_torch.ops import linrec as tlinrec
from pygmu2_tpu_torch.ops import noise as tnoise

torch.set_num_threads(1)

N = 2048


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _render(pg, graph, block=512):
    if pg is tpg:
        return tpg.render_to_array(graph, block=block, device="cpu")
    return np.asarray(pg.render_to_array(graph, block=block))


@pytest.mark.parametrize("seed,lane", [(0, 0), (5, 0), (123456789, 3), (2**40 + 7, 1)])
def test_white_uniform_hash_bit_for_bit(seed, lane):
    rng = np.random.default_rng(seed % 1000)
    t = np.concatenate([np.arange(-50, 5000), rng.integers(-2**62, 2**62, 3000),
                        [2**32 - 1, 2**32, 2**33 + 5, -2**32]]).astype(np.int64)
    want = np.asarray(jax.jit(lambda x: jnoise.white_uniform(x, seed=seed, lane=lane))(t))
    got = tnoise.white_uniform(torch.from_numpy(t), seed=seed, lane=lane).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnoise.white_uniform_np(t, seed=seed, lane=lane), want)
    np.testing.assert_array_equal(tnoise.white_uniform_np(t, seed=seed, lane=lane),
                                  jnoise.white_uniform_np(t, seed=seed, lane=lane))


GRAPHS = {
    "white": lambda pg: pg.CropPE(pg.NoisePE(seed=5), 0, N),
    "white_unseeded": lambda pg: pg.CropPE(pg.NoisePE(), 0, N),
    "white_range": lambda pg: pg.CropPE(pg.NoisePE(-0.2, 0.6, seed=9), 0, N),
    "white_unit_range": lambda pg: pg.CropPE(pg.NoisePE(0.0, 1.0, seed=3), 0, N),
    "pink": lambda pg: pg.CropPE(pg.NoisePE(seed=5, mode=pg.NoiseMode.PINK), 0, N),
    "pink_range": lambda pg: pg.CropPE(
        pg.NoisePE(0.0, 2.0, seed=4, mode=pg.NoiseMode.PINK), 0, N),
    "brown": lambda pg: pg.CropPE(pg.NoisePE(seed=5, mode=pg.NoiseMode.BROWN), 0, N),
    "brown_offset": lambda pg: pg.CropPE(
        pg.NoisePE(seed=11, mode=pg.NoiseMode.BROWN), 1000, 1000 + N),
}
TOL = {"pink": 1e-5, "pink_range": 1e-5, "brown": 2e-6, "brown_offset": 2e-6}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_noise_matches_jax(name):
    want = _render(jpg, GRAPHS[name](jpg))
    got = _render(tpg, GRAPHS[name](tpg))
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL.get(name, 0.0))


def test_brown_matches_the_sequential_walk():
    """As tests/test_noise_pe.py:59 holds the JAX PE."""
    x = tpg.NoisePE(seed=11, mode=tpg.NoiseMode.BROWN).render(0, 4096, device="cpu").data[:, 0]
    w = tnoise.white_uniform_np(np.arange(4096), seed=11)
    y, seq = 0.0, []
    for wi in w:
        y = min(max(np.float32(y + np.float32(wi * np.float32(0.02))), -1.0), 1.0)
        seq.append(y)
    np.testing.assert_allclose(x, np.asarray(seq, np.float32), atol=2e-6)


@pytest.mark.parametrize("mode", ["PINK", "BROWN"])
def test_colored_noise_state_carries_across_blocks(mode):
    def fresh():
        return tpg.NoisePE(seed=4, mode=getattr(tpg.NoiseMode, mode))

    one = fresh().render(0, 900, device="cpu").data
    pe = fresh()
    parts = [pe.render(i * 300, 300, device="cpu").data for i in range(3)]
    np.testing.assert_allclose(np.concatenate(parts), one, atol=1e-5 if mode == "PINK" else 1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64, 777])
def test_clamp_accum_scan_matches_jax(n):
    rng = np.random.default_rng(n)
    d = rng.normal(0, 1.5, (n, 3)).astype(np.float32)  # saturation-heavy
    s0 = rng.uniform(-1, 1, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: jlinrec.clamp_accum_scan(a, -1.0, 1.0, b))(
        jnp.asarray(d), jnp.asarray(s0)))
    got = tlinrec.clamp_accum_scan(torch.from_numpy(d), -1.0, 1.0, torch.from_numpy(s0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    ref, cur = [], s0.copy()
    for di in d:
        cur = np.minimum(np.maximum(cur + di, np.float32(-1.0)), np.float32(1.0))
        ref.append(cur)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-6)


# ---- TralfamPE -------------------------------------------------------------

X = np.random.default_rng(2).standard_normal((1500, 2)).astype(np.float32)

TRALFAM = {
    "array": lambda pg: pg.TralfamPE(pg.ArrayPE(X), seed=3),
    "normalized": lambda pg: pg.TralfamPE(pg.ArrayPE(X[:, :1]), seed=7, normalize_peak=0.9),
    "unseeded_offset": lambda pg: pg.TralfamPE(pg.DelayPE(pg.ArrayPE(X[:999]), 250)),
    "stateful_source": lambda pg: pg.TralfamPE(
        pg.CropPE(pg.TimeWarpPE(pg.ArrayPE(X), 0.6), 0, 1100), seed=1),
    "placed": lambda pg: pg.CropPE(pg.DelayPE(pg.TralfamPE(pg.ArrayPE(X[:600]), seed=2), 700),
                                   0, 2000),
}


@pytest.mark.parametrize("name", sorted(TRALFAM))
def test_tralfam_matches_jax(name):
    want = _render(jpg, TRALFAM[name](jpg), block=256)
    got = _render(tpg, TRALFAM[name](tpg), block=256)
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got, want)


def test_tralfam_rejects_what_the_jax_pe_rejects():
    for pg in (jpg, tpg):
        with pytest.raises(ValueError):
            pg.TralfamPE(pg.ArrayPE(X), normalize_peak=0.0)
    with pytest.raises(ValueError):
        tpg.TralfamPE(tpg.SinePE(440.0)).render(0, 64, device="cpu")
