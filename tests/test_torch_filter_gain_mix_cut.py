"""PyTorch port, the unfused SoundFont pass in its card kernel's order:
``filter_kernels.filter_gain_mix_cut`` (the segment pass of
``csrc/filter_pass.cuh`` over precomputed oscillator samples, in torch ops)
against the plain version ``filter_gain_mix_ref`` (the TPU kernel's
chunk-128 order) and against the JAX package's ``filter_gain_mix_pallas``
in interpret mode.

The cut recurs sample by sample within 512-sample segments and composes
the segments' entering states in the kernel's fixed order; the plain
version scans 128-sample chunks in Kogge-Stone order. Tolerance: 2e-5 *
max(1, peak), the bound the JAX package's tests hold the TPU kernel to
(tests/test_filter_pallas.py). Inputs are made with numpy from a seed.
``python tests/test_torch_filter_gain_mix_cut.py`` prints the observed
maxima.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygmu2_tpu.soundfont.filter_pallas import filter_gain_mix_pallas
from pygmu2_tpu_torch.soundfont import filter_kernels as fk
from test_torch_filter_gain_mix import _random_rows

torch.set_num_threads(1)

# (B, N, P): one and two segments a block, a part block of voices (33), one
# voice, eight blocks of voices; epochs start mid-render in _random_rows
SHAPES = [(3, 256, 128), (2, 1024, 128), (4, 512, 33), (3, 640, 1), (2, 1024, 256)]


def _inputs(B, N, P):
    rng = np.random.default_rng(B * N + P)
    xt = rng.standard_normal((B * N, P)).astype(np.float32)
    return xt, _random_rows(B, P, seed=N + P)


def _errors(B, N, P):
    """(cut vs plain, cut vs the JAX interpret kernel or None, peak)."""
    xt, rows = _inputs(B, N, P)
    t_rows = {k: torch.from_numpy(v) for k, v in rows.items()}
    cut = fk.filter_gain_mix_cut(torch.from_numpy(xt), t_rows, N).numpy()
    ref = fk.filter_gain_mix_ref(torch.from_numpy(xt), t_rows, N).numpy()
    assert cut.shape == ref.shape == (B * N, 2) and np.isfinite(cut).all()
    jax_err = None
    if P == 128:  # the JAX kernel's voice tile
        want = np.asarray(filter_gain_mix_pallas(
            jnp.asarray(xt), {k: jnp.asarray(v) for k, v in rows.items()}, N, chunk=128,
            interpret=True))
        jax_err = float(np.abs(cut - want).max())
    return float(np.abs(cut - ref).max()), jax_err, float(np.abs(ref).max())


@pytest.mark.parametrize("B,N,P", SHAPES)
def test_cut_matches_plain_and_jax_kernel(B, N, P):
    err, jax_err, peak = _errors(B, N, P)
    bound = 2e-5 * max(1.0, peak)
    assert peak > 0.5
    assert err <= bound
    if jax_err is not None:
        assert jax_err <= bound


def _float64_render(xt, rows, N):
    """The unfused pass recurred sample by sample in float64 (the same DF1
    biquad, epochs, gain ramps and mix): the yardstick of both orders."""
    B, P = xt.shape[0] // N, xt.shape[1]
    r = {k: v.astype(np.float64) for k, v in rows.items()}
    x = xt.astype(np.float64)
    y = np.zeros_like(x)
    x1 = x2 = y1 = y2 = np.zeros(P)
    for b in range(B):
        fresh = r["freshf"][b] > 0.5
        x1, x2, y1, y2 = (np.where(fresh, 0.0, v) for v in (x1, x2, y1, y2))
        for n in range(N):
            xi = x[b * N + n]
            yi = (r["b0"][b] * xi + r["b1"][b] * x1 + r["b2"][b] * x2
                  - r["a1"][b] * y1 - r["a2"][b] * y2)
            x2, x1, y2, y1 = x1, xi, y1, yi
            y[b * N + n] = yi
    ramp = (np.arange(N) / N)[None, :, None]

    def gain(prev, cur):
        p, c = r[prev][:, None, :], r[cur][:, None, :]
        g = np.where(np.abs(c - p) < 1e-3, c, p + (c - p) * ramp)
        return np.where(np.maximum(p, c) >= 1e-3, g, 0.0).reshape(B * N, P)

    return np.stack([(gain("pgl", "gl") * y).sum(1), (gain("pgr", "gr") * y).sum(1)], 1)


@pytest.mark.parametrize("B,N,P", SHAPES)
def test_cut_is_nearer_float64_than_plain(B, N, P):
    """On these resonant filters (poles up to 0.95 at any angle) the two
    orders differ by up to 1.75e-5 * peak; the kernel's order is the nearer
    to a float64 recursion (observed 2.2-6.1 times nearer): the chunk-128
    Kogge-Stone order of the TPU kernel and its plain version rounds more."""
    xt, rows = _inputs(B, N, P)
    t_rows = {k: torch.from_numpy(v) for k, v in rows.items()}
    want = _float64_render(xt, rows, N)
    cut = fk.filter_gain_mix_cut(torch.from_numpy(xt), t_rows, N).numpy()
    ref = fk.filter_gain_mix_ref(torch.from_numpy(xt), t_rows, N).numpy()
    assert np.abs(cut - want).max() <= np.abs(ref - want).max()


def test_cut_is_the_fused_cut_over_xt():
    """The unfused order is the fused pass's segment order: the fused cut
    over the same oscillator samples gives the same bits where the gain
    ramps agree (N a power of two: n / N == n * (1 / N))."""
    from test_torch_osc_rows import synthetic_rows

    B, P, N = 3, 40, 1024
    rows, wave, _state = synthetic_rows(B, P, 4096, 5, (1,))
    rows = {k: torch.from_numpy(v) for k, v in rows.items()}
    wave = torch.from_numpy(wave)
    fused, _ = fk.osc_filter_gain_mix_cut(rows, wave, N)
    unfused = fk.filter_gain_mix_cut(fk._oscillator(rows, wave, N), rows, N)
    assert float(fused.abs().max()) > 0.05
    assert torch.equal(fused, unfused)


if __name__ == "__main__":
    for shape in SHAPES:
        err, jax_err, peak = _errors(*shape)
        print(f"B, N, P = {shape}: cut vs plain {err:.3g}, vs the JAX kernel "
              f"{'-' if jax_err is None else f'{jax_err:.3g}'} (peak {peak:.3g}, bound "
              f"{2e-5 * max(1.0, peak):.3g})")
