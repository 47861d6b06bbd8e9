"""PyTorch port, the order-2 affine scan of wide batches: the plain version
of the chunked kernel against the JAX package's Pallas kernel in interpret
mode, ``affine_scan_2_auto``'s routing against the JAX rule, and
BiquadPE's coefficients against the JAX program's, bit for bit.

Inputs come from numpy with a seed; JAX stays on the CPU. Tolerances are
the JAX tests' own (tests/test_linrec_pallas.py): 2e-5 * max(scale, 1),
5e-5 * max(scale, 1) for the gated biquad structure.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.ops import linrec as jlinrec
from pygmu2_tpu.ops import linrec_pallas
from pygmu2_tpu.ops.linrec_pallas import affine_scan_2_pallas
from pygmu2_tpu_torch.ops import linrec, linrec_kernel
from pygmu2_tpu_torch.ops.linrec_kernel import affine_scan_2_chunked_ref

torch.set_num_threads(1)

MODES = ("LOWPASS", "HIGHPASS", "BANDPASS", "NOTCH", "ALLPASS", "PEAKING", "LOWSHELF",
         "HIGHSHELF")


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_planes(T, C, seed):
    rng = np.random.default_rng(seed)
    mats = [rng.uniform(-0.9, 0.9, (T, C)).astype(np.float32) for _ in range(4)]
    us = [rng.standard_normal((T, C)).astype(np.float32) for _ in range(2)]
    return mats + us


def _check(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * max(scale, 1.0))


@pytest.mark.parametrize("T", [1000, 4096 + 37])
@pytest.mark.parametrize("C", [4, 128])
@pytest.mark.parametrize("chunk", [128, 1024])
@pytest.mark.parametrize("with_s0", [False, True], ids=["zero_state", "s0"])
def test_chunked_ref_matches_pallas(T, C, chunk, with_s0):
    planes = _random_planes(T, C, seed=T + C + chunk)
    s0 = None
    if with_s0:
        rng = np.random.default_rng(C)
        s0 = tuple(rng.standard_normal(C).astype(np.float32) for _ in range(2))
    want = affine_scan_2_pallas(*map(jnp.asarray, planes),
                                None if s0 is None else tuple(map(jnp.asarray, s0)),
                                chunk=chunk, interpret=True)
    got = affine_scan_2_chunked_ref(*map(_t, planes),
                                    None if s0 is None else tuple(map(_t, s0)), chunk=chunk)
    _check(got, want, 2e-5)


def test_chunked_ref_gated_biquad_structure():
    """The SoundFont filter's structure (a22 = u2 = 0, transitions gated)."""
    T, C = 4096 + 37, 128
    rng = np.random.default_rng(3)
    a1 = rng.uniform(-1.8, 1.8, (T, C)).astype(np.float32)
    a2 = rng.uniform(-0.9, 0.9, (T, C)).astype(np.float32)
    keep = (rng.uniform(0, 1, (T, C)) > 0.05).astype(np.float32)
    fir = rng.standard_normal((T, C)).astype(np.float32)
    z = np.zeros((T, C), np.float32)
    planes = [-a1 * keep, -a2 * keep, keep, z, fir, z]
    want = affine_scan_2_pallas(*map(jnp.asarray, planes), chunk=1024, interpret=True)
    got = affine_scan_2_chunked_ref(*map(_t, planes), chunk=1024)
    _check(got, want, 5e-5)


def test_shared_planes_equal_full_planes():
    """(T, 1) planes shared by the channels give the (T, C) result."""
    T, C = 4096 + 37, 8
    planes = _random_planes(T, C, seed=5)
    shared = [_t(p[:, :1]) for p in planes[:4]]
    full = [s.expand(T, C).contiguous() for s in shared]
    us = [_t(p) for p in planes[4:]]
    for a, b in zip(affine_scan_2_chunked_ref(*shared, *us, chunk=1024),
                    affine_scan_2_chunked_ref(*full, *us, chunk=1024)):
        assert torch.equal(a, b)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    planes = [_t(p) for p in _random_planes(4096, 4, seed=9)]
    before = linrec_kernel.affine_scan_2_kernel.launches
    got = linrec_kernel.affine_scan_2_kernel(*planes, chunk=1024)
    assert linrec_kernel.affine_scan_2_kernel.launches == before
    for a, b in zip(got, affine_scan_2_chunked_ref(*planes, chunk=1024)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        linrec_kernel.affine_scan_2_kernel(*(p.to("meta") for p in planes), chunk=1024)


@pytest.mark.parametrize("T,C", [(4096, 3), (4096, 4), (4096, 128), (4096, 129),
                                 (4095, 4), (4095, 128), (8192, 64)])
def test_auto_routes_as_jax(T, C, monkeypatch):
    """The port's route equals the JAX package's under FORCE_KERNEL_INTERPRET
    (its TPU route), at the edges of the rule."""
    from pygmu2_tpu.ops import diffable

    monkeypatch.setattr(diffable, "FORCE_KERNEL_INTERPRET", True)
    jax_took = []
    monkeypatch.setattr(linrec_pallas, "affine_scan_2_pallas",
                        lambda *a, **k: jax_took.append(k["chunk"]) or a[4:6])
    monkeypatch.setattr(jlinrec, "affine_scan_2_seg", lambda *a, **k: a[4:6])
    jlinrec.affine_scan_2_auto(*(jnp.zeros((T, C), jnp.float32),) * 6)
    port_took = []
    monkeypatch.setattr(linrec, "affine_scan_2_kernel",
                        lambda *a, **k: port_took.append(k["chunk"]) or a[4:6])
    monkeypatch.setattr(linrec, "affine_scan_2_seg", lambda *a, **k: a[4:6])
    linrec.affine_scan_2_auto(*(torch.zeros((T, C)),) * 6)
    assert port_took == jax_took
    assert jax_took == ([1024] if T >= 4096 and 4 <= C <= 128 else [])


# ---- BiquadPE's coefficients, bit for bit ------------------------------------


class _Ctx:
    sample_rate = 44100


def _coefficients(mode, q, gain_db, freq):
    """(JAX program's, port's) (b0, b1, b2, a1, a2) of a BiquadPE with a
    swept frequency and a constant q, as the render programs compute them."""
    jpg.set_sample_rate(44100)
    tpg.set_sample_rate(44100)
    jpe = jpg.BiquadPE(jpg.ConstantPE(0.0), jpg.ConstantPE(1.0), q,
                       mode=getattr(jpg.BiquadMode, mode), gain_db=gain_db)
    tpe = tpg.BiquadPE(tpg.ConstantPE(0.0), tpg.ConstantPE(1.0), q,
                       mode=getattr(tpg.BiquadMode, mode), gain_db=gain_db)

    def jax_coef(f):
        clipped = jnp.clip(f, 1.0, 22050 * 0.99)
        return jpe._coefficients(_Ctx, clipped, jnp.clip(jnp.full(f.shape, q, jnp.float32),
                                                         0.01, 100.0))

    want = [np.asarray(v) for v in jax.jit(jax_coef)(freq)]
    f = torch.clamp(_t(freq), 1.0, 22050 * 0.99)
    got = [np.broadcast_to(np.asarray(v, np.float32), want[0].shape)
           for v in tpe._coefficients(_Ctx, f, torch.full(f.shape, q))]
    return want, got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q", [0.7, 6.0])
def test_biquad_coefficients_bit_for_bit(mode, q):
    """A 200-value sweep of 20 Hz - 20 kHz and the effects chain's wah
    centre (its slew-limited follower, from a JAX render), at gain 0 and,
    for the gain modes, +6 and -4.5 dB."""
    freq = np.concatenate([np.geomspace(20.0, 20000.0, 200).astype(np.float32), _wah_centre()])
    gains = (0.0, 6.0, -4.5) if mode in ("PEAKING", "LOWSHELF", "HIGHSHELF") else (0.0,)
    for gain_db in gains:
        want, got = _coefficients(mode, q, gain_db, freq)
        for name, w, g in zip(("b0", "b1", "b2", "a1", "a2"), want, got):
            assert np.array_equal(w.view(np.int32), g.view(np.int32)), (
                f"{mode} q={q} gain {gain_db}: {name} differs on "
                f"{int((w != g).sum())} of {len(freq)} values")


_CENTRE = {}


def _wah_centre():
    """The effects chain's band-pass centre over its first 0.4 s (Hz)."""
    if "c" not in _CENTRE:
        from pygmu2_tpu.core import engine as jengine
        from pygmu2_tpu_torch import fx_workload

        total = int(round(0.4 * fx_workload.SR))
        graph = fx_workload.build_chain(jpg, 0.4)
        stack = [graph]
        while stack:
            pe = stack.pop()
            if type(pe).__name__ == "BiquadPE":
                break
            stack.extend(pe.inputs())
        centre = pe.inputs()[1]
        _CENTRE["c"] = np.asarray(
            jengine.render_scan(jpg.CropPE(centre, 0, total), 0, total, 1024))[:, 0]
    return _CENTRE["c"]
