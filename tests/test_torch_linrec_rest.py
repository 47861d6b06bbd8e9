"""PyTorch port: ``ops/linrec.affine_scan_nd`` and ``one_pole_smooth``
against the JAX package's on the CPU.

``affine_scan_nd`` takes ``jax.lax.associative_scan``'s tree (D = 2 as six
component planes, D > 2 as batched matrix products); XLA contracts some
of the combine's products into fused multiply-adds that the port rounds
apart, so it is held to 1e-5 relative to the states' scale (observed
within 4.8e-7 on states of order 1). ``one_pole_smooth`` is
``affine_scan_1`` of ``(1 - coef, coef * x)``, held to the same bound
(observed within 2.4e-7), and against a float64 loop.
"""

import jax
import numpy as np
import pytest
import torch

from pygmu2_tpu.ops import linrec as jlinrec
from pygmu2_tpu_torch.ops import linrec as tlinrec

torch.set_num_threads(1)


def _case(D, T, batch, seed):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.6, 0.6, (T, *batch, D, D)).astype(np.float32)
    u = rng.standard_normal((T, *batch, D)).astype(np.float32)
    s0 = rng.standard_normal((*batch, D)).astype(np.float32)
    return A, u, s0


@pytest.mark.parametrize("D", [2, 3, 4])
@pytest.mark.parametrize("T,batch", [(1, (3,)), (777, (4,)), (1024, ()), (300, (2, 3))])
@pytest.mark.parametrize("with_s0", [True, False])
def test_affine_scan_nd_matches_jax(D, T, batch, with_s0):
    A, u, s0 = _case(D, T, batch, seed=D * 1000 + T)
    s0 = s0 if with_s0 else None
    want = np.asarray(jax.jit(jlinrec.affine_scan_nd)(A, u, s0))
    got = tlinrec.affine_scan_nd(torch.from_numpy(A), torch.from_numpy(u),
                                 None if s0 is None else torch.from_numpy(s0)).numpy()
    assert got.shape == want.shape == (T, *batch, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_affine_scan_nd_against_a_loop():
    A, u, s0 = _case(3, 200, (2,), seed=5)
    s = s0.astype(np.float64)
    want = []
    for t in range(200):
        s = np.einsum("bij,bj->bi", A[t].astype(np.float64), s) + u[t]
        want.append(s)
    got = tlinrec.affine_scan_nd(torch.from_numpy(A), torch.from_numpy(u),
                                 torch.from_numpy(s0)).numpy()
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("coef_kind", ["scalar", "per_sample"])
def test_one_pole_smooth_matches_jax(coef_kind):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 3)).astype(np.float32)
    coef = 0.1 if coef_kind == "scalar" else rng.uniform(0, 1, (500, 3)).astype(np.float32)
    s0 = np.ones(3, np.float32)
    wy, wf = (np.asarray(a) for a in jax.jit(lambda x, c: jlinrec.one_pole_smooth(x, c, s0))(x, coef))
    gy, gf = tlinrec.one_pole_smooth(torch.from_numpy(x),
                                     coef if coef_kind == "scalar" else torch.from_numpy(coef),
                                     torch.from_numpy(s0))
    np.testing.assert_allclose(gy.numpy(), wy, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gf.numpy(), wf, rtol=0, atol=1e-5)
    # the recursion itself, in float64
    c = np.broadcast_to(np.asarray(coef, np.float64), x.shape)
    y, out = s0.astype(np.float64), []
    for t in range(500):
        y = y + c[t] * (x[t] - y)
        out.append(y)
    np.testing.assert_allclose(gy.numpy(), np.stack(out), rtol=0, atol=1e-5)
