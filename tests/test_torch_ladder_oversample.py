"""PyTorch port: the ladder's gradient at a high oversampling factor.

JAX's LadderPE differentiates any ``oversample`` >= 1; the port's card
backward once refused os_n > 99 (a chunk's oversampled steps past a CUDA
block's shared memory) and now takes any (``ops/ladder._bwd_layout``: one
chunk a block to os_n = 301, then each sample's steps re-walked from its
entering state; held bit for bit to ``ladder_scan_bwd_chunked`` on the card
by tests/test_torch_cuda.py). Here, on the CPU, at ``oversample=128``:

- the port's gradient through a LadderPE render (autograd of the plain
  ladder) against central differences of the JAX PE's render, within
  1e-3 relative, the whole-render tolerance of
  tests/test_torch_param_grad.py;
- the port's plain adjoint against ``jax.vjp`` of the JAX package's
  ``ladder_scan_ref``, within 1e-5 of the largest cotangent, as
  tests/test_torch_autodiff.py holds each plain adjoint;
- the card kernel's order in torch ops against the plain adjoint, within
  1e-5 of the largest cotangent, over two chunks and a partial one.

The JAX side runs eagerly (``jax.disable_jit``): its reference unrolls the
oversampled steps into the scan's body, and XLA's compile of that body
grows much faster than the body (on this CPU: the PE's forward 24 s at
oversample 16; a one-sample ``jax.vjp`` at 128 did not compile in 10
minutes). So the JAX renders are short: 16 samples, and 2 for the vjp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu.ops.ladder_pallas import ladder_scan_ref as jax_ladder
from pygmu2_tpu_torch.core import engine
from pygmu2_tpu_torch.ops import ladder

torch.set_num_threads(1)
SR = 44100
OS = 128
THETA = {"cutoff": 1800.0, "gain": 0.7}
STEP = {"cutoff": 18.0, "gain": 7e-3}  # the central differences' half steps


def _graph(pg, n):
    pg.set_sample_rate(SR)
    src = pg.BlitSawPE(110.0, 0.6)
    filt = pg.LadderPE(src, pg.ParamPE("cutoff"), 0.6, oversample=OS)
    return pg.CropPE(pg.GainPE(filt, pg.ParamPE("gain")), 0, n)


def test_ladder_pe_gradient_at_oversample_128_matches_jax_differences():
    n = 16
    th = {k: torch.tensor(v, requires_grad=True) for k, v in THETA.items()}
    out = engine.render_functional(_graph(tpg, n), 0, n, n, th, device="cpu")
    loss = (out.double() ** 2).mean()
    got = dict(zip(th, (float(g) for g in torch.autograd.grad(loss, list(th.values())))))
    loss = loss.item()

    graph = _graph(jpg, n)

    def jloss(values):
        b = {k: jnp.float32(v) for k, v in values.items()}
        with jax.disable_jit():
            y = np.asarray(jengine.render_functional(graph, 0, n, n, b), dtype=np.float64)
        return float((y ** 2).mean())

    assert abs(loss - jloss(THETA)) <= 1e-4 * loss
    for k, h in STEP.items():
        hi, lo = dict(THETA, **{k: THETA[k] + h}), dict(THETA, **{k: THETA[k] - h})
        want = (jloss(hi) - jloss(lo)) / (2 * h)
        assert np.isfinite(got[k]) and want != 0.0
        assert abs(got[k] - want) <= 1e-3 * abs(want), (k, got[k], want)


def _inputs(n, C, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, C)).astype(np.float32) * 0.3
    cols = [v.astype(np.float32) for v in (
        rng.uniform(0.05, 0.5, n), rng.uniform(0.9, 1.1, n), rng.uniform(0.0, 3.0, n),
        rng.uniform(1.0, 2.0, n))]
    st = (rng.standard_normal((9, C)) * 0.1).astype(np.float32)
    gy = rng.standard_normal((n, C)).astype(np.float32)
    gs = rng.standard_normal((9, C)).astype(np.float32)
    kw = dict(os_n=OS, pbg=0.3, mode_index=OS % 6, input_threshold=1e-5, state_decay=0.95)
    return [x, *cols, st], gy, gs, kw


def _close(got, want, tol=1e-5):
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float64)
        g = np.asarray(g.detach().numpy() if isinstance(g, torch.Tensor) else g, np.float64)
        scale = np.abs(w).max()
        assert scale > 0 and np.abs(g - w).max() <= tol * scale, (np.abs(g - w).max(), scale)


def test_plain_adjoint_at_oversample_128_matches_jax_vjp():
    args, gy, gs, kw = _inputs(2, 2, seed=3)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda *a: jax_ladder(*a, **kw), *args)
        want = vjp((gy, gs))
    t = [torch.from_numpy(a) for a in args]
    got = ladder.ladder_scan_bwd_ref(*t, torch.from_numpy(gy), torch.from_numpy(gs), **kw)
    _close(got, want)


def test_chunked_order_at_oversample_128_matches_plain_adjoint():
    args, gy, gs, kw = _inputs(70, 2, seed=5)
    t = [torch.from_numpy(a) for a in args]
    gy, gs = torch.from_numpy(gy), torch.from_numpy(gs)
    want = ladder.ladder_scan_bwd_ref(*t, gy, gs, **kw)
    got = ladder.ladder_scan_bwd_chunked(*t, gy, gs, **kw)
    _close(got, [w.numpy() for w in want])
