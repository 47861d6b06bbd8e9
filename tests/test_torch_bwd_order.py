"""PyTorch port: the ladder's and the comb's backward in their kernels' order.

``ops/ladder.ladder_scan_bwd_chunked`` (the chunk order of
``csrc/ladder_scan_bwd.cu``: checkpoints every K samples, each chunk's
affine map of the cotangent, the serial carry over the chunks, the final
walks) and ``ops/comb.comb_scan_bwd_windows`` (the order of
``csrc/comb_scan_bwd.cu``: the smoother's adjoint in the order of
``csrc/order1_grid.cuh``, the forward's windows walked from the last) on
the CPU, each against two references on the same seeded inputs and
cotangents: autograd of the port's plain forward (``*_scan_bwd_ref``)
and ``jax.vjp`` of the JAX package's ``ladder_scan_ref`` / ``comb_scan_ref``.

Tolerances: 1e-5 of the largest cotangent of each output (float32
recurrences summed in other orders: the carry's products at the chunk
edges, autograd's accumulation; observed maxima 5.4e-7, CHANGES.md). The
comb's smoother outputs (gfreq, gsf_in) against the references: T x 2^-23
of the output's largest: the grid's scan multiplies by 1 - alpha rounded
once, autograd by g - g alpha rounded each step, and the two products of T
factors drift apart by up to a rounding a factor. The kernels themselves
are held to these versions bit for bit on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 15).
``python tests/test_torch_bwd_order.py`` prints the observed maxima.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygmu2_tpu.ops.comb_pallas import comb_scan_ref as jax_comb_ref
from pygmu2_tpu.ops.ladder_pallas import ladder_scan_ref as jax_ladder_ref
from pygmu2_tpu_torch.ops import comb, envelope, ladder

torch.set_num_threads(1)

TOL = 1e-5  # of the largest cotangent of each output

# (T, C, os_n, mode, K): T a multiple of K, not one, below K, K = 1; C = 1
# and 3; os_n 1, 2, 4 and 3 (the kernel's generic instantiation); all six
# modes; every case takes the quiet-input decay on a few samples
LADDER_CASES = [
    (64, 1, 2, 0, 32),
    (100, 3, 3, 5, 32),
    (20, 3, 1, 4, 32),
    (12, 1, 4, 2, 1),
    (96, 3, 2, 1, 32),
    (70, 1, 1, 3, 16),
]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ladder_np(T, C, seed):
    rng = np.random.default_rng(seed)

    def u(*s, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, s).astype(np.float32)

    x = u(T, C) * np.float32(0.3)
    x[T // 3:T // 3 + 3] = 1e-7  # quiet: the decay is taken
    args = [x, u(T, lo=0.05, hi=0.55), u(T, lo=0.9, hi=1.1), u(T, lo=0.0, hi=3.0),
            u(T, lo=0.5, hi=2.5), u(9, C) * np.float32(0.1)]
    return args, u(T, C), u(9, C)


def ladder_errors(T, C, os_n, mode, K, seed=0):
    args, gy, gs = _ladder_np(T, C, seed)
    kw = dict(os_n=os_n, pbg=0.3, mode_index=mode, input_threshold=1e-5, state_decay=0.95)
    targs = [torch.from_numpy(a) for a in args]
    got = ladder.ladder_scan_bwd_chunked(*targs, torch.from_numpy(gy), torch.from_numpy(gs),
                                         every=K, **kw)
    want = ladder.ladder_scan_bwd_ref(*targs, torch.from_numpy(gy), torch.from_numpy(gs), **kw)
    _, vjp = jax.vjp(lambda *a: jax_ladder_ref(*a, **kw), *map(jnp.asarray, args))
    want_jax = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    return ([_rel(g, w) for g, w in zip(got, want)],
            [_rel(g, w) for g, w in zip(got, want_jax)])


@pytest.mark.parametrize("T,C,os_n,mode,K", LADDER_CASES)
def test_ladder_chunked_backward_matches_autograd_and_jax(T, C, os_n, mode, K):
    plain, jax_ = ladder_errors(T, C, os_n, mode, K)
    assert max(plain) <= TOL, plain
    assert max(jax_) <= TOL, jax_


def test_ladder_checkpoints_are_the_entering_states():
    """``ladder_checkpoints_ref``: the state entering every
    CHECKPOINT_EVERY-th sample, the state out of a call over the samples
    before it; the chunked backward reads them as given."""
    K = ladder.CHECKPOINT_EVERY
    T = 2 * K + 5
    args, gy, gs = _ladder_np(T, 2, 3)
    targs = [torch.from_numpy(a) for a in args]
    kw = dict(os_n=2, pbg=0.3, mode_index=0, input_threshold=1e-5, state_decay=0.95)
    ckpt = ladder.ladder_checkpoints_ref(*targs, **kw)
    assert ckpt.shape == (3, 9, 2)
    assert torch.equal(ckpt[0], targs[5])
    for j in (1, 2):
        _, st_j = ladder.ladder_scan_ref(*(a[:j * K] for a in targs[:5]), targs[5], **kw)
        assert torch.equal(ckpt[j], st_j)
    cot = (torch.from_numpy(gy), torch.from_numpy(gs))
    given = ladder.ladder_scan_bwd_chunked(*targs, *cot, ckpt, **kw)
    computed = ladder.ladder_scan_bwd_chunked(*targs, *cot, **kw)
    for a, b in zip(given, computed):
        assert torch.equal(a, b)


# ---- the comb ----

L, SR = 97, 8000.0


def _comb_np(T, C, delays, seed, pos=11, sf=None):
    """Seeded inputs whose smoothed frequency gives ``delays`` (alpha = 1:
    the smoother takes each frequency as it is), or a 200-400 Hz sweep."""
    rng = np.random.default_rng(seed)

    def u(*s):
        return rng.uniform(-1.0, 1.0, s).astype(np.float32)

    if isinstance(delays, str):  # "sweep"
        freq, alpha = rng.uniform(200.0, 400.0, T).astype(np.float32), 0.1
    else:
        freq, alpha = (SR / np.asarray(delays, np.float64)).astype(np.float32), 1.0
    args = [u(T, C), freq, u(T) * np.float32(0.9), u(L, C), np.int32(pos),
            np.float32(230.0 if sf is None else sf)]
    return args, [u(T, C), u(L, C), np.float32(0.7)], dict(L=L, sr=SR, smooth_alpha=alpha)


def _step(T, a, b, at):
    return np.where(np.arange(T) < at, a, b)


COMB_CASES = {
    "constant delay, T > L": (300, 3, lambda T: np.full(T, 37), 11),
    "swept delay": (300, 1, "sweep", 11),
    "delay 1, one-sample windows": (40, 2, lambda T: np.full(T, 1), 11),
    "delay steps up by one": (200, 2, lambda T: _step(T, 20, 21, 90), 11),
    "delay jumps up by four": (200, 2, lambda T: _step(T, 20, 24, 70), 11),
    "reads into the ring, pos wraps, T < L": (60, 3, lambda T: np.full(T, 50), L - 3),
}


def comb_errors(T, C, delays, pos, seed=0):
    if callable(delays):
        delays = delays(T)
    args, cts, kw = _comb_np(T, C, delays, seed, pos)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    y = comb.comb_scan_ref(*targs, **kw)[0]
    tcts = [torch.from_numpy(np.array(c)) for c in cts]
    got = comb.comb_scan_bwd_windows(*targs, y, *tcts, **kw)
    want = comb.comb_scan_bwd_ref(*targs, y, *tcts, **kw)

    def f(x, freq, fb, buf, sf):
        out = jax_comb_ref(x, freq, fb, buf, args[4], sf, **kw)
        return out[0], out[1], out[3]

    _, vjp = jax.vjp(f, *(jnp.asarray(args[i]) for i in (0, 1, 2, 3, 5)))
    want_jax = vjp(tuple(jnp.asarray(c) for c in cts))
    return ([_rel(g, w) for g, w in zip(got, want)],
            [_rel(g, w) for g, w in zip(got, want_jax)])


def _comb_tols(T):
    smoother = max(TOL, T * 2.0 ** -23)  # gfreq, gsf_in
    return [TOL, smoother, TOL, TOL, smoother]


@pytest.mark.parametrize("case", list(COMB_CASES))
def test_comb_window_backward_matches_autograd_and_jax(case):
    T, C, delays, pos = COMB_CASES[case]
    plain, jax_ = comb_errors(T, C, delays, pos)
    for errs in (plain, jax_):
        assert all(e <= tol for e, tol in zip(errs, _comb_tols(T))), (case, errs)


def test_comb_residuals_on_the_cpu():
    """``comb_control_ref``, the control results the forward launch keeps
    for the backward: the smoothed values and the sf the plain forward
    ends on, the delays it reads with, and windows that cover [0, T) in
    which no sample reads a row of its own window; the window order
    equals the plain forward bit for bit on them."""
    T = 120
    args, _, kw = _comb_np(T, 2, "sweep", 5)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    smoothed, delay, bounds = comb.comb_control_ref(targs[1], targs[5], **kw)
    want = comb.comb_scan_ref(*targs, **kw)
    assert smoothed.shape == (T,) and delay.dtype == torch.int32
    assert torch.equal(smoothed[-1], want[3])
    assert bounds[0] == 0 and bounds[-1] == T and all(a < b for a, b in zip(bounds, bounds[1:]))
    for a, b in zip(bounds[:-1], bounds[1:]):
        assert all(t - int(delay[t]) < a for t in range(a, b))
    for got, w in zip(comb.comb_scan_windows(*targs, **kw), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("T", [300, 16384 + 77])
@pytest.mark.parametrize("g_kind", ["zero", "noise"])
def test_order1_grid_adjoint_matches_serial(T, g_kind):
    """The smoother's adjoint in its kernel's order
    (``envelope.order1_adjoint_grid`` at one channel: 256-sample chunks,
    T one chunk and past 64 of them) on the comb's coefficients (k in
    [0, 0.2], 1 where the select took f, every 97th sample) against a
    float64 serial walk: within 1e-5 of the largest output. ``zero``: g all
    zeros and only g_final, as the comb's smoother; ``noise``: a cotangent
    at every sample too."""
    rng = np.random.default_rng(T)
    k = rng.uniform(0.0, 0.2, T).astype(np.float32)
    k[::97] = 1.0  # the select took f: the carry stops
    g = (rng.standard_normal(T) if g_kind == "noise" else np.zeros(T)).astype(np.float32)
    gx, g_in = envelope.order1_adjoint_grid(torch.from_numpy(k)[:, None],
                                            torch.from_numpy(g)[:, None], torch.tensor([0.5]))
    lam, want = 0.5, np.empty(T)
    for t in reversed(range(T)):
        lam = g[t] + lam
        want[t] = k[t] * lam
        lam = (1.0 - float(k[t])) * lam
    assert gx.shape == (T, 1) and g_in.shape == (1,)
    assert np.abs(want).max() > 0.0
    assert _rel(gx[:, 0].numpy(), want) <= TOL
    assert abs(float(g_in[0]) - lam) <= TOL * np.abs(want).max()


if __name__ == "__main__":
    for case in LADDER_CASES:
        print("ladder", case, *ladder_errors(*case))
    for name, (T, C, delays, pos) in COMB_CASES.items():
        print("comb", name, *comb_errors(T, C, delays, pos))
