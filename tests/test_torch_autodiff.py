"""PyTorch port, autodiff: gradients of the kernels and of ``ops/xla_math``.

Counterparts of ``tests/test_kernel_gradients.py``, one per kernel (ladder,
comb, Karplus-Strong, ADSR state, envelope follower, order-2 affine scan,
reverse echo), at that file's sizes and seeds: the port's plain version
under ``torch.autograd.grad`` against ``jax.vjp`` of the JAX package's
``*_scan_ref`` on the same inputs and seeded cotangents (a custom VJP's
backward is exactly that in the JAX package), and against central finite
differences with ``_fd_check``'s bounds. The scan's backward
(``affine_scan_2_bwd``: the adjoint scan on the reversed, transposed
planes, then gu, gA, gs0 in torch ops) is held to autograd of the plain
forward, and the autograd glue of the card's launches
(``ops/diffable.py``) is run here with the plain versions as its launches.
The backward kernels themselves are held to autograd of the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: cotangents against ``jax.vjp`` 1e-5 of the largest (float32
recurrences summed in other orders; observed maxima in CHANGES.md); the
scan's adjoint and the glue against autograd 1e-5 of the largest; ``ops/xla_math``'s
gradients against ``jax.grad``: ``fmaf``'s and ``expf``'s exactly, the
others 1e-6 relative (the sine's and cosine's 5e-6: the derivative of
glibc's polynomial, not ``cos`` itself). ``python
tests/test_torch_autodiff.py`` prints the observed maxima.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygmu2_tpu_torch as pt
from pygmu2_tpu.ops.comb_pallas import comb_scan_ref as jax_comb_ref
from pygmu2_tpu.ops.envelope_pallas import envelope_ar_scan_ref as jax_env_ref
from pygmu2_tpu.ops.ks_pallas import ks_scan_ref as jax_ks_ref
from pygmu2_tpu.ops.adsr_pallas import adsr_scan_ref as jax_adsr_ref
from pygmu2_tpu.ops.ladder_pallas import ladder_scan_ref as jax_ladder_ref
from pygmu2_tpu.ops.linrec import affine_scan_2 as jax_affine_scan_2
from pygmu2_tpu.ops.reverse_echo_pallas import reverse_echo_scan_ref as jax_echo_ref
from pygmu2_tpu.ops.slew_pallas import slew_scan_ref as jax_slew_ref
from pygmu2_tpu_torch.core import engine
from pygmu2_tpu_torch.ops import adsr, comb, diffable, envelope, ks, ladder, linrec
from pygmu2_tpu_torch.ops import linrec_kernel, reverse_echo, slew, xla_math

torch.set_num_threads(1)

VJP_TOL = 1e-5  # of the largest cotangent
ORDER_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy; keeps a 0-d shape


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _grads(fn, args, diff, cts):
    """torch.autograd.grad of ``fn(*args)`` against cotangents ``cts``
    with respect to the arguments at positions ``diff``."""
    args = list(args)
    for i in diff:
        args[i] = args[i].detach().clone().requires_grad_()
    outs = fn(*args)
    pairs = [(o, c) for o, c in zip(outs, cts) if c is not None and o.requires_grad]
    return torch.autograd.grad([o for o, _ in pairs], [args[i] for i in diff],
                               [c for _, c in pairs], allow_unused=True,
                               materialize_grads=True)


def _jax_vjp(fn, args, diff, cts):
    """jax.vjp of ``fn(*args)`` with respect to ``args[diff]``."""
    def f(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        return fn(*full)

    out, vjp = jax.vjp(f, *(args[i] for i in diff))
    cts = tuple(jnp.zeros_like(o) if c is None else jnp.asarray(c)
                for o, c in zip(out, cts))
    return vjp(cts)


def _cotangents(rng, outs):
    return [None if not o.is_floating_point() else
            np.asarray(rng.standard_normal(tuple(o.shape)), np.float32) for o in outs]


def _fd_check(loss, x, idxs, atol=2e-2, rtol=8e-2, eps=1e-3):
    """tests/test_kernel_gradients.py's check: the gradient of ``loss`` at
    ``x`` against central finite differences at ``idxs``."""
    xg = x.detach().clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(xg), xg)
    assert torch.isfinite(g).all()
    for idx in idxs:
        xp, xm = x.clone(), x.clone()
        xp[idx] += eps
        xm[idx] -= eps
        with torch.no_grad():
            fd = (loss(xp) - loss(xm)) / (2 * eps)
        np.testing.assert_allclose(float(g[idx]), float(fd), atol=atol, rtol=rtol,
                                   err_msg=f"AD vs finite difference at {idx}")


def _check_vjp(torch_fn, jax_fn, np_args, diff, seed, to_torch=_t, to_jax=jnp.asarray):
    """Cotangents of the port's plain version against jax.vjp of the JAX
    reference, all float outputs with seeded cotangents."""
    rng = np.random.default_rng(seed)
    targs = [to_torch(a) for a in np_args]
    outs = torch_fn(*targs)
    cts = _cotangents(rng, outs)
    got = _grads(torch_fn, targs, diff, [None if c is None else _t(c) for c in cts])
    want = _jax_vjp(jax_fn, [to_jax(a) for a in np_args], diff, cts)
    errs = [_rel(g.detach().numpy(), w) for g, w in zip(got, want)]
    assert max(errs) <= VJP_TOL, errs
    return errs


# ---- ops/xla_math: the gradients of the functions they round ---------------


def _xla_math_gradients():
    """(name, the port's gradient, jax.grad's) of each ``ops/xla_math``
    function and the function it rounds, at seeded points."""
    rng = np.random.default_rng(11)
    a, b, c = (rng.uniform(-3, 3, 64).astype(np.float32) for _ in range(3))
    x = rng.uniform(-20, 20, 64).astype(np.float32)
    pos = rng.uniform(0.1, 8.0, 64).astype(np.float32)
    y = rng.uniform(-3, 3, 64).astype(np.float32)
    ang = rng.uniform(-100, 100, 64).astype(np.float32)

    def tgrad(fn, *args):
        ts = [_t(v).requires_grad_() for v in args]
        return [g.numpy() for g in torch.autograd.grad(fn(*ts).sum(), ts)]

    def jgrad(fn, *args):
        return jax.grad(lambda *v: jnp.sum(fn(*v)), argnums=tuple(range(len(args))))(
            *map(jnp.asarray, args))

    yield from (("fmaf", g, np.asarray(w)) for g, w in
                zip(tgrad(xla_math.fmaf, a, b, c), jgrad(lambda p, q, r: p * q + r, a, b, c)))
    yield "expf", tgrad(xla_math.expf, x)[0], np.asarray(jgrad(jnp.exp, x)[0])
    yield from (("powf", g, np.asarray(w)) for g, w in
                zip(tgrad(xla_math.powf, pos, y), jgrad(lambda p, q: p ** q, pos, y)))
    yield ("sinf", tgrad(lambda v: xla_math.sincosf(v)[0], ang)[0],
           np.asarray(jgrad(jnp.sin, ang)[0]))
    yield ("cosf", tgrad(lambda v: xla_math.sincosf(v)[1], ang)[0],
           np.asarray(jgrad(jnp.cos, ang)[0]))
    yield "sqrtf", tgrad(xla_math.sqrtf, pos)[0], np.asarray(jgrad(jnp.sqrt, pos)[0])


def test_xla_math_gradients_match_jax():
    for name, got, want in _xla_math_gradients():
        if name in ("fmaf", "expf"):  # a·b + c's and exp's gradients, exactly
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name in ("sinf", "cosf"):
            np.testing.assert_allclose(got, want, rtol=5e-6, atol=5e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30, err_msg=name)


def test_xla_math_midpoint_step_carries_no_gradient():
    # a·b = 1 + 2^-11 + 2^-24 is a float32 midpoint and c = 2^-80 is lost
    # in the float64 sum: fmaf steps the sum up before the rounding, and the
    # gradient is still a·b + c's, (b, a, 1)
    a = torch.tensor([1.0 + 2.0 ** -12], requires_grad=True)
    b = torch.tensor([1.0 + 2.0 ** -12], requires_grad=True)
    c = torch.tensor([2.0 ** -80], requires_grad=True)
    out = xla_math.fmaf(a, b, c)
    assert float(out.detach()) == 1.0 + 2.0 ** -11 + 2.0 ** -23
    ga, gb, gc = torch.autograd.grad(out.sum(), (a, b, c))
    assert torch.equal(ga, b.detach()) and torch.equal(gb, a.detach())
    assert torch.equal(gc, torch.ones(1))


# ---- kernel-level gradients against jax.vjp and finite differences ---------


def _ladder_np(T=300, C=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, C)).astype(np.float32) * np.float32(0.3)
    al = rng.uniform(0.1, 0.6, T).astype(np.float32)
    qa = np.full((T,), 2.0, np.float32)
    ki = np.full((T,), 0.5, np.float32)
    dsc = np.full((T,), 0.8, np.float32)
    st = np.zeros((9, C), np.float32)
    kw = dict(os_n=2, pbg=0.3, mode_index=0, input_threshold=1e-5, state_decay=0.999)
    return [x, al, qa, ki, dsc, st], kw


def test_ladder_grad_matches_jax_vjp_and_fd():
    args, kw = _ladder_np()
    _check_vjp(lambda *a: ladder.ladder_scan_ref(*a, **kw),
               lambda *a: jax_ladder_ref(*a, **kw), args, range(6), seed=100)
    x, al, qa, ki, dsc, st = map(_t, args)

    def loss(x):
        return (ladder.ladder_scan(x, al, qa, ki, dsc, st, **kw)[0] ** 2).sum()

    _fd_check(loss, x, [(5, 0), (100, 1), (250, 0)])

    def loss_al(al):
        return (ladder.ladder_scan(x, al, qa, ki, dsc, st, **kw)[0] ** 2).sum()

    _fd_check(loss_al, al, [(50,), (200,)])


def _comb_np():
    rng = np.random.default_rng(1)
    T, C, L, sr = 400, 2, 97, 8000.0
    x = rng.standard_normal((T, C)).astype(np.float32) * np.float32(0.5)
    freq = np.full((T,), 220.0, np.float32)
    fb = np.full((T,), 0.7, np.float32)
    buf = np.zeros((L, C), np.float32)
    kw = dict(L=L, sr=sr, smooth_alpha=1.0 / 240)
    return [x, freq, fb, buf, np.int32(0), np.float32(-1.0)], kw


def test_comb_grad_matches_jax_vjp_and_fd():
    args, kw = _comb_np()
    # a ring and a smoothed frequency handed in, so every cotangent is live
    rng = np.random.default_rng(12)
    args[3] = rng.standard_normal(args[3].shape).astype(np.float32)
    args[5] = np.float32(230.0)
    _check_vjp(lambda *a: comb.comb_scan_ref(*a, **kw), lambda *a: jax_comb_ref(*a, **kw),
               args, [0, 1, 2, 3, 5], seed=101)
    args, kw = _comb_np()
    x, freq, fb, buf, pos, sf = map(_t, args)

    def loss(x):
        return (comb.comb_scan(x, freq, fb, buf, pos, sf, **kw)[0] ** 2).sum()

    _fd_check(loss, x, [(3, 0), (200, 1)])

    def loss_fb(fb):
        return (comb.comb_scan(x, freq, fb, buf, pos, sf, **kw)[0] ** 2).sum()

    _fd_check(loss_fb, fb, [(150,)])


def test_ks_grad_matches_jax_vjp_and_fd():
    rng = np.random.default_rng(2)
    T, L, c = 500, 83, 0.35
    rho = rng.uniform(0.95, 0.999, T).astype(np.float32)
    act = np.arange(T) >= 10
    buf = rng.standard_normal(L).astype(np.float32)
    args = [rho, act, buf, np.int32(0), np.float32(0.0), np.float32(0.0)]
    kw = dict(L=L, allpass_c=c)
    _check_vjp(lambda *a: ks.ks_scan(*a, **kw), lambda *a: jax_ks_ref(*a, **kw),
               args, [0, 2, 4, 5], seed=102)
    rho_t, act_t, buf_t = _t(rho), _t(act), _t(buf)
    r0, z = torch.tensor(0, dtype=torch.int32), torch.tensor(0.0)

    def loss(buf):
        return (ks.ks_scan(rho_t, act_t, buf, r0, z, z, **kw)[0] ** 2).sum()

    _fd_check(loss, buf_t, [(7,), (40,)])


def test_ks_blocked_grad_matches_jax():
    """The blocked order (every sample active, a long string), which XLA
    differentiates natively in the JAX package."""
    from pygmu2_tpu.ops.ks_block import ks_blocked as jax_ks_blocked

    rng = np.random.default_rng(7)
    T, L, c = 400, 160, 0.35
    rho = rng.uniform(0.95, 0.999, T).astype(np.float32)
    buf = rng.standard_normal(L).astype(np.float32)
    args = [rho, buf, np.int32(5), np.float32(0.1), np.float32(-0.2)]
    kw = dict(L=L, allpass_c=c)
    _check_vjp(lambda *a: ks.ks_blocked_ref(*a, **kw),
               lambda *a: jax_ks_blocked(*a, **kw), args, [0, 1, 3, 4], seed=103)


def test_adsr_state_grad_matches_jax_vjp():
    T = 2000
    gate = np.zeros(T, np.float32)
    gate[100:1200] = 1.0
    kw = dict(dA=1.0 / 80, dD=-0.4 / 200, dR=-0.6 / 300, sus=0.6)
    st = np.asarray([4.0, 0.5, 3.0, 1.0], np.float32)
    errs = _check_vjp(lambda *a: adsr.adsr_scan(*a, **kw)[:2],
                      lambda *a: jax_adsr_ref(*a, **kw), [gate, st], [1], seed=104)
    # the envelope is a state machine over gate edges: the gradient is
    # defined, and the e0 carry is the continuously differentiable channel
    stt = _t(st).requires_grad_()
    (g,) = torch.autograd.grad(adsr.adsr_scan(_t(gate), stt, **kw)[0].sum(), stt)
    assert torch.isfinite(g).all() and errs[0] <= VJP_TOL


def test_envelope_grad_matches_jax_vjp_and_fd():
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal((600, 2)).astype(np.float32)) * np.float32(0.5)
    e0 = np.asarray([0.1, 0.3], np.float32)
    kw = dict(atk=0.05, rel=0.002)
    _check_vjp(lambda *a: envelope.envelope_ar_scan(*a, **kw),
               lambda *a: jax_env_ref(*a, **kw), [x, e0], [0, 1], seed=105)

    def loss(x):
        return (envelope.envelope_ar_scan(x, _t(e0) * 0, **kw)[0] ** 2).sum()

    _fd_check(loss, _t(x), [(10, 0), (400, 1)])


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "exponential"])
def test_slew_grad_matches_jax_vjp_and_fd(linear):
    """Steps the limiter climbs and falls in exact quarters and eighths, so
    x_t - y_{t-1} equals the limit exactly (a tie: autograd of
    torch.minimum / torch.maximum and jax.vjp of jnp.clip both split the
    gradient), then noise; finite differences where no sample ties."""
    rng = np.random.default_rng(6)
    T = 300
    x = np.where(np.arange(T) % 40 < 20, 1.0, 0.0).astype(np.float32)
    x[150:] += rng.uniform(-0.3, 0.3, T - 150).astype(np.float32)
    kw = dict(linear=linear, p_rise=0.25 if linear else 0.2, p_fall=0.125 if linear else 0.05)
    y, _ = slew.slew_scan(_t(x), torch.tensor(0.0), **kw)
    prev = np.concatenate([[0.0], y.numpy()[:-1]]).astype(np.float32)
    ties = int(np.sum((x - prev == np.float32(0.25)) | (x - prev == np.float32(-0.125))))
    assert ties >= 4 or not linear
    _check_vjp(lambda *a: slew.slew_scan(*a, **kw), lambda *a: jax_slew_ref(*a, **kw),
               [x, np.float32(0.0)], [0, 1], seed=108)

    def loss(x):
        return (slew.slew_scan(x, torch.tensor(0.0), **kw)[0] ** 2).sum()

    _fd_check(loss, _t(x), [(200,), (260,)], eps=1e-4)


def _scan_np(T=300, P=128, seed=4):
    rng = np.random.default_rng(seed)
    mk = lambda lo, hi: rng.uniform(lo, hi, (T, P)).astype(np.float32)  # noqa: E731
    return [mk(0.8, 0.99), mk(-0.1, 0.1), mk(-0.1, 0.1), mk(0.8, 0.99), mk(-1, 1), mk(-1, 1)]


def test_affine_scan_grad_matches_jax_vjp_and_fd():
    """The kernel's plain version (chunk 128, as the JAX test's interpret
    call) against jax.vjp of the JAX package's affine_scan_2, the body of
    its custom VJP; with an entering state too."""
    planes = _scan_np()
    s0 = [np.linspace(-1, 1, 128).astype(np.float32), np.full(128, 0.5, np.float32)]

    def port(*a):
        return linrec_kernel.affine_scan_2_kernel(*a[:6], (a[6], a[7]), chunk=128)

    def ref(*a):
        return jax_affine_scan_2(*a[:6], s0=(a[6], a[7]))

    _check_vjp(port, ref, planes + s0, range(8), seed=106)
    a = [_t(p) for p in planes]

    def loss(u1):
        s1, s2 = linrec_kernel.affine_scan_2_kernel(*a[:4], u1, a[5], chunk=128)
        return (s1 ** 2).sum() + (s2 ** 2).sum()

    _fd_check(loss, a[4], [(7, 3), (290, 100)], eps=1e-2)


def test_reverse_echo_grad_matches_jax_vjp_and_fd():
    rng = np.random.default_rng(5)
    T, C, cap, plen = 400, 1, 96, 64
    sr = 8000.0
    x = rng.standard_normal((T, C)).astype(np.float32) * np.float32(0.5)
    blk = np.full((T,), 40.0 / sr, np.float32)
    ratio = np.full((T,), 1.5, np.float32)
    fb = np.full((T,), 0.4, np.float32)
    alt = np.ones((T,), np.float32)
    ba, bb = np.zeros((cap, C), np.float32), np.zeros((cap, C), np.float32)
    pb = np.zeros((plen, C), np.float32)
    misc = np.asarray([1, 0, 0.0, 0, 0, 40.0, 40, 0, 1], np.float32)
    kw = dict(sr=sr, plen=plen, cap=cap, min_block=8, max_block=cap - 1,
              smooth_alpha=1.0 / 240)
    args = [x, blk, ratio, fb, alt, ba, bb, pb, misc]
    # x, the pitch ratio (it moves the read heads), the feedback, the
    # buffers and the misc row's read position and smoothed length
    _check_vjp(lambda *a: reverse_echo.reverse_echo_scan(*a, **kw),
               lambda *a: jax_echo_ref(*a, **kw), args, [0, 2, 3, 5, 6, 7, 8], seed=107)
    t_args = [_t(v) for v in args]

    def loss(x):
        return (reverse_echo.reverse_echo_scan(x, *t_args[1:], **kw)[0] ** 2).sum()

    _fd_check(loss, t_args[0], [(5, 0), (150, 0)])


# ---- the scan's backward, in torch ops on the CPU ---------------------------


@pytest.mark.parametrize("shared,state", [(False, True), (True, True), (True, False)])
def test_affine_scan_adjoint_matches_autograd(shared, state):
    """affine_scan_2_bwd (the backward launch's planes: time-reversed,
    transposed, shifted; then gu, gA, gs0 in torch ops) on the plain
    version, against autograd of the plain forward."""
    rng = np.random.default_rng(40)
    T, C = 700, 6
    c = 1 if shared else C
    mk = lambda lo, hi, w: _t(rng.uniform(lo, hi, (T, w)).astype(np.float32))  # noqa: E731
    a = [mk(0.8, 0.99, c), mk(-0.1, 0.1, c), mk(-0.1, 0.1, c), mk(0.8, 0.99, c)]
    a = [m.expand(T, C) for m in a]
    u1, u2 = mk(-1, 1, C), mk(-1, 1, C)
    s0 = (_t(rng.standard_normal(C).astype(np.float32)),
          _t(rng.standard_normal(C).astype(np.float32))) if state else (None, None)
    s1, s2 = linrec_kernel.affine_scan_2_chunked_ref(*a, u1, u2, s0 if state else None,
                                                     chunk=256)
    g1, g2 = _t(rng.standard_normal((T, C)).astype(np.float32)), _t(
        rng.standard_normal((T, C)).astype(np.float32))
    got = linrec_kernel.affine_scan_2_bwd(*a, u1, u2, *s0, s1, s2, g1, g2, chunk=256)
    want = linrec_kernel.affine_scan_2_bwd_ref(*a, u1, u2, *s0, s1, s2, g1, g2, chunk=256)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert _rel(g, w) <= ORDER_TOL


# ---- the card's autograd glue, with the plain versions as its launches -----


def _glued(monkeypatch):
    """The ladder, the comb and the scan's wrappers as on the card: their
    launches torch.autograd.Functions (ops/diffable.py) with their
    backward glue, the plain versions standing in for the forward and the
    backward kernels. Returns the backward calls counted by name through
    ``diffable.on_backward``."""
    counts = {"ladder": 0, "comb": 0, "scan": 0}
    names = {"ladder_scan": "ladder", "comb_scan": "comb", "affine_scan_2": "scan"}

    def count(name, args, outs, grads, kw, got):
        assert len(got) == len(args)
        counts[names[name]] += 1

    monkeypatch.setattr(diffable, "on_backward", count)
    monkeypatch.setattr(
        ladder, "ladder_scan",
        diffable.kernel_function("ladder_scan", ladder.ladder_scan_ref, ladder._backward))
    monkeypatch.setattr(
        comb, "comb_scan",
        diffable.kernel_function("comb_scan", comb.comb_scan_ref, comb._backward))

    def scan_fwd(a11, a12, a21, a22, u1, u2, s01, s02, *, chunk):
        s0 = None if s01 is None else (s01, s02)
        return linrec_kernel.affine_scan_2_chunked_ref(a11, a12, a21, a22, u1, u2, s0,
                                                       chunk=chunk)

    scan = diffable.kernel_function("affine_scan_2", scan_fwd, linrec_kernel._backward)

    def kernel(a11, a12, a21, a22, u1, u2, s0=None, *, chunk):
        return scan(a11, a12, a21, a22, u1, u2, *(s0 or (None, None)), chunk=chunk)

    monkeypatch.setattr(linrec, "affine_scan_2_kernel", kernel)
    return counts


def _render_grads(graph, n, block, theta):
    binds = {k: torch.tensor(v, requires_grad=True) for k, v in theta.items()}
    out = engine.render_functional(graph, 0, n, block, binds, device="cpu")
    return torch.autograd.grad((out ** 2).mean(), list(binds.values()))


def test_card_glue_probe_matches_plain_autograd(monkeypatch):
    """The probe graph (ladder and comb, bench.py's gradient probe) at
    512 samples in blocks of 128: the glue's gradients, carried state
    cotangents across the blocks, equal autograd of the plain versions."""
    from pygmu2_tpu_torch import fit_workload

    graph = fit_workload.build_probe(pt, 512)
    theta = {"cutoff": 1500.0, "fb": 0.6}
    want = _render_grads(graph, 512, 128, theta)
    counts = _glued(monkeypatch)
    got = _render_grads(graph, 512, 128, theta)
    assert counts == {"ladder": 4, "comb": 4, "scan": 0}
    for g, w in zip(got, want):
        assert _rel(g, w) <= ORDER_TOL, (got, want)


def test_card_glue_filter_bank_matches_plain_autograd(monkeypatch):
    """The fit bank's BiquadPE and SVFilterPE at 8 channels, a 4096-sample
    block (the scan's kernel route), through the glue: the adjoint scan's
    gradients equal autograd of the plain chunked scan."""
    theta = {"low_hz": 1500.0, "band_hz": 800.0}
    want = _render_grads(_bank8(), 8192, 4096, theta)
    counts = _glued(monkeypatch)
    got = _render_grads(_bank8(), 8192, 4096, theta)
    assert counts["scan"] == 4  # two filters, two blocks
    for g, w in zip(got, want):
        assert _rel(g, w) <= ORDER_TOL, (got, want)


def _bank8():
    from pygmu2_tpu_torch import fit_workload, patch_workload

    pt.set_sample_rate(44100)
    saws = pt.ArrayPE(patch_workload.detuned_saws(8192, 0, channels=8))
    low = pt.BiquadPE(saws, fit_workload._swept_around(pt, pt.ParamPE("low_hz"), 0.25, 1200.0),
                      4.0, mode=pt.BiquadMode.LOWPASS)
    band = pt.SVFilterPE(low, fit_workload._swept_around(pt, pt.ParamPE("band_hz"), 0.4, 500.0),
                         2.0, mode=pt.BiquadMode.BANDPASS)
    return pt.CropPE(pt.GainPE(band, 0.5), 0, 8192)


def test_backward_without_kernel_raises():
    """A kernel whose backward is not ported raises when its gradient is
    asked for (NotImplementedError naming it and ROADMAP), and a call that
    needs no gradient is the launch alone."""
    calls = []

    def launch(x, y):
        calls.append(1)
        return x * y, (x + y).to(torch.int32)

    fn = diffable.kernel_function("envelope_ar_scan", launch)
    x, y = torch.ones(3), torch.full((3,), 2.0)
    out = fn(x, y)
    assert out[0].grad_fn is None and len(calls) == 1
    xg = x.clone().requires_grad_()
    out = fn(xg, y)
    assert out[0].grad_fn is not None and not out[1].requires_grad
    with pytest.raises(NotImplementedError, match="envelope_ar_scan.*ROADMAP"):
        out[0].sum().backward()


if __name__ == "__main__":
    # ``python tests/test_torch_autodiff.py`` prints the observed maxima: the
    # checks record their relative errors as they assert
    jax.config.update("jax_platforms", "cpu")
    seen = []
    check_vjp, rel = _check_vjp, _rel

    def _check_vjp(*args, **kw):  # noqa: F811
        errs = check_vjp(*args, **kw)
        seen.extend(errs)
        return errs

    def _rel(got, want):  # noqa: F811
        seen.append(rel(got, want))
        return seen[-1]

    def run(label, fn, *cases):
        seen.clear()
        for case in cases or [()]:
            fn(*case)
        print(f"{label}: {max(seen):.3g}")

    for name, got, want in _xla_math_gradients():
        print(f"xla_math {name} vs jax.grad: {np.abs(got - want).max():.3g} abs, "
              f"{(np.abs(got - want) / np.abs(want)).max():.3g} rel")
    for name in ("ladder", "comb", "ks", "ks_blocked", "adsr_state", "envelope",
                 "affine_scan", "reverse_echo"):
        fn = next(v for k, v in globals().items()
                  if k.startswith(f"test_{name}_grad_matches"))
        run(f"{name} vs jax.vjp (of the largest cotangent)", fn)
    run("slew vs jax.vjp (of the largest cotangent)", test_slew_grad_matches_jax_vjp_and_fd,
        (True,), (False,))
    run("scan adjoint vs autograd", test_affine_scan_adjoint_matches_autograd,
        (False, True), (True, True), (True, False))
