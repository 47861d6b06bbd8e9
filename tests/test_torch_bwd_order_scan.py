"""PyTorch port: the order-2 scan's and the envelope follower's backward in
their kernels' order.

``ops/linrec_kernel.affine_scan_2_bwd`` on the CPU (its plain version,
``affine_scan_2_bwd_plain``: the order of the adjoint launch of
``csrc/affine_scan_2.cu``, the adjoint scan on the reversed, transposed,
shifted planes, the products rounded alone, a (T, 1) plane's cotangent
summed over the channels tile by tile) and
``ops/envelope.envelope_ar_scan_bwd_chunked`` (the order of
``csrc/order1_grid.cuh``: 256-sample chunks of segments composed in the
kernel's grouping) on seeded inputs and cotangents, each against two
references: the port's plain adjoint (``affine_scan_2_bwd_ref``, autograd
of the plain chunked scan; ``envelope_ar_scan_bwd_ref``, the serial walk)
and ``jax.vjp`` of the JAX package's function (``linrec.affine_scan_2``,
the body of ``affine_scan_2_pallas``'s custom VJP; ``envelope_ar_pallas``
in interpret mode).

Tolerance: 1e-5 of the largest cotangent, the scan's of each output, the
follower's of the call (a C = 1 call's genv0 is one number that can
cancel to near zero: its own size is no scale; float32 sums in other
orders, observed maxima in CHANGES.md). A column's channel sum is held to
the declared order bit for bit. The kernels themselves are held to these
orders bit for bit on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 15 and 16). ``PYTHONPATH=. python
tests/test_torch_bwd_order_scan.py`` prints the observed maxima.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygmu2_tpu.ops.envelope_pallas import envelope_ar_pallas
from pygmu2_tpu.ops.linrec import affine_scan_2 as jax_affine_scan_2
from pygmu2_tpu_torch.ops import envelope, linrec_kernel

torch.set_num_threads(1)

TOL = 1e-5
SCAN_CHUNK = 32
SCAN_T = 3 * SCAN_CHUNK + 13  # a few chunks and a ragged tail


def _rel(got, want, scale=None) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if scale is None:
        scale = np.abs(want).max()
    return float(np.abs(got - want).max() / max(scale, 1e-30))


# ---- the order-2 scan ----


def _scan_np(C, shared, state, seed):
    rng = np.random.default_rng(seed)
    T, w = SCAN_T, 1 if shared else C

    def u(lo, hi, *s):
        return rng.uniform(lo, hi, s).astype(np.float32)

    a = [u(0.8, 0.99, T, w), u(-0.1, 0.1, T, w), u(-0.1, 0.1, T, w), u(0.8, 0.99, T, w)]
    s0 = [u(-1, 1, C), u(-1, 1, C)] if state else None
    return a, [u(-1, 1, T, C), u(-1, 1, T, C)], s0, [u(-1, 1, T, C), u(-1, 1, T, C)]


def scan_errors(C, shared, state, seed=0):
    """(errors against the plain adjoint, against jax.vjp), each output's
    error over its largest cotangent."""
    a, u, s0, g = _scan_np(C, shared, state, seed)
    ta, tu, tg = ([torch.from_numpy(v) for v in vs] for vs in (a, u, g))
    ts0 = [torch.from_numpy(v) for v in s0] if state else None
    s1, s2 = linrec_kernel.affine_scan_2_chunked_ref(*ta, *tu, ts0, chunk=SCAN_CHUNK)
    args = (*ta, *tu, *(ts0 or (None, None)), s1, s2, *tg)
    got = linrec_kernel.affine_scan_2_bwd(*args, chunk=SCAN_CHUNK)
    want = linrec_kernel.affine_scan_2_bwd_ref(*args, chunk=SCAN_CHUNK)
    primals = [jnp.asarray(v) for v in (*a, *u, *(s0 or ()))]
    n = len(primals)

    @jax.jit
    def jax_vjp(p, ct):
        return jax.vjp(lambda *q: jax_affine_scan_2(*q[:6], s0=(q[6], q[7]) if n == 8 else None),
                       *p)[1](ct)

    want_jax = jax_vjp(primals, (jnp.asarray(g[0]), jnp.asarray(g[1])))
    got = [v for v in got if v is not None]
    want = [v for v in want if v is not None]
    assert [tuple(v.shape) for v in got] == [tuple(v.shape) for v in want]
    assert [tuple(v.shape) for v in got] == [tuple(v.shape) for v in want_jax]
    return ([_rel(p, q) for p, q in zip(got, want)],
            [_rel(p, q) for p, q in zip(got, want_jax)])


@pytest.mark.parametrize("C", [1, 8, 12])
@pytest.mark.parametrize("shared,state", [(True, True), (True, False), (False, True),
                                          (False, False)],
                         ids=["shared_s0", "shared", "full_s0", "full"])
def test_scan_backward_order_matches_autograd_and_jax(C, shared, state):
    """The plain version of the scan's backward (the kernel's order) on
    shared (T, 1) or full planes, with and without an entering state,
    against autograd of the plain chunked scan and jax.vjp of the JAX
    package's affine_scan_2, at T three chunks and a ragged tail."""
    plain, jx = scan_errors(C, shared, state, seed=C)
    assert max(plain) <= TOL, plain
    assert max(jx) <= TOL, jx


def _declared_sum(v, width):
    """The declared channel sum, spelled out: each tile of ``width``
    channels added in channel order from zero, then the tiles in tile order
    from zero."""
    T, C = v.shape
    total = torch.zeros(T)
    for c0 in range(0, C, width):
        part = torch.zeros(T)
        for c in range(c0, min(C, c0 + width)):
            part = part + v[:, c]
        total = total + part
    return total[:, None]


@pytest.mark.parametrize("C,shared", [(12, True), (12, False), (5, True)],
                         ids=["four_shared", "one_shared", "four_shared_C5"])
def test_scan_backward_column_is_the_declared_channel_sum(C, shared):
    """A (T, 1) plane's cotangent is its full plane's cotangent (the same
    call with the plane expanded along the channels) summed in the declared
    order, bit for bit: tiles of 8 channels where the four matrix planes
    are shared, else 4. With ``shared`` False only a12 is a column."""
    a, u, s0, g = _scan_np(C, True, True, seed=30 + C)
    if not shared:  # full a11, a21, a22
        a = [v if i == 1 else np.repeat(v, C, 1) for i, v in enumerate(a)]
    ta = [torch.from_numpy(v) for v in a]
    tu, tg, ts0 = ([torch.from_numpy(v) for v in vs] for vs in (u, g, s0))
    s1, s2 = linrec_kernel.affine_scan_2_chunked_ref(*ta, *tu, ts0, chunk=SCAN_CHUNK)
    rest = (*tu, *ts0, s1, s2, *tg)
    cols = linrec_kernel.affine_scan_2_bwd(*ta, *rest, chunk=SCAN_CHUNK)
    full = linrec_kernel.affine_scan_2_bwd(*(p.expand(SCAN_T, C) for p in ta), *rest,
                                           chunk=SCAN_CHUNK)
    width = 8 if shared else 4
    for i in range(4):
        if ta[i].shape[1] == 1:
            assert cols[i].shape == (SCAN_T, 1)
            assert torch.equal(cols[i], _declared_sum(full[i], width)), i
        else:
            assert torch.equal(cols[i], full[i]), i
    for i in range(4, 8):
        assert torch.equal(cols[i], full[i]), i


# ---- the envelope follower ----

FOLLOWER_KW = dict(atk=0.05, rel=0.002)
# T across several 256-sample chunks with a ragged tail; rows where x equals
# the envelope before it (a tie takes rel)
FOLLOWER_T = 3 * 256 + 77
TIES = (0, 1, 255, 256, 300, 511, 700)


def _follower_np(C, seed):
    """x with ties at TIES, env0, the forward's env; cotangents g, g_final."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.uniform(-1, 1, (FOLLOWER_T, C))).astype(np.float32)
    env0 = np.abs(rng.uniform(-1, 1, C)).astype(np.float32)
    env = None
    for t in TIES:  # each tie set on the envelope of the x before it
        env = envelope.envelope_ar_scan_ref(torch.from_numpy(x), torch.from_numpy(env0),
                                            **FOLLOWER_KW)[0].numpy()
        x[t] = env0 if t == 0 else env[t - 1]
    env = envelope.envelope_ar_scan_ref(torch.from_numpy(x), torch.from_numpy(env0),
                                        **FOLLOWER_KW)[0].numpy()
    for t in TIES:
        assert np.array_equal(x[t], env0 if t == 0 else env[t - 1])
    g = rng.uniform(-1, 1, (FOLLOWER_T, C)).astype(np.float32)
    return x, env0, env, g, rng.uniform(-1, 1, C).astype(np.float32)


def follower_errors(C, seed=0):
    """(errors against the serial plain adjoint, against jax.vjp), each
    over the call's largest cotangent."""
    x, env0, env, g, gf = _follower_np(C, seed)
    args = [torch.from_numpy(v) for v in (x, env0, env, g, gf)]
    got = envelope.envelope_ar_scan_bwd_chunked(*args, **FOLLOWER_KW)
    want = envelope.envelope_ar_scan_bwd_ref(*args, **FOLLOWER_KW)
    _, vjp = jax.vjp(lambda a, b: envelope_ar_pallas(a, b, **FOLLOWER_KW, interpret=True),
                     jnp.asarray(x), jnp.asarray(env0))
    want_jax = vjp((jnp.asarray(g), jnp.asarray(gf)))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    return ([_rel(p, q, scale) for p, q in zip(got, want)],
            [_rel(p, q, scale) for p, q in zip(got, want_jax)])


@pytest.mark.parametrize("C", [1, 8])
def test_follower_backward_order_matches_serial_and_jax(C):
    """The follower's backward in the kernel's order at C = 1 and 8, T
    across three chunks and a ragged tail, ties x == env_{t-1} at chunk and
    segment edges, against the serial plain adjoint and jax.vjp of
    envelope_ar_pallas in interpret mode."""
    plain, jx = follower_errors(C, seed=C)
    assert max(plain) <= TOL, plain
    assert max(jx) <= TOL, jx


if __name__ == "__main__":
    for C in (1, 8, 12):
        for shared, state in ((True, True), (True, False), (False, True), (False, False)):
            plain, jx = scan_errors(C, shared, state, seed=C)
            print(f"scan C={C} shared={shared} s0={state}: plain {max(plain):.3g}, "
                  f"jax {max(jx):.3g}")
    for C in (1, 8):
        plain, jx = follower_errors(C, seed=C)
        print(f"follower C={C}: plain {max(plain):.3g}, jax {max(jx):.3g}")
