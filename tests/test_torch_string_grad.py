"""PyTorch port, the Karplus-Strong string's gradient.

The string's hand-written adjoint (``ops/ks.ks_scan_bwd_ref``, the
backward kernel's order and roundings; ``ks_blocked_bwd_ref`` for the
all-active order, the same adjoint at every sample active) against
autograd of the plain forwards (``ks_scan_ref``, ``ks_blocked_ref``) and
against ``jax.vjp`` of the JAX package's references (its ``ks_scan_ref``,
the custom VJP's backward of ``ks_scan_pallas``, and ``ks_blocked``, which
XLA differentiates natively), at strings of 3 to 535 samples with
inactive heads, gaps and carried state. Then the string fit of
``fit_workload`` (``render_string``: the first block per sample with its
pre-t0 rows, the later blocks in the blocked order, the state's
cotangents crossing the blocks) against ``jax.grad`` of the same blocks
through the JAX references, and through the card's autograd glue
(``ops/diffable.py``) with the plain versions standing in for the
launches, under ``torch.func.vmap`` too. The backward kernel itself is
held to ``ks_scan_bwd_ref`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 17).

Tolerances: against autograd and ``jax.vjp`` 1e-5 of the largest
cotangent of each input (float32 recurrences summed in other orders);
the fit's gradient against ``jax.grad`` 1e-5 relative; the glue against
autograd of the plain versions 1e-5 relative. ``python
tests/test_torch_string_grad.py`` prints the observed maxima.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from pygmu2_tpu.ops.ks_block import ks_blocked as jax_ks_blocked
from pygmu2_tpu.ops.ks_pallas import ks_scan_ref as jax_ks_ref
from pygmu2_tpu_torch import fit_workload as fw
from pygmu2_tpu_torch.ops import diffable, ks

torch.set_num_threads(1)

TOL = 1e-5
C_AP = 0.35


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _case(L, T, head, gaps, seed, r0=None):
    """Seeded forward arguments (numpy) and cotangents of its outputs."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.95, 0.999, T).astype(np.float32)
    act = np.arange(T) >= head
    if gaps:
        act[T // 3:T // 3 + 20] = False
    buf = rng.standard_normal(L).astype(np.float32)
    r = np.int32(rng.integers(L) if r0 is None else r0)
    ai, ao = np.float32(0.1), np.float32(-0.2)
    cts = [rng.standard_normal(T).astype(np.float32), rng.standard_normal(L).astype(np.float32),
           np.float32(rng.standard_normal()), np.float32(rng.standard_normal())]
    return [rho, act, buf, r, ai, ao], cts


def _torch(a):
    return torch.from_numpy(np.array(a))


def _hand(args, cts, blocked):
    rho, act, buf, r, _, _ = map(_torch, args)
    y = ks.ks_scan_ref(rho, act, buf, r, *map(_torch, args[4:]), L=buf.shape[0],
                       allpass_c=C_AP, all_active=blocked)[0]
    gy, gbuf, gai, gao = map(_torch, cts)
    kw = dict(L=buf.shape[0], allpass_c=C_AP)
    if blocked:
        return ks.ks_blocked_bwd_ref(rho, buf, r, y, gy, gbuf, gai, gao, **kw)
    return ks.ks_scan_bwd_ref(rho, act, buf, r, y, gy, gbuf, gai, gao, **kw)


def _autograd(args, cts, blocked):
    rho, act, buf, r, ai, ao = map(_torch, args)
    ins = [t.clone().requires_grad_() for t in (rho, buf, ai, ao)]
    y, buf2, _, ai2, ao2 = ks.ks_scan_ref(ins[0], act, ins[1], r, ins[2], ins[3],
                                          L=buf.shape[0], allpass_c=C_AP, all_active=blocked)
    return torch.autograd.grad((y, buf2, ai2, ao2), ins, tuple(map(_torch, cts)))


def _jax_vjp(args, cts, blocked):
    rho, act, buf, r, ai, ao = args
    L = buf.shape[0]

    def f(rho, buf, ai, ao):
        if blocked:
            y, b2, _, ai2, ao2 = jax_ks_blocked(rho, buf, r, ai, ao, L=L, allpass_c=C_AP)
        else:
            y, b2, _, ai2, ao2 = jax_ks_ref(rho, act, buf, r, ai, ao, L=L, allpass_c=C_AP)
        return y, b2, ai2, ao2

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (rho, buf, ai, ao)))
    return vjp(tuple(jnp.asarray(c) for c in cts))


PER_SAMPLE = [  # L, T, head, gaps, carried read position
    (3, 300, 10, True, 1), (9, 400, 0, False, 5), (83, 500, 10, True, 40),
    (160, 700, 37, False, 0), (83, 60, 10, False, 3),
]
BLOCKED = [(16, 300), (160, 400), (535, 1200), (160, 100)]


@pytest.mark.parametrize("L,T,head,gaps,r0", PER_SAMPLE)
def test_per_sample_adjoint_matches_autograd_and_jax(L, T, head, gaps, r0):
    args, cts = _case(L, T, head, gaps, L + T, r0)
    got = _hand(args, cts, False)
    for want in (_autograd(args, cts, False), _jax_vjp(args, cts, False)):
        errs = [_rel(g, w) for g, w in zip(got, want)]
        assert max(errs) <= TOL, errs
    assert (got[0].numpy()[~args[1]] == 0.0).all()  # inactive samples: no gradient


@pytest.mark.parametrize("L,T", BLOCKED)
def test_blocked_adjoint_matches_autograd_and_jax(L, T):
    """The blocked order's adjoint is the per-sample one at every sample
    active (one backward kernel for both orders): within 1e-5 of autograd
    of ks_blocked_ref and of jax.vjp of the JAX package's ks_blocked."""
    args, cts = _case(L, T, 0, False, L + T)
    got = _hand(args, cts, True)
    for want in (_autograd(args, cts, True), _jax_vjp(args, cts, True)):
        errs = [_rel(g, w) for g, w in zip(got, want)]
        assert max(errs) <= TOL, errs


def test_adjoint_of_an_idle_call_passes_the_state():
    """No active sample: the string's and the allpass state's cotangents
    pass through, rho gets none."""
    args, cts = _case(40, 50, 50, False, 3)
    grho, gbuf, gai, gao = _hand(args, cts, False)
    assert (grho == 0).all() and float(gai) == cts[2] and float(gao) == cts[3]
    np.testing.assert_array_equal(gbuf.numpy(), cts[1])


# ---- the string fit ---------------------------------------------------------

FIT_N, FIT_BLOCK = 4 * 512 - fw.STRING_HEAD, 512  # four blocks of 512


def _jax_render(exc, rho, n, block, c, head):
    L = exc.shape[0]
    buf, r = exc, jnp.int32(0)
    ai = ao = jnp.float32(0.0)
    outs = []
    for b0 in range(-head, n, block):
        T = min(block, n - b0)
        rho_t = jnp.broadcast_to(rho, (T,))
        if b0 >= 0:
            y, buf, r, ai, ao = jax_ks_blocked(rho_t, buf, r, ai, ao, L=L, allpass_c=c)
        else:
            act = jnp.arange(b0, b0 + T) >= 0
            y, buf, r, ai, ao = jax_ks_ref(rho_t, act, buf, r, ai, ao, L=L, allpass_c=c)
        outs.append(y)
    return jnp.concatenate(outs)[head:]


def _fit_inputs():
    L, c = fw.string_shape()
    hidden = fw.string_excitation(L, fw.STRING_HIDDEN["seed"])
    start = fw.string_excitation(L, fw.STRING_START["seed"])
    return L, c, hidden, start


def _port_fit_grads(start, target, c, rho=0.999):
    exc = torch.from_numpy(start).requires_grad_()
    r = torch.tensor(rho, requires_grad=True)
    out = fw.render_string(exc, r, FIT_N, FIT_BLOCK, allpass_c=c)
    loss = torch.mean((out - target) ** 2)
    return [g.numpy() for g in torch.autograd.grad(loss, [exc, r])]


def test_string_fit_grad_matches_jax():
    """The fit's loss gradient, four blocks of 512 from t = -64, against
    jax.grad through the JAX package's ks_scan_ref and ks_blocked."""
    L, c, hidden, start = _fit_inputs()
    target = fw.render_string(torch.from_numpy(hidden), torch.tensor(0.996), FIT_N, FIT_BLOCK,
                              allpass_c=c)
    got = _port_fit_grads(start, target, c)
    jt = jnp.asarray(target.numpy())

    def loss(exc, rho):
        return jnp.mean((_jax_render(exc, rho, FIT_N, FIT_BLOCK, c, fw.STRING_HEAD) - jt) ** 2)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(start), jnp.float32(0.999))
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= TOL, errs


def _glued(monkeypatch):
    """ks_scan as on the card: its two launches torch.autograd.Functions
    (ops/diffable.py) with their backward glue and vmap rules, the plain
    versions standing in for the forward kernels and ks_scan_bwd's plain
    version for the backward kernel. Returns the backward calls counted."""
    counts = {"ks_scan": 0, "ks_scan (blocked)": 0}

    def count(name, args, outs, grads, kw, got):
        assert len(got) == len(args)
        counts[name] += 1

    monkeypatch.setattr(diffable, "on_backward", count)
    per = diffable.kernel_function("ks_scan", ks.ks_scan_ref, ks._backward)
    blocked = diffable.kernel_function("ks_scan (blocked)", ks.ks_blocked_ref,
                                       ks._backward_blocked)

    def glued(rho, act, buf, r, ap_in, ap_out, *, L, allpass_c, all_active=False):
        if all_active and L >= ks.BLOCKED_MIN_L:
            return blocked(rho, buf, r, ap_in, ap_out, L=L, allpass_c=allpass_c)
        return per(rho, act, buf, r, ap_in, ap_out, L=L, allpass_c=allpass_c)

    monkeypatch.setattr(ks, "ks_scan", glued)
    return counts


def test_card_glue_string_fit_matches_plain_autograd(monkeypatch):
    """The fit's gradient through the glue (both orders' backward, the
    state's cotangents carried across four blocks) equals autograd of the
    plain versions."""
    L, c, hidden, start = _fit_inputs()
    target = fw.render_string(torch.from_numpy(hidden), torch.tensor(0.996), FIT_N, FIT_BLOCK,
                              allpass_c=c)
    want = _port_fit_grads(start, target, c)
    counts = _glued(monkeypatch)
    got = _port_fit_grads(start, target, c)
    assert counts == {"ks_scan": 1, "ks_scan (blocked)": 3}
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= TOL, errs


@pytest.mark.parametrize("glue", [False, True], ids=["plain", "glued"])
def test_string_render_under_vmap(monkeypatch, glue):
    """torch.func.vmap of the string's render over three rho candidates
    equals the loop of renders; the summed loss's gradient gives each
    candidate's, and so does vmap(grad): through the plain versions, and
    through the glue (the string has no channel axis: one launch per
    member, its backward per member)."""
    L, c, hidden, start = _fit_inputs()
    exc = torch.from_numpy(start)
    rhos = torch.tensor([0.99, 0.996, 0.999])
    n, block = 600, 256
    counts = _glued(monkeypatch) if glue else None

    def loss(rho):
        return torch.mean(fw.render_string(exc, rho, n, block, allpass_c=c) ** 2)

    out = vmap(lambda r: fw.render_string(exc, r, n, block, allpass_c=c))(rhos)
    loop = torch.stack([fw.render_string(exc, r, n, block, allpass_c=c) for r in rhos])
    assert float((out - loop).abs().max()) <= 1e-6
    want = torch.stack([grad(loss)(r) for r in rhos])
    rg = rhos.clone().requires_grad_()
    (summed,) = torch.autograd.grad(vmap(loss)(rg).sum(), [rg])
    assert _rel(summed, want) <= TOL
    assert _rel(vmap(grad(loss))(rhos), want) <= TOL
    if glue:
        assert counts["ks_scan"] > 0 and counts["ks_scan (blocked)"] > 0


def test_fit_string_lowers_the_loss():
    """fit_workload.fit_string at four blocks of 512: three Adam steps from
    the start excitation and rho towards the hidden ones."""
    L, c, hidden, start = _fit_inputs()
    target = fw.render_string(torch.from_numpy(hidden), torch.tensor(fw.STRING_HIDDEN["rho"]),
                              FIT_N, FIT_BLOCK, allpass_c=c)
    losses, rho, exc = fw.fit_string(target, start, fw.STRING_START["rho"], 3, 0.05,
                                     block=FIT_BLOCK, allpass_c=c, device="cpu")
    assert losses[-1] < losses[0] and exc.shape == (L,) and 0.0 < rho < 1.0


if __name__ == "__main__":
    # ``python tests/test_torch_string_grad.py`` prints the observed maxima
    jax.config.update("jax_platforms", "cpu")
    for L, T, head, gaps, r0 in PER_SAMPLE:
        args, cts = _case(L, T, head, gaps, L + T, r0)
        got = _hand(args, cts, False)
        print(f"per sample L={L}: vs autograd "
              f"{max(_rel(g, w) for g, w in zip(got, _autograd(args, cts, False))):.3g}, "
              f"vs jax.vjp {max(_rel(g, w) for g, w in zip(got, _jax_vjp(args, cts, False))):.3g}")
    for L, T in BLOCKED:
        args, cts = _case(L, T, 0, False, L + T)
        got = _hand(args, cts, True)
        print(f"blocked L={L}: vs autograd "
              f"{max(_rel(g, w) for g, w in zip(got, _autograd(args, cts, True))):.3g}, "
              f"vs jax.vjp {max(_rel(g, w) for g, w in zip(got, _jax_vjp(args, cts, True))):.3g}")
