"""PyTorch port, training through the effects chain: the backward of the
follower, the slew limiter, the reverse echo and the ADSR.

- Whole renders: ``engine.render_functional`` of the fit chain, the fit fx
  bank and the ADSR probe (``fit_workload.py``) with their ParamPEs
  bound, gradients against ``jax.grad`` of the JAX package's render of the
  same graph (its kernels' ``lax.scan`` references on the CPU), within 1e-3
  relative. The feedback reaches the output two echo blocks in (0.6 s), so
  at 4096 samples its gradient is zero in both packages; with the echo's
  blocks shortened (``fx_workload.ECHO_BLOCK_S``) it is not.
- The plain adjoints (``*_bwd_ref``: the backward kernels' order in torch
  ops) against autograd of the forward plain versions, with entering state
  and cotangents on the state out, on seeded shapes, and across a block
  edge (two calls, the state's cotangent handed back from the second).
- The card's autograd glue (``ops/diffable.py``) with the plain versions as
  its launches (the echo's updating its rings in place, as the kernel
  does), against autograd of the plain versions, counting the backward
  calls through ``diffable.on_backward``.

The backward kernels themselves are held to the plain adjoints on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 16). ``python
tests/test_torch_fit_chain.py`` prints the observed maxima.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygmu2_tpu as pg
import pygmu2_tpu_torch as pt
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu_torch import fit_workload as fw
from pygmu2_tpu_torch import fx_workload
from pygmu2_tpu_torch.core import engine
from pygmu2_tpu_torch.ops import adsr, diffable, envelope, reverse_echo, slew

torch.set_num_threads(1)

SR = 44100
GRAD_TOL = 1e-3  # relative: the port's whole-render gradients against jax.grad's
ADJ_TOL = 1e-5  # of the largest cotangent: plain adjoints against autograd


@pytest.fixture(autouse=True)
def _port_sample_rate():
    pt.set_sample_rate(SR)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale > 0 else float(np.abs(got).max())


# ---- whole renders against jax.grad ----

GRAPHS = {  # name: (its graph from a package, n, block, theta, the echo block in seconds)
    "chain": (lambda p: fw.build_fit_chain(p, 4096 / SR), 4096, 1024,
              {"depth": 2500.0, "fb": 0.6}, 0.3),
    "fx_bank": (lambda p: fw.build_fit_fx_bank(p, 2048 / SR, channels=8), 2048, 1024,
                {"drive": 1.0, "fb": 0.6}, 0.3),
    "chain_short_echo": (lambda p: fw.build_fit_chain(p, 4096 / SR), 4096, 1024,
                         {"depth": 2500.0, "fb": 0.6}, 0.02),
    "fx_bank_short_echo": (lambda p: fw.build_fit_fx_bank(p, 2048 / SR, channels=8), 2048,
                           512, {"drive": 1.0, "fb": 0.6}, 0.01),
    "adsr_probe": (lambda p: fw.build_adsr_probe(p, 4096), 4096, 1024, {"g": 1.0}, 0.3),
}


def _port_grads(graph, n, block, theta):
    binds = {k: torch.tensor(v, requires_grad=True) for k, v in theta.items()}
    out = engine.render_functional(graph, 0, n, block, binds, device="cpu")
    loss = (out ** 2).mean()
    grads = torch.autograd.grad(loss, list(binds.values()), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {k: float(g) for k, g in zip(binds, grads)}


def _jax_grads(graph, n, block, theta):
    def loss(b):
        return jnp.mean(jengine.render_functional(graph, 0, n, block, b) ** 2)

    v, g = jax.value_and_grad(loss)({k: jnp.float32(x) for k, x in theta.items()})
    return float(v), {k: float(x) for k, x in g.items()}


def _whole(which, monkeypatch):
    build, n, block, theta, echo_block = GRAPHS[which]
    monkeypatch.setattr(fx_workload, "ECHO_BLOCK_S", echo_block)
    v, got = _port_grads(build(pt), n, block, theta)
    jv, want = _jax_grads(build(pg), n, block, theta)
    return v, jv, got, want


@pytest.mark.parametrize("which", list(GRAPHS))
def test_fit_graph_gradient_matches_jax(which, monkeypatch):
    """The echo's feedback reaches the output only once a block written
    under it is replayed, two echo blocks in: past 0.6 s at the chain's
    0.3 s blocks, so the feedback's gradient is zero at 4096 samples; with
    short echo blocks it is not."""
    v, jv, got, want = _whole(which, monkeypatch)
    assert abs(v - jv) <= 1e-5 * abs(jv)
    for k in want:
        assert abs(got[k] - want[k]) <= GRAD_TOL * abs(want[k]), (k, got, want)
    if which == "adsr_probe":  # the gate enters only through compares
        assert got == want == {"g": 0.0}
    elif which.endswith("short_echo"):
        assert all(g != 0.0 for g in got.values())
    else:
        assert got["fb"] == want["fb"] == 0.0


# ---- the plain adjoints against autograd of the plain forwards ----


def _autograd(fn, args, diff, cts):
    ins = [a.detach().clone().requires_grad_() if i in diff else a for i, a in enumerate(args)]
    outs = fn(*ins)
    pairs = [(o, c) for o, c in zip(outs, cts) if c is not None and o.requires_grad]
    return torch.autograd.grad([o for o, _ in pairs], [ins[i] for i in diff],
                               [c for _, c in pairs], allow_unused=True,
                               materialize_grads=True)


def _seeded(rng, *shapes, lo=-1.0, hi=1.0):
    return [torch.from_numpy(rng.uniform(lo, hi, s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("T,C,seed", [(300, 1, 0), (257, 3, 1), (64, 8, 2), (1, 2, 3)])
def test_envelope_adjoint_matches_autograd(T, C, seed):
    rng = np.random.default_rng(seed)
    x, e0, g, gf = _seeded(rng, (T, C), (C,), (T, C), (C,))
    x, e0 = x.abs(), e0.abs()
    kw = dict(atk=0.05, rel=0.002)
    env, _ = envelope.envelope_ar_scan_ref(x, e0, **kw)
    got = envelope.envelope_ar_scan_bwd_ref(x, e0, env, g, gf, **kw)
    want = _autograd(lambda *a: envelope.envelope_ar_scan_ref(*a, **kw), [x, e0], [0, 1],
                     [g, gf])
    for a, b in zip(got, want):
        assert _rel(a, b) <= ADJ_TOL


def _slew_input(T, seed):
    """Steps the limiter climbs in exact quarters (ties at the limit), then
    noise."""
    rng = np.random.default_rng(seed)
    x = np.where(np.arange(T) % 40 < 20, 1.0, 0.0)
    x[T // 2:] += rng.uniform(-0.3, 0.3, T - T // 2)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "exponential"])
@pytest.mark.parametrize("T,seed", [(200, 0), (333, 1), (17, 2)])
def test_slew_adjoint_matches_autograd(linear, T, seed):
    rng = np.random.default_rng(seed + 10)
    x = _slew_input(T, seed)
    c0 = torch.tensor(0.0)
    g, gc = _seeded(rng, (T,), ())
    kw = dict(linear=linear, p_rise=0.25 if linear else 0.2, p_fall=0.125 if linear else 0.05)
    y, _ = slew.slew_scan_ref(x, c0, **kw)
    got = slew.slew_scan_bwd_ref(x, c0, y, g, gc, **kw)
    want = _autograd(lambda *a: slew.slew_scan_ref(*a, **kw), [x, c0], [0, 1], [g, gc])
    for a, b in zip(got, want):
        assert _rel(a, b) <= ADJ_TOL


def _echo_args(T, C, seed, ratio, alt):
    rng = np.random.default_rng(seed)
    cap, plen, sr = 96, 64, 8000.0
    x, ba, bb, pb = _seeded(rng, (T, C), (cap, C), (cap, C), (plen, C))
    fb = torch.from_numpy(rng.uniform(0.2, 0.6, T).astype(np.float32))
    r = (torch.from_numpy(rng.uniform(0.7, 1.6, T).astype(np.float32)) if ratio == "mod"
         else torch.full((T,), ratio))
    blk = torch.full((T,), 40.0 / sr)
    blk[T // 2:] = 25.0 / sr
    misc = torch.tensor([1, 3, 5.5, 10, 10, 40.0, 40, 40, 1])
    kw = dict(sr=sr, plen=plen, cap=cap, min_block=8, max_block=cap - 1,
              smooth_alpha=1.0 / 240)
    return [x, blk, r, fb, torch.full((T,), alt), ba, bb, pb, misc], kw


ECHO_DIFF = [0, 2, 3, 5, 6, 7, 8]  # x, ratio, fb, the rings, the pitch line, misc


def _echo_bwd_ref(args, y, cts, kw):
    x, blk, r, fb, alt, _, _, pb, misc = args
    return reverse_echo.reverse_echo_scan_bwd_ref(x, blk, r, fb, alt, pb, misc, y, *cts, **kw)


@pytest.mark.parametrize("T,C,seed,ratio,alt", [(400, 1, 0, 1.5, 1.0), (301, 2, 1, "mod", 0.0),
                                                (200, 3, 2, 1.0, 1.0), (150, 1, 3, 0.75, 0.0)])
def test_reverse_echo_adjoint_matches_autograd(T, C, seed, ratio, alt):
    args, kw = _echo_args(T, C, seed, ratio, alt)
    y, *outs = reverse_echo.reverse_echo_scan_ref(*args, **kw)
    rng = np.random.default_rng(seed + 20)
    cts = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           for o in (y, *outs)]
    got = _echo_bwd_ref(args, y, cts, kw)
    want = _autograd(lambda *a: reverse_echo.reverse_echo_scan_ref(*a, **kw), args, ECHO_DIFF,
                     cts)
    for a, b in zip(got, want):
        assert _rel(a, b) <= ADJ_TOL


def test_reverse_echo_adjoint_across_a_block_edge():
    """Two calls, the second from the first's state: the second's backward
    hands the rings', the pitch line's and misc's cotangents to the
    first's; the result equals autograd through both plain calls."""
    args, kw = _echo_args(300, 2, 5, "mod", 1.0)
    cut = 130
    x, blk, r, fb, alt, ba, bb, pb, misc = args
    rng = np.random.default_rng(6)
    y1, ba1, bb1, pb1, m1 = reverse_echo.reverse_echo_scan_ref(
        x[:cut], blk[:cut], r[:cut], fb[:cut], alt[:cut], ba, bb, pb, misc, **kw)
    y2, *outs2 = reverse_echo.reverse_echo_scan_ref(
        x[cut:], blk[cut:], r[cut:], fb[cut:], alt[cut:], ba1, bb1, pb1, m1, **kw)
    cts2 = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
            for o in (y2, *outs2)]
    g1 = torch.from_numpy(rng.standard_normal(y1.shape).astype(np.float32))
    gx2, gr2, gfb2, ga, gb, gp, gm = reverse_echo.reverse_echo_scan_bwd_ref(
        x[cut:], blk[cut:], r[cut:], fb[cut:], alt[cut:], pb1, m1, y2, *cts2, **kw)
    gx1, gr1, gfb1, *state = reverse_echo.reverse_echo_scan_bwd_ref(
        x[:cut], blk[:cut], r[:cut], fb[:cut], alt[:cut], pb, misc, y1, g1, ga, gb, gp, gm,
        **kw)

    def both(x, r, fb, ba, bb, pb, misc):
        o1 = reverse_echo.reverse_echo_scan_ref(x[:cut], blk[:cut], r[:cut], fb[:cut],
                                                alt[:cut], ba, bb, pb, misc, **kw)
        o2 = reverse_echo.reverse_echo_scan_ref(x[cut:], blk[cut:], r[cut:], fb[cut:],
                                                alt[cut:], *o1[1:], **kw)
        return (o1[0], *o2)

    want = _autograd(both, [x, r, fb, ba, bb, pb, misc], range(7), [g1, *cts2])
    got = [torch.cat([gx1, gx2]), torch.cat([gr1, gr2]), torch.cat([gfb1, gfb2]), *state]
    for a, b in zip(got, want):
        assert _rel(a, b) <= ADJ_TOL


def test_envelope_and_slew_adjoints_across_a_block_edge():
    rng = np.random.default_rng(7)
    x, e0, g, gf = _seeded(rng, (200, 2), (2,), (200, 2), (2,))
    x, e0, cut = x.abs(), e0.abs(), 77
    kw = dict(atk=0.05, rel=0.002)
    e1, f1 = envelope.envelope_ar_scan_ref(x[:cut], e0, **kw)
    e2, _ = envelope.envelope_ar_scan_ref(x[cut:], f1, **kw)
    gx2, g_mid = envelope.envelope_ar_scan_bwd_ref(x[cut:], f1, e2, g[cut:], gf, **kw)
    gx1, g0 = envelope.envelope_ar_scan_bwd_ref(x[:cut], e0, e1, g[:cut], g_mid, **kw)
    want = _autograd(lambda *a: envelope.envelope_ar_scan_ref(*a, **kw), [x, e0], [0, 1],
                     [g, gf])
    assert _rel(torch.cat([gx1, gx2]), want[0]) <= ADJ_TOL and _rel(g0, want[1]) <= ADJ_TOL
    xs, c0 = _slew_input(200, 3), torch.tensor(0.1)
    gs, gc = _seeded(rng, (200,), ())
    skw = dict(linear=True, p_rise=0.25, p_fall=0.125)
    y, _ = slew.slew_scan_ref(xs, c0, **skw)
    sx2, s_mid = slew.slew_scan_bwd_ref(xs[cut:], y[cut - 1], y[cut:], gs[cut:], gc, **skw)
    sx1, s0 = slew.slew_scan_bwd_ref(xs[:cut], c0, y[:cut], gs[:cut], s_mid, **skw)
    want = _autograd(lambda *a: slew.slew_scan_ref(*a, **skw), [xs, c0], [0, 1], [gs, gc])
    assert _rel(torch.cat([sx1, sx2]), want[0]) <= ADJ_TOL and _rel(s0, want[1]) <= ADJ_TOL


def _gate(T, kind):
    g = np.zeros(T, np.float32)
    if kind == "gated":
        g[100:1200] = 1.0
        g[1500:1501] = 1.0
        g[1700:T - 50] = 1.0
    else:
        g[[50, 300, 301, 1500, T - 3]] = 1.0
    return torch.from_numpy(g)


@pytest.mark.parametrize("kind,state", [
    ("gated", [4.0, 0.5, 3.0, 1.0]), ("gated", [1.0, 0.2, 3.0, 0.0]),
    ("gated", [2.0, 0.9, 3.0, 1.0]), ("gated", [2.5, 0.3, 0.5, 1.0]),
    ("triggered", [1.0, 0.2, 3.0, 0.0]), ("triggered", [3.0, 0.6, 30.0, 0.0]),
    ("triggered", [4.0, 0.6, 3.0, 0.0])])
def test_adsr_adjoint_matches_autograd(kind, state):
    """Every stage entered, one state outside the closed form (the
    per-sample walk), gated and triggered."""
    T = 2000
    gate = _gate(T, kind)
    st = torch.tensor(state)
    kw = dict(dA=1.0 / 80, dD=-0.4 / 200, dR=-0.6 / 300, sus=0.6,
              sustain_samples=None if kind == "gated" else 100)
    env, ns, en = adsr.adsr_scan_ref(gate, st, **kw)
    rng = np.random.default_rng(8)
    g, gs, gn = _seeded(rng, (T,), (4,), ())
    got = adsr.adsr_scan_bwd_ref(gate, st, env, g, gs, gn, **kw)
    (want,) = _autograd(lambda *a: adsr.adsr_scan_ref(*a, **kw), [gate, st], [1], [g, gs, gn])
    assert _rel(got, want) <= ADJ_TOL, (got, want)


def _clock_f64(trig, env, stage, dA, dD, dR, sus):
    """The clock branch's envelope in float64 tensor ops (differentiable in
    the envelope handed in), the plain version's steps; the sustain
    deadline is left out (an expiry leaves SUSTAIN, whose value is already
    a constant)."""
    out, e, st = [], env, stage
    for g in trig.tolist():
        out.append(e)
        st = 1 if g > 0.0 else st
        if st == 0:
            e = e * 0.0
        elif st == 3:
            e = e * 0.0 + sus
        else:
            e2 = e + (dA if st == 1 else dD if st == 2 else dR)
            lim = 1.0 if st == 1 else sus if st == 2 else 0.0
            if (e2 >= lim) if st == 1 else (e2 <= lim):
                e2, st = e2 * 0.0 + lim, (2 if st == 1 else 3 if st == 2 else 0)
            e = e2
    return torch.stack(out), e


@pytest.mark.parametrize("stage,env", [(0, 0.0), (1, 0.3), (4, 0.5), (2, 0.9)])
def test_adsr_clock_adjoint_matches_autograd(stage, env):
    T = 2000
    trig = _gate(T, "triggered")
    kw = dict(dA=1.0 / 400, dD=-0.4 / 200, dR=-0.6 / 3000, sus=0.6)
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.standard_normal(T).astype(np.float32))
    gout = torch.tensor(0.7, dtype=torch.float64)
    got = adsr.adsr_clock_scan_bwd_ref(trig, torch.tensor(stage, dtype=torch.int32),
                                       torch.tensor(env, dtype=torch.float64), g, gout, **kw)
    e = torch.tensor(env, dtype=torch.float64, requires_grad=True)
    y, e_out = _clock_f64(trig, e, stage, **kw)
    (want,) = torch.autograd.grad([y, e_out], [e], [g.double(), gout], allow_unused=True,
                                  materialize_grads=True)
    y_plain, _ = adsr.adsr_clock_scan_ref(trig, torch.tensor(stage, dtype=torch.int32),
                                          torch.tensor(env, dtype=torch.float64),
                                          torch.tensor(0, dtype=torch.int64), t0=0,
                                          sustain_samples=10 ** 9, **kw)
    assert torch.equal(y.detach().float(), y_plain)  # the replica is the plain version
    assert abs(float(got) - float(want)) <= 1e-12 * max(abs(float(want)), 1.0)


# ---- the card's glue, the plain versions as its launches ----


def _echo_in_place(x, blk, ratio, fb, alt, buf_a, buf_b, pitch_buf, misc, **kw):
    """The plain echo updating its rings in place, as the kernel does."""
    y, ba, bb, pb, m = reverse_echo.reverse_echo_scan_ref(x, blk, ratio, fb, alt, buf_a, buf_b,
                                                          pitch_buf, misc, **kw)
    with torch.no_grad():
        buf_a.copy_(ba)
        buf_b.copy_(bb)
    return y, buf_a, buf_b, pb, m


def _glued(monkeypatch):
    counts = dict.fromkeys(("envelope_ar_scan", "slew_scan", "reverse_echo_scan",
                            "adsr_scan"), 0)

    def count(name, args, outs, grads, kw, got):
        assert len(got) == len(args)
        counts[name] += 1

    monkeypatch.setattr(diffable, "on_backward", count)
    for mod, name, launch in (
            (envelope, "envelope_ar_scan", envelope.envelope_ar_scan_ref),
            (slew, "slew_scan", slew.slew_scan_ref),
            (reverse_echo, "reverse_echo_scan", _echo_in_place),
            (adsr, "adsr_scan", adsr.adsr_scan_ref)):
        monkeypatch.setattr(mod, name, diffable.kernel_function(name, launch, mod._backward))
    return counts


def _render_grads(graph, n, block, theta):
    binds = {k: torch.tensor(v, requires_grad=True) for k, v in theta.items()}
    out = engine.render_functional(graph, 0, n, block, binds, device="cpu")
    return torch.autograd.grad((out ** 2).mean(), list(binds.values()), allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("which,n,block,calls", [
    ("chain", 2048, 512, {"envelope_ar_scan": 4, "slew_scan": 4, "reverse_echo_scan": 4,
                          "adsr_scan": 0}),
    ("fx_bank", 8192, 4096, {"envelope_ar_scan": 2, "slew_scan": 0, "reverse_echo_scan": 2,
                             "adsr_scan": 0}),
    ("adsr_probe", 2048, 512, {"envelope_ar_scan": 0, "slew_scan": 0, "reverse_echo_scan": 0,
                               "adsr_scan": 4})])
def test_card_glue_matches_plain_autograd(monkeypatch, which, n, block, calls):
    """The glue's gradients, the state's cotangents carried across the
    blocks (the echo's rings updated in place and not saved), equal
    autograd of the plain versions; one backward call a block and kernel."""
    build = {"chain": lambda: fw.build_fit_chain(pt, n / SR),
             "fx_bank": lambda: fw.build_fit_fx_bank(pt, n / SR, channels=4),
             "adsr_probe": lambda: fw.build_adsr_probe(pt, n)}[which]
    theta = {"chain": {"depth": 2500.0, "fb": 0.6}, "fx_bank": {"drive": 1.0, "fb": 0.6},
             "adsr_probe": {"g": 1.0}}[which]
    if which == "fx_bank":  # short echo blocks: the replay and its feedback within n
        monkeypatch.setattr(fx_workload, "ECHO_BLOCK_S", 0.05)
    want = _render_grads(build(), n, block, theta)
    counts = _glued(monkeypatch)
    got = _render_grads(build(), n, block, theta)
    assert counts == calls
    for g, w in zip(got, want):
        assert _rel(g, w) <= ADJ_TOL, (got, want)
    if which == "fx_bank":
        assert all(float(g) != 0.0 for g in got)


if __name__ == "__main__":
    # ``python tests/test_torch_fit_chain.py`` prints the observed maxima
    jax.config.update("jax_platforms", "cpu")
    pg.set_sample_rate(SR)
    pt.set_sample_rate(SR)
    for which in GRAPHS:
        with pytest.MonkeyPatch.context() as mp:
            v, jv, got, want = _whole(which, mp)
        errs = {k: abs(got[k] - want[k]) / abs(want[k]) if want[k] else abs(got[k])
                for k in want}
        print(f"{which}: loss {v:.9g} (JAX {jv:.9g}), gradients {got} (JAX {want}), "
              f"relative errors {errs}")
