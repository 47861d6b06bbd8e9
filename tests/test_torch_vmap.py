"""PyTorch port, batched bindings: ``torch.func.vmap`` over ``render_functional``.

Counterpart of ``tests/test_param_pe.py::test_vmap_over_bindings`` (the
port's vmap against the JAX package's ``jax.vmap`` of the same graph) and
of ``jax.vmap`` over bindings in general: every kernel PE's graph rendered
under ``torch.func.vmap`` against the loop of renders, through the plain
versions (what the CPU runs) and through the card's glue (the launches'
``torch.autograd.Function`` of ``ops/diffable.py`` with their vmap rules
and backward glue, the plain versions standing in for the kernels, so the
rules, the folds into the channel axis and the per-member channel sums
run here). For each: the vmapped render equals the loop, the gradient of
a loss summed over the candidates gives each candidate's (autograd of the
loop), and so does ``torch.func.vmap(torch.func.grad(loss))``, the
counterpart of ``jax.vmap(jax.grad(...))``. Then each kernel's rule on its
own: which calls fold into one launch and which launch once per member,
their outputs and their gradients (a shared column's cotangent per
member), and the echo's rings never written through.

Tolerances: renders 1e-6 absolute (measured bit for bit), gradients 1e-5
relative to the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import pygmu2_tpu as pg
import pygmu2_tpu_torch as pt
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu_torch import fit_workload as fw
from pygmu2_tpu_torch.core import engine
from pygmu2_tpu_torch.ops import (adsr, comb, diffable, envelope, ks, ladder, linrec,
                                  linrec_kernel, reverse_echo, slew)

torch.set_num_threads(1)

SR = 44100
VMAP_TOL = 1e-6
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_sample_rate():
    pt.set_sample_rate(SR)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_vmap_over_bindings_matches_jax_vmap():
    """test_param_pe.py::test_vmap_over_bindings: the port's torch.func.vmap
    over render_functional against the JAX package's jax.vmap."""
    n = 256
    x = np.linspace(-1, 1, n, dtype=np.float32)[:, None]
    gains = np.asarray([0.1, 0.5, 1.0, 2.0], np.float32)
    jg = pg.CropPE(pg.GainPE(pg.ArrayPE(x), pg.ParamPE("g", default=1.0)), 0, n)
    want = jax.vmap(lambda v: jengine.render_functional(jg, 0, n, 64, {"g": v}))(
        jnp.asarray(gains))
    tg = pt.CropPE(pt.GainPE(pt.ArrayPE(x), pt.ParamPE("g", default=1.0)), 0, n)
    got = vmap(lambda v: engine.render_functional(tg, 0, n, 64, {"g": v}, device="cpu"))(
        torch.from_numpy(gains))
    assert got.shape == (4, n, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VMAP_TOL)


# ---- the card's glue, with the plain versions as its launches ---------------


def _glue(monkeypatch):
    """Every kernel wrapper as on the card: its launch a
    torch.autograd.Function (ops/diffable.py) with its vmap rule and
    backward glue, the plain versions standing in for the forward and the
    backward kernels. Returns {"fwd": launches, "bwd": backward calls} by
    kernel name."""
    counts = {"fwd": {}, "bwd": {}}

    def counted(name, fn):
        def launch(*args, **kw):
            counts["fwd"][name] = counts["fwd"].get(name, 0) + 1
            return fn(*args, **kw)
        return launch

    def on_backward(name, args, outs, grads, kw, got):
        assert len(got) == len(args)
        counts["bwd"][name] = counts["bwd"].get(name, 0) + 1

    def glued(name, ref, backward, layout=None):
        return diffable.kernel_function(name, counted(name, ref), backward, **(layout or {}))

    monkeypatch.setattr(diffable, "on_backward", on_backward)
    for mod, name, ref, layout in (
            (ladder, "ladder_scan", ladder.ladder_scan_ref, ladder.LAYOUT),
            (comb, "comb_scan", comb.comb_scan_ref, comb.LAYOUT),
            (envelope, "envelope_ar_scan", envelope.envelope_ar_scan_ref, envelope.LAYOUT),
            (slew, "slew_scan", slew.slew_scan_ref, None),
            (reverse_echo, "reverse_echo_scan", reverse_echo.reverse_echo_scan_ref,
             reverse_echo.LAYOUT),
            (adsr, "adsr_scan", adsr.adsr_scan_ref, None)):
        monkeypatch.setattr(mod, name, glued(name, ref, mod._backward, layout))
    def clock_ref(*args, **kw):
        env_t, state = adsr.adsr_clock_scan_ref(*args, **kw)
        return env_t, *state

    clock = glued("adsr_clock_scan", clock_ref, adsr._backward_clock)

    def clock_scan(trig, stage, env, ends, **kw):
        env_t, *st = clock(trig, stage, env, ends, **kw)
        return env_t, tuple(st)

    monkeypatch.setattr(adsr, "adsr_clock_scan", clock_scan)

    def scan_fwd(a11, a12, a21, a22, u1, u2, s01, s02, *, chunk):
        s0 = None if s01 is None else (s01, s02)
        return linrec_kernel.affine_scan_2_chunked_ref(a11, a12, a21, a22, u1, u2, s0,
                                                       chunk=chunk)

    scan = glued("affine_scan_2", scan_fwd, linrec_kernel._backward, linrec_kernel.LAYOUT)

    def scan_kernel(a11, a12, a21, a22, u1, u2, s0=None, *, chunk):
        return scan(a11, a12, a21, a22, u1, u2, *(s0 or (None, None)), chunk=chunk)

    monkeypatch.setattr(linrec, "affine_scan_2_kernel", scan_kernel)
    per = glued("ks_scan", ks.ks_scan_ref, ks._backward)
    blocked = glued("ks_scan (blocked)", ks.ks_blocked_ref, ks._backward_blocked)

    def ks_scan(rho, act, buf, r, ap_in, ap_out, *, L, allpass_c, all_active=False):
        if all_active and L >= ks.BLOCKED_MIN_L:
            return blocked(rho, buf, r, ap_in, ap_out, L=L, allpass_c=allpass_c)
        return per(rho, act, buf, r, ap_in, ap_out, L=L, allpass_c=allpass_c)

    monkeypatch.setattr(ks, "ks_scan", ks_scan)
    return counts


# ---- every kernel PE's graph under vmap -------------------------------------


def _sweep():
    """examples/gradient_fit_eg.py's candidate sweep (fit_workload.build_sweep:
    BlitSawPE -> BiquadPE(cutoff) -> GainPE; its filter's scan in plain
    torch at one channel)."""
    return fw.build_sweep(pt, 1024), 1024, 256, {"cutoff": [500.0, 4000.0]}


def _bank():
    """BiquadPE and SVFilterPE on 8 channels at a 4096-sample block: the
    order-2 affine scan's kernel route, its planes batched (a fold)."""
    from pygmu2_tpu_torch import patch_workload

    saws = pt.ArrayPE(patch_workload.detuned_saws(8192, 0, channels=8))
    low = pt.BiquadPE(saws, fw._swept_around(pt, pt.ParamPE("low_hz"), 0.25, 1200.0), 4.0,
                      mode=pt.BiquadMode.LOWPASS)
    band = pt.SVFilterPE(low, fw._swept_around(pt, pt.ParamPE("band_hz"), 0.4, 500.0), 2.0,
                         mode=pt.BiquadMode.BANDPASS)
    graph = pt.CropPE(pt.GainPE(band, 0.5), 0, 8192)
    return graph, 8192, 4096, {"low_hz": [900.0, 1500.0], "band_hz": [500.0, 800.0]}


def _triggered(sustain_time):
    """A triggered ADSR whose trigger is scaled by ParamPE("g"): a sustain of
    0.02 s takes adsr_scan, one of 0 its absolute clock (adsr_clock_scan)."""
    trig = pt.GainPE(pt.PeriodicTrigger(hz=40), pt.ParamPE("g", default=1.0))
    env = pt.AdsrTriggeredPE(trig, 0.003, 0.005, sustain_time, 0.6, 0.004)
    return pt.CropPE(pt.GainPE(pt.SinePE(220.0), env), 0, 768), 768, 256, {"g": [0.5, 2.0]}


GRAPHS = {  # name: (builder, the kernels it launches under vmap on the card)
    "probe": (lambda: (fw.build_probe(pt, 512), 512, 128,
                       {"cutoff": [900.0, 2500.0], "fb": [0.3, 0.6]}),
              ("ladder_scan", "comb_scan")),
    "sweep": (_sweep, ()),
    "bank": (_bank, ("affine_scan_2",)),
    "adsr_gated": (lambda: (fw.build_adsr_probe(pt, 512), 512, 128, {"g": [0.5, 2.0]}),
                   ("adsr_scan",)),
    "adsr_triggered": (lambda: _triggered(0.02), ("adsr_scan",)),
    "adsr_clock": (lambda: _triggered(0.0), ("adsr_clock_scan",)),
    "chain": (lambda: (fw.build_fit_chain(pt, 1024 / SR), 1024, 512,
                       {"fb": [0.3, 0.6], "depth": [2000.0, 2500.0]}),
              ("envelope_ar_scan", "slew_scan", "reverse_echo_scan")),
    # the drive alone batched: the follower and the echo fold, the echo's
    # rings fresh and unbatched in the first block, batched after it
    "fx_bank_drive": (lambda: (fw.build_fit_fx_bank(pt, 1024 / SR, channels=3), 1024, 512,
                               {"drive": [0.5, 1.5]}),
                      ("envelope_ar_scan", "reverse_echo_scan")),
}


# the graphs whose every batched kernel argument has a channel axis: launches
# a vmapped block (the batch folded into the channels)
FOLDS = {"bank": {"affine_scan_2": 2},
         "fx_bank_drive": {"envelope_ar_scan": 1, "reverse_echo_scan": 1}}


@pytest.mark.parametrize("mode", ["plain", "glued"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_under_vmap(monkeypatch, name, mode):
    build, kernels = GRAPHS[name]
    graph, n, block, batch = build()
    counts = _glue(monkeypatch) if mode == "glued" else None
    keys = list(batch)
    B = len(batch[keys[0]])
    cols = {k: torch.tensor(v) for k, v in batch.items()}
    members = [{k: cols[k][i] for k in keys} for i in range(B)]

    def render(b):
        return engine.render_functional(graph, 0, n, block, b, device="cpu")

    def loss(b):
        return torch.mean(render(b) ** 2)

    out = vmap(render)(cols)
    if counts is not None and name in FOLDS:
        assert counts["fwd"] == {k: v * -(-n // block) for k, v in FOLDS[name].items()}
    loop = torch.stack([render(m) for m in members])
    assert out.shape == loop.shape and loop.shape[:2] == (B, n)
    assert float((out - loop).abs().max()) <= VMAP_TOL
    if counts is not None:
        assert all(counts["fwd"].get(k, 0) > 0 for k in kernels), counts

    def grads(value, wrt):  # a loss that no binding reaches has a zero gradient
        if not value.requires_grad:
            return [torch.zeros_like(v) for v in wrt]
        return torch.autograd.grad(value, wrt, allow_unused=True, materialize_grads=True)

    want = []
    for m in members:
        vals = [m[k].clone().requires_grad_() for k in keys]
        want.append(grads(loss(dict(zip(keys, vals))), vals))
    want = [torch.stack([w[i] for w in want]) for i in range(len(keys))]
    vals = {k: v.clone().requires_grad_() for k, v in cols.items()}
    summed = grads(vmap(loss)(vals).sum(), list(vals.values()))
    per = vmap(grad(loss))(cols)
    for i, k in enumerate(keys):
        assert _rel(summed[i], want[i]) <= GRAD_TOL, (k, summed[i], want[i])
        assert _rel(per[k], want[i]) <= GRAD_TOL, (k, per[k], want[i])
    if counts is not None and kernels:
        assert all(counts["bwd"].get(k, 0) > 0 for k in kernels
                   if k != "adsr_clock_scan"), counts


# ---- each kernel's rule on its own ------------------------------------------

T_OP, C_OP, B_OP = 48, 3, 3


def _op_cases():
    """name: (wrapper, arguments, keywords, the batched argument, which
    argument's gradient to check per member, launches a vmapped call
    makes)."""
    rng = np.random.default_rng(7)
    T, C = T_OP, C_OP
    f = lambda *shape, lo=-1.0, hi=1.0: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, shape).astype(np.float32))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    lad = [f(T, C), f(T, lo=0.1, hi=0.6), f(T, lo=0.5, hi=1.0), f(T, lo=1.0, hi=3.0),
           f(T, lo=0.8, hi=1.2), f(9, C, lo=-0.1, hi=0.1)]
    lad_kw = dict(os_n=2, pbg=0.5, mode_index=0, input_threshold=1e-4, state_decay=0.999)
    cmb = [f(T, C), f(T, lo=800.0, hi=900.0), f(T, lo=0.3, hi=0.6), f(64, C), i32(5),
           torch.tensor(850.0)]
    cmb_kw = dict(L=64, sr=44100.0, smooth_alpha=0.01)
    env = [f(T, C, lo=0.0, hi=1.0), f(C, lo=0.0, hi=0.3)]
    env_kw = dict(atk=0.1, rel=0.01)
    echo = _echo_args(C)
    planes = [f(T, 1, lo=0.8, hi=0.95), f(T, 1, lo=-0.1, hi=0.1), f(T, 1, lo=-0.1, hi=0.1),
              f(T, 1, lo=0.8, hi=0.95), f(T, C), f(T, C), f(C), f(C)]
    gate = torch.zeros(T)
    gate[5:30] = 1.0
    string = [f(T, lo=0.95, hi=0.999), torch.arange(T) >= 4, f(9), i32(2), torch.tensor(0.1),
              torch.tensor(-0.2)]
    return {
        "ladder_x": (ladder.ladder_scan, lad, lad_kw, 0, 1, 1),
        "ladder_column": (ladder.ladder_scan, lad, lad_kw, 1, 1, B_OP),
        "comb_x": (comb.comb_scan, cmb, cmb_kw, 0, 2, 1),
        "comb_feedback": (comb.comb_scan, cmb, cmb_kw, 2, 2, B_OP),
        "envelope_x": (envelope.envelope_ar_scan, env, env_kw, 0, 1, 1),
        "echo_x": (reverse_echo.reverse_echo_scan, echo, ECHO_KW, 0, 3, 1),
        "echo_feedback": (reverse_echo.reverse_echo_scan, echo, ECHO_KW, 3, 3, B_OP),
        "scan_u": (lambda *a, chunk: linrec.affine_scan_2_kernel(*a[:6], tuple(a[6:]),
                                                                 chunk=chunk),
                   planes, dict(chunk=16), 4, 0, 1),
        "slew_x": (slew.slew_scan, [f(T), torch.tensor(0.1)],
                   dict(linear=False, p_rise=0.2, p_fall=0.05), 0, 1, B_OP),
        "adsr_gate": (adsr.adsr_scan, [gate, torch.tensor([0.0, 0.0, 0.0, 0.0])],
                      dict(dA=0.1, dD=-0.02, dR=-0.05, sus=0.6), 0, 1, B_OP),
        "string_rho": (ks.ks_scan, string, dict(L=9, allpass_c=0.35), 0, 2, B_OP),
    }


ECHO_SR, ECHO_CAP = 8000, 40
ECHO_KW = dict(sr=float(ECHO_SR), plen=20, cap=ECHO_CAP, min_block=8, max_block=ECHO_CAP - 1,
               smooth_alpha=1 / 2400)


def _echo_args(C):
    """The echo at 8 kHz with 16-sample blocks: replays within the call."""
    rng = np.random.default_rng(3)
    T = T_OP
    x = torch.from_numpy((rng.standard_normal((T, C)) * 0.3).astype(np.float32))
    col = lambda v: torch.full((T,), v)  # noqa: E731
    misc = torch.zeros(9)
    misc[0], misc[5], misc[6], misc[8] = 1, 16.0, 16.0, 1
    return [x, col(16 / ECHO_SR), col(1.5), col(0.6), col(1.0), torch.zeros(ECHO_CAP, C),
            torch.zeros(ECHO_CAP, C), torch.zeros(20, C), misc]


def _batch(a, i):
    """B_OP variants of argument a: scaled (floats) or shifted."""
    return torch.stack([a * (0.8 + 0.2 * k) for k in range(B_OP)])


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_kernel_rule_under_vmap(monkeypatch, name):
    """Through the glue: a call whose batched arguments all carry the
    channel axis folds into one launch, else one launch per member; the
    outputs equal the loop's; vmap(grad) of a loss of every float output
    gives each member's gradient, a shared argument's too (its cotangent
    summed over a member's channels only); unbatched rings are not written."""
    counts = _glue(monkeypatch)
    fn_name = {"ladder": "ladder_scan", "comb": "comb_scan", "envelope": "envelope_ar_scan",
               "echo": "reverse_echo_scan", "scan": "affine_scan_2", "slew": "slew_scan",
               "adsr": "adsr_scan", "string": "ks_scan"}[name.split("_")[0]]
    wrapper, args, kw, bi, gi, launches = _op_cases()[name]
    wrapper = {"ladder_scan": ladder.ladder_scan, "comb_scan": comb.comb_scan,
               "envelope_ar_scan": envelope.envelope_ar_scan,
               "reverse_echo_scan": reverse_echo.reverse_echo_scan,
               "slew_scan": slew.slew_scan, "adsr_scan": adsr.adsr_scan,
               "ks_scan": ks.ks_scan}.get(fn_name, wrapper)
    kept = [a.clone() for a in args]
    batched = _batch(args[bi], bi)

    def call(b, g):
        full = list(args)
        full[bi], full[gi] = b, g if gi != bi else b
        return wrapper(*full, **kw)

    def loss(b, g):
        return sum((o.to(torch.float32) ** 2).sum() for o in call(b, g) if o.is_floating_point())

    g0 = args[gi]
    out = vmap(call, in_dims=(0, None))(batched, g0)
    assert counts["fwd"][fn_name] == launches, counts
    loop = [call(batched[k], g0) for k in range(B_OP)]
    for j, o in enumerate(out):
        want = torch.stack([lp[j] for lp in loop])
        assert torch.equal(o.expand_as(want), want), (j, o, want)
    for a, k in zip(args, kept):  # the rings handed in: not written through
        assert torch.equal(a, k)
    if gi == bi:
        per = vmap(grad(lambda b: loss(b, g0)))(batched)
        want = torch.stack([grad(lambda b: loss(b, g0))(batched[k]) for k in range(B_OP)])
    else:
        per = vmap(grad(loss, argnums=1), in_dims=(0, None))(batched, g0)
        want = torch.stack([grad(loss, argnums=1)(batched[k], g0) for k in range(B_OP)])
    assert _rel(per, want) <= GRAD_TOL
