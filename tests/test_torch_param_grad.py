"""PyTorch port, ParamPE gradients through ``engine.render_functional``.

Counterparts of ``tests/test_param_pe.py``'s gradient tests and of its
``vmap`` test (a loop of port renders against the JAX package's ``vmap``),
and whole-render gradients against ``jax.grad`` of the JAX package's
render: BiquadPE's bound cutoff (once NaN in the port: ``ops/xla_math``'s
``fmaf`` formed 0·∞ in its backward), the gradient probe of
``bench.py:_grad_probe`` and the fit patch at a small size (the JAX side
with ``FORCE_KERNEL_INTERPRET``: its kernels' custom VJPs replay the
``lax.scan`` references, a few seconds to compile where plain ``jax.grad``
of a LadderPE render takes minutes), and graphs that once lost their
gradient to host conversions in the plain kernels.

Tolerances: BiquadPE's d/dcutoff 1e-3 relative and d/dgain 1e-6
relative; the probe and the fit patch 1e-5 relative (float32 recurrences
over ~1000 samples summed in other orders); analytic gradients 1e-5, as
the JAX tests. ``python tests/test_torch_param_grad.py`` prints the
observed relative errors of the whole renders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygmu2_tpu as pg
import pygmu2_tpu_torch as pt
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu.ops import diffable as jdiffable
from pygmu2_tpu_torch import fit_workload
from pygmu2_tpu_torch.core import engine

torch.set_num_threads(1)

SR = 44100


@pytest.fixture(autouse=True)
def _port_sample_rate():
    """The port's global rate (tests/conftest.py sets the JAX package's)."""
    pt.set_sample_rate(SR)


def _theta(**values):
    return {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}


def _port_grads(graph, n, block, theta, loss=lambda out: (out ** 2).mean()):
    out = engine.render_functional(graph, 0, n, block, theta, device="cpu")
    value = loss(out)
    grads = torch.autograd.grad(value, list(theta.values()))
    return float(value.detach()), {k: float(g) for k, g in zip(theta, grads)}


def _jax_grads(graph, n, block, theta, interpret=False):
    def loss(b):
        return jnp.mean(jengine.render_functional(graph, 0, n, block, b) ** 2)

    jdiffable.FORCE_KERNEL_INTERPRET = interpret
    try:
        v, g = jax.value_and_grad(loss)({k: jnp.float32(x) for k, x in theta.items()})
    finally:
        jdiffable.FORCE_KERNEL_INTERPRET = False
    return float(v), {k: float(x) for k, x in g.items()}


def _biquad(pkg):
    pkg.set_sample_rate(SR)
    filt = pkg.BiquadPE(pkg.BlitSawPE(110.0), pkg.ParamPE("cutoff"), 0.707,
                        pkg.BiquadMode.LOWPASS)
    return pkg.CropPE(pkg.GainPE(filt, pkg.ParamPE("gain")), 0, 2048)


def test_biquad_cutoff_gradient_is_finite_and_matches_jax():
    theta = {"gain": 0.3, "cutoff": 1800.0}
    _, got = _port_grads(_biquad(pt), 2048, 512, _theta(**theta))
    _, want = _jax_grads(_biquad(pg), 2048, 512, theta)
    assert np.isfinite(got["cutoff"]) and got["cutoff"] != 0.0
    assert abs(got["cutoff"] - want["cutoff"]) <= 1e-3 * abs(want["cutoff"])
    assert abs(got["gain"] - want["gain"]) <= 1e-6 * abs(want["gain"])


def _whole_render(which):
    """(the port's loss, JAX's, the port's gradients, JAX's) of bench.py's
    gradient probe at 1024 samples in blocks of 256, or of the fit patch
    (ladder sweep centre and comb feedback bound) at 1024 samples in
    blocks of 512."""
    if which == "probe":
        build, n, block = (lambda p: fit_workload.build_probe(p, 1024)), 1024, 256
    else:
        build, n, block = (lambda p: fit_workload.build_fit_patch(p, 1024 / SR)), 1024, 512
    theta = {"cutoff": 1500.0, "fb": 0.6}

    def loss(out):
        assert out.grad_fn is not None
        return (out ** 2).mean()

    v, got = _port_grads(build(pt), n, block, _theta(**theta), loss)
    jv, want = _jax_grads(build(pg), n, block, theta, interpret=True)
    return v, jv, got, want


@pytest.mark.parametrize("which", ["probe", "fit patch"])
def test_whole_render_gradient_matches_jax(which):
    """Loss and gradients of a whole render against the JAX render's."""
    v, jv, got, want = _whole_render(which)
    assert abs(v - jv) <= 1e-5 * abs(jv)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)


@pytest.mark.parametrize("graph", ["probe", "ladder drive", "ladder cutoff", "comb feedback"])
def test_kernel_graphs_carry_grad_fn(graph):
    """Graphs whose gradient the plain ladder and comb once dropped (their
    float columns went to the host) and one that always kept it (a bound
    drive gain into the ladder's input)."""
    pt.set_sample_rate(SR)
    src = pt.SinePE(frequency=220.0)
    if graph == "probe":
        g, name = fit_workload.build_probe(pt, 512), "cutoff"
    elif graph == "ladder drive":
        g = pt.LadderPE(pt.GainPE(src, pt.ParamPE("p", 0.5)), 1200.0, 0.45)
        name = "p"
    elif graph == "ladder cutoff":
        g = pt.LadderPE(src, pt.GainPE(pt.ParamPE("p", 0.5), 3000.0), 0.45)
        name = "p"
    else:
        g, name = pt.CombPE(src, 220.0, feedback=pt.ParamPE("p", 0.6)), "p"
    theta = _theta(**{name: 1500.0 if name == "cutoff" else 0.5})
    out = engine.render_functional(g, 0, 512, 256, theta, device="cpu")
    assert out.requires_grad and out.grad_fn is not None
    (grad,) = torch.autograd.grad((out ** 2).mean(), list(theta.values()))
    assert torch.isfinite(grad) and float(grad) != 0.0


class TestDifferentiable:
    """tests/test_param_pe.py's TestDifferentiable, through the port."""

    def test_grad_matches_analytic(self):
        n = 512
        x = np.linspace(-1, 1, n, dtype=np.float32)[:, None]
        g = pt.CropPE(pt.GainPE(pt.ArrayPE(x), pt.ParamPE("g", default=1.0)), 0, n)
        _, grads = _port_grads(g, n, 128, _theta(g=0.8))
        assert abs(grads["g"] - 2.0 * 0.8 * float(np.mean(x ** 2))) < 1e-5

    def test_gradient_descent_recovers_gain(self):
        n = 256
        x = np.sin(np.arange(n, dtype=np.float32) * 0.1)[:, None]
        target = torch.from_numpy(0.37 * x)
        g = pt.CropPE(pt.GainPE(pt.ArrayPE(x), pt.ParamPE("g", default=0.0)), 0, n)
        b = torch.tensor(0.0, requires_grad=True)
        for _ in range(80):
            out = engine.render_functional(g, 0, n, 64, {"g": b}, device="cpu")
            (gr,) = torch.autograd.grad(((out - target) ** 2).mean(), b)
            b = (b - 0.9 * gr).detach().requires_grad_()
        assert abs(float(b.detach()) - 0.37) < 1e-3

    def test_grad_through_stateful_filter_scan(self):
        n = 256
        x = np.sin(np.arange(n, dtype=np.float32) * 0.3)[:, None]
        g = pt.CropPE(pt.BiquadPE(pt.ArrayPE(x), pt.ParamPE("f", default=2000.0), 0.707,
                                  mode=pt.BiquadMode.LOWPASS), 0, n)
        _, grads = _port_grads(g, n, 64, _theta(f=1500.0))
        assert np.isfinite(grads["f"]) and grads["f"] != 0.0
        jg = pg.CropPE(pg.BiquadPE(pg.ArrayPE(x), pg.ParamPE("f", default=2000.0), 0.707,
                                   mode=pg.BiquadMode.LOWPASS), 0, n)
        _, want = _jax_grads(jg, n, 64, {"f": 1500.0})
        assert abs(grads["f"] - want["f"]) <= 1e-3 * abs(want["f"])


def test_loop_over_bindings_matches_jax_vmap():
    """test_param_pe.py::test_vmap_over_bindings: the port has no vmap
    over its launches (ROADMAP queue 1, batched bindings), so a loop of
    renders against the JAX package's vmap output."""
    n = 256
    x = np.linspace(-1, 1, n, dtype=np.float32)[:, None]
    jg = pg.CropPE(pg.GainPE(pg.ArrayPE(x), pg.ParamPE("g", default=1.0)), 0, n)
    gains = np.asarray([0.1, 0.5, 1.0, 2.0], np.float32)
    batch = jax.vmap(lambda v: jengine.render_functional(jg, 0, n, 64, {"g": v}))(
        jnp.asarray(gains))
    tg = pt.CropPE(pt.GainPE(pt.ArrayPE(x), pt.ParamPE("g", default=1.0)), 0, n)
    for k, v in enumerate(gains):
        got = engine.render_functional(tg, 0, n, 64, {"g": torch.tensor(v)}, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(batch[k]), atol=1e-6)


def test_bindings_keep_their_graph():
    """A scalar and a (C,) tensor binding that require grad, through
    render_functional and render_scan; render_scan leaves detached states
    on the PE instances, and render_to_array hands back a host array."""
    pt.set_sample_rate(SR)
    src = pt.ArrayPE(np.random.default_rng(0).standard_normal((300, 2)).astype(np.float32))
    g = pt.CropPE(pt.BiquadPE(pt.GainPE(src, pt.ParamPE("g", channels=2)),
                              pt.ParamPE("f", 900.0), 0.9), 0, 300)
    theta = {"g": torch.tensor([0.5, 2.0], requires_grad=True),
             "f": torch.tensor(900.0, requires_grad=True)}
    out = engine.render_functional(g, 0, 300, 128, theta, device="cpu")
    gg, gf = torch.autograd.grad((out ** 2).mean(), [theta["g"], theta["f"]])
    assert gg.shape == (2,) and torch.isfinite(gg).all() and float(gf) != 0.0
    out = engine.render_scan(g, 0, 300, 128, theta, device="cpu")
    assert out.grad_fn is not None
    state = g.source._eng_state["user"]
    assert not any(v.requires_grad for v in state.values())
    arr = pt.render_to_array(g, bindings=theta, block=128, device="cpu")
    np.testing.assert_array_equal(arr, out.detach().numpy())


def test_fit_lowers_the_loss():
    """fit_workload.fit on the probe at 512 samples from (1500 Hz, 0.6)
    towards a target rendered at (1100 Hz, 0.45): three Adam steps."""
    graph = fit_workload.build_probe(pt, 512)
    target = engine.render_functional(graph, 0, 512, 256, {"cutoff": 1100.0, "fb": 0.45},
                                      device="cpu")
    losses, fitted = fit_workload.fit(graph, target, {"cutoff": 1500.0, "fb": 0.6}, 3, 0.05,
                                      block=256, device="cpu")
    assert losses[-1] < losses[0]
    assert fitted["fb"] < 0.6 and fitted["cutoff"] < 1500.0


if __name__ == "__main__":
    # ``python tests/test_torch_param_grad.py`` prints the whole renders'
    # relative errors against the JAX package
    jax.config.update("jax_platforms", "cpu")
    pg.set_sample_rate(SR)
    pt.set_sample_rate(SR)
    theta = {"gain": 0.3, "cutoff": 1800.0}
    _, got = _port_grads(_biquad(pt), 2048, 512, _theta(**theta))
    _, want = _jax_grads(_biquad(pg), 2048, 512, theta)
    print("BiquadPE:", {k: abs(got[k] - want[k]) / abs(want[k]) for k in want})
    for which in ("probe", "fit patch"):
        v, jv, got, want = _whole_render(which)
        print(f"{which}: loss {abs(v - jv) / abs(jv):.3g},",
              {k: abs(got[k] - want[k]) / abs(want[k]) for k in want})
