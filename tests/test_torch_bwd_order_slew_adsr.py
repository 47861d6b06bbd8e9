"""PyTorch port: the slew limiter's and the ADSR's backward in their kernels'
order.

``ops/slew.slew_scan_bwd_chunked`` (the order of ``csrc/slew_scan_bwd.cu``:
``csrc/order1_grid.cuh``'s 256-sample chunks at one channel, by
``envelope.order1_adjoint_grid``) and ``ops/adsr.adsr_scan_bwd_tiled`` (the
order of ``csrc/adsr_scan_bwd.cu``: every sample's cut test at once, the
cotangents up to the first cut summed thread by thread, warp by warp and
tile by tile) on the CPU, on seeded inputs and cotangents, each against two
references: the port's plain adjoint (``slew_scan_bwd_ref``, the serial
walk; ``adsr_scan_bwd_ref``, the segment walk) and ``jax.vjp`` of the JAX
package's ``slew_scan_ref`` / ``adsr_scan_ref`` (the bodies its custom VJPs
replay; the ADSR's with its ``env_of_state`` of the state out, the port's
``env_next``).

Tolerance: 1e-5 of the largest cotangent of the call (float32 sums in other
orders). The ADSR's stage and previous gate are discrete: the port gives
them no cotangent, so their cotangents out are 0 here (JAX's ``where``
passes a stage's through where nothing changes it). The kernels themselves
are held to these orders bit for bit on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 16).
``PYTHONPATH=. python tests/test_torch_bwd_order_slew_adsr.py`` prints the
observed maxima.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygmu2_tpu.ops.adsr_pallas import adsr_scan_ref as jax_adsr_ref
from pygmu2_tpu.ops.adsr_pallas import env_of_state as jax_env_of_state
from pygmu2_tpu.ops.slew_pallas import slew_scan_ref as jax_slew_ref
from pygmu2_tpu_torch.ops import adsr, slew

torch.set_num_threads(1)

TOL = 1e-5


def _rel(got, want, scale) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(scale, 1e-30))


# ---- the slew limiter ----

SLEW_T = 3 * 256 + 77  # three 256-sample chunks and a ragged tail
# samples where x_t - y_{t-1} equals a limit exactly (linear): chunk edges
# (255, 256, 511, 512) and other segments (a segment is one sample at C = 1)
SLEW_TIES = (0, 1, 255, 256, 300, 511, 512, 700, SLEW_T - 1)
SLEW_KW = {True: dict(linear=True, p_rise=0.25, p_fall=0.125),
           False: dict(linear=False, p_rise=0.05, p_fall=0.01)}


def _slew_np(linear, seed):
    """x on a grid of 1/64 (the linear mode's steps stay exact), ties set at
    SLEW_TIES, alternately rising and falling; cur0; the cotangents."""
    rng = np.random.default_rng(seed)
    kw = SLEW_KW[linear]
    x = (np.round(rng.uniform(-1, 1, SLEW_T) * 64) / 64).astype(np.float32)
    cur0 = np.float32(0.5)
    for j, t in enumerate(SLEW_TIES):
        y = slew.slew_scan_ref(torch.from_numpy(x), torch.tensor(cur0), **kw)[0].numpy()
        prev = cur0 if t == 0 else y[t - 1]
        x[t] = prev + np.float32(kw["p_rise"] if j % 2 == 0 else -kw["p_fall"])
    y = slew.slew_scan_ref(torch.from_numpy(x), torch.tensor(cur0), **kw)[0].numpy()
    if linear:
        prev = np.concatenate([[cur0], y[:-1]]).astype(np.float32)
        err = x - prev
        for j, t in enumerate(SLEW_TIES):
            assert err[t] == np.float32(kw["p_rise"] if j % 2 == 0 else -kw["p_fall"])
    g = rng.uniform(-1, 1, SLEW_T).astype(np.float32)
    return x, cur0, y, g, np.float32(rng.uniform(0.5, 1.0))  # a nonzero gcur


def slew_errors(linear, seed=0):
    """(errors against the serial plain adjoint, against jax.vjp), each
    over the call's largest cotangent; and the number of ties."""
    kw = SLEW_KW[linear]
    x, cur0, y, g, gc = _slew_np(linear, seed)
    args = [torch.from_numpy(np.asarray(v)) for v in (x, cur0, y, g, gc)]
    got = slew.slew_scan_bwd_chunked(*args, **kw)
    want = slew.slew_scan_bwd_ref(*args, **kw)
    _, vjp = jax.vjp(lambda a, b: jax_slew_ref(a, b, **kw), jnp.asarray(x), jnp.asarray(cur0))
    want_jax = vjp((jnp.asarray(g), jnp.asarray(gc)))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    return ([_rel(p, q, scale) for p, q in zip(got, want)],
            [_rel(p, q, scale) for p, q in zip(got, want_jax)])


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "exponential"])
def test_slew_backward_order_matches_serial_and_jax(linear):
    """The slew limiter's backward in the kernel's order, both modes, T
    across three chunks and a ragged tail, ties at chunk and segment edges,
    a nonzero cotangent of the value out, against the serial plain adjoint
    and jax.vjp of the JAX package's slew_scan_ref."""
    plain, jx = slew_errors(linear, seed=3 + linear)
    assert max(plain) <= TOL, plain
    assert max(jx) <= TOL, jx


def test_slew_backward_order_splits_at_ties():
    """At a tie the linear mode's coefficient is 1/2 in the kernel's order
    too: a cotangent on the tie's sample alone reaches x there halved."""
    kw = SLEW_KW[True]
    x, cur0, y, _, _ = _slew_np(True, seed=5)
    g = np.zeros(SLEW_T, np.float32)
    t = SLEW_TIES[3]
    g[t] = 1.0
    args = [torch.from_numpy(np.asarray(v)) for v in (x, cur0, y, g, np.float32(0.0))]
    gx, _ = slew.slew_scan_bwd_chunked(*args, **kw)
    assert float(gx[t]) == 0.5


# ---- the ADSR ----

ADSR_KW = dict(dA=1.0 / 80, dD=-0.4 / 200, dR=-0.6 / 300, sus=0.6)
ADSR_T = 2049


def _gated(T, *spans):
    g = np.zeros(T, np.float32)
    for a, b in spans:
        g[a:b] = 1.0
    return g


def _triggers(T, *at):
    g = np.zeros(T, np.float32)
    g[list(at)] = 1.0
    return g


N24 = float(1 << 24)
# name: (gate, state [stage, e0, n, prev_gate], sustain_samples or None,
# keywords over ADSR_KW)
ADSR_CASES = {
    "cut at sample 0": (_gated(ADSR_T, (500, 900)), [1.0, 0.995, 0.0, 0.0], None, {}),
    "edge at sample 0": (_gated(ADSR_T, (0, 700), (1200, 1500)), [4.0, 0.4, 7.0, 0.0],
                         None, {}),
    "edge on the last sample": (_gated(ADSR_T, (ADSR_T - 1, ADSR_T)), [4.0, 0.9, 2.0, 0.0],
                                None, dict(dR=-0.6 / 30000)),
    "no cut: the live tail": (_gated(ADSR_T, (300, 1000)), [4.0, 0.9, 2.0, 0.0], None,
                              dict(dA=1.0 / 8000, dR=-0.6 / 30000)),
    "no edge, no cut": (_gated(ADSR_T), [2.0, 0.95, 10.0, 0.0], None,
                        dict(dD=-0.1 / 30000)),
    "triggered expiry": (_triggers(ADSR_T, 1900), [3.0, 0.6, 30.0, 0.0], 100, {}),
    "triggered ramps, then expiry": (_triggers(ADSR_T, 50, 300, 301), [1.0, 0.2, 3.0, 0.0],
                                     100, {}),
    "edge in SUSTAIN": (_gated(ADSR_T, (0, 400)), [3.0, 0.6, 0.0, 1.0], None, {}),
    "edge in IDLE": (_gated(ADSR_T, (700, 900)), [0.0, 0.0, 5.0, 0.0], None, {}),
    "no edge in SUSTAIN": (_gated(ADSR_T, (0, ADSR_T)), [3.0, 0.6, 0.0, 1.0], None, {}),
    "count near 2**24": (_gated(ADSR_T, (1500, ADSR_T)), [4.0, 0.8, N24 - 600.0, 0.0], None,
                         dict(dR=-1e-9)),
    "count at 2**24": (_gated(ADSR_T), [2.0, 0.9, N24, 0.0], None, dict(dD=-1e-9)),
    "outside the closed form": (_gated(ADSR_T, (100, 1200), (1500, 1501)),
                                [2.5, 0.3, 0.5, 1.0], None, {}),
    "past one tile, cut in the second": (
        _gated(16384 + 700, (16380, 16500)), [4.0, 0.9, 1.0, 0.0], None,
        dict(dR=-0.6 / 300000)),
    "past one tile, no cut": (_gated(16384 + 700, (3, 16383), (16385, 16386)),
                              [4.0, 0.5, 3.0, 0.0], None,
                              dict(dA=1.0 / 80000, dR=-0.1 / 300000)),
}


def adsr_errors(name, seed=0):
    """(error against the plain adjoint, against jax.vjp), over the largest
    cotangent of the state in; and how many samples the plain walk read."""
    gate, state, sustain, over = ADSR_CASES[name]
    kw = dict(ADSR_KW, **over, sustain_samples=sustain)
    T = gate.shape[0]
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1, 1, T).astype(np.float32)
    gs = rng.uniform(-1, 1, 4).astype(np.float32)
    gs[0] = gs[3] = 0.0  # the stage and the previous gate: discrete
    gn = np.float32(rng.uniform(-1, 1))
    tg, ts = torch.from_numpy(gate), torch.tensor(state, dtype=torch.float32)
    env = adsr.adsr_scan_phases(tg, ts, **kw)[0]
    cts = [torch.from_numpy(np.asarray(v)) for v in (g, gs, gn)]
    got = adsr.adsr_scan_bwd_tiled(tg, ts, env, *cts, **kw)
    want, walked = adsr.adsr_scan_bwd_ref(tg, ts, env, *cts, **kw, with_walked=True)
    jkw = dict(ADSR_KW, **over)

    def f(st):
        y, st_out = jax_adsr_ref(jnp.asarray(gate), st, **jkw, sustain_samples=sustain)
        return y, st_out, jax_env_of_state(st_out, **jkw)

    _, vjp = jax.vjp(f, jnp.asarray(state, jnp.float32))
    (want_jax,) = vjp((jnp.asarray(g), jnp.asarray(gs), jnp.asarray(gn)))
    scale = float(np.abs(want.numpy()).max())
    return _rel(got, want, scale), _rel(got, want_jax, scale), walked


@pytest.mark.parametrize("name", list(ADSR_CASES))
def test_adsr_backward_order_matches_plain_and_jax(name):
    """The ADSR's backward in the kernel's order against the plain adjoint
    and jax.vjp of the JAX package's adsr_scan_ref: cuts at sample 0, by an
    edge in SUSTAIN or IDLE, by a triggered expiry, none (the state out's
    and env_next's cotangents counted), edges at the first and the last
    sample, counts near and at 2**24, a state outside the closed form, T
    past one tile of 16384 samples."""
    plain, jx, _ = adsr_errors(name, seed=len(name))
    assert plain <= TOL, plain
    assert jx <= TOL, jx


def test_adsr_backward_cases_cut_where_named():
    """The cases cut where their names say: the plain walk reads to the
    cut, or the whole call."""
    walked = {name: adsr_errors(name)[2] for name in (
        "cut at sample 0", "edge at sample 0", "no cut: the live tail", "edge in SUSTAIN",
        "edge in IDLE", "past one tile, cut in the second", "past one tile, no cut")}
    assert walked["cut at sample 0"] == 1
    assert walked["edge in SUSTAIN"] == 400 + 1  # the gate falls at 400
    assert walked["edge in IDLE"] == 700 + 1
    assert walked["no cut: the live tail"] == ADSR_T
    assert 16384 < walked["past one tile, cut in the second"] < 16384 + 700
    assert walked["past one tile, no cut"] == 16384 + 700
    assert walked["edge at sample 0"] > 1


if __name__ == "__main__":
    for linear in (True, False):
        plain, jx = slew_errors(linear, seed=3 + linear)
        print(f"slew linear={linear}: plain {max(plain):.3g}, jax {max(jx):.3g}")
    for name in ADSR_CASES:
        plain, jx, walked = adsr_errors(name, seed=len(name))
        print(f"adsr {name} (walked {walked}): plain {plain:.3g}, jax {jx:.3g}")
