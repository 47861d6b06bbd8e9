"""PyTorch port, PE-graph engine: pure and stateful graphs without serial
kernels, rendered by the port (``device="cpu"``) and by the JAX package.

Covers extent zero-fill and pruning, the per-block memo of a shared node,
state reset on a non-contiguous start, block invariance, ParamPE
bindings, checkpoint/restore, and the Renderer lifecycle. Pure graphs are
held to the JAX render at 1e-5 (the per-PE bound); block invariance at
1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu_torch.core import engine as tengine
from pygmu2_tpu_torch.utils import wavio

torch.set_num_threads(1)

N = 3000


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _tanh(pg):
    return jnp.tanh if pg is jpg else torch.tanh


def _render(pg, graph, **kw):
    if pg is tpg:
        kw["device"] = "cpu"
    return np.asarray(pg.render_to_array(graph, **kw))


def _both(build, **kw):
    return _render(jpg, build(jpg), **kw), _render(tpg, build(tpg), **kw)


def _table(channels=2, n=1200, seed=0):
    return np.random.default_rng(seed).standard_normal((n, channels)).astype(np.float32)


GRAPHS = {
    "sine": lambda pg: pg.CropPE(pg.SinePE(440.0, amplitude=0.5, phase=0.3), 0, N),
    "sine_modulated": lambda pg: pg.CropPE(
        pg.SinePE(pg.MixPE(pg.ConstantPE(300.0), pg.SinePE(3.0, amplitude=50.0)), 0.5),
        0, N,
    ),
    "sine_phase_pe": lambda pg: pg.CropPE(
        pg.SinePE(220.0, phase=pg.SinePE(2.0, amplitude=1.5)), 0, N
    ),
    "function_gen": lambda pg: pg.CropPE(pg.FunctionGenPE(97.0, duty_cycle=0.3), 0, N),
    "function_gen_modulated": lambda pg: pg.CropPE(
        pg.FunctionGenPE(
            pg.MixPE(pg.ConstantPE(40.0), pg.SinePE(1.0, amplitude=10.0)),
            duty_cycle=0.25, waveform="sawtooth",
        ),
        0, N,
    ),
    "gain_mix_identity": lambda pg: pg.CropPE(
        pg.MixPE(
            pg.GainPE(pg.SinePE(220.0), 0.3),
            pg.GainPE(pg.IdentityPE(), pg.ConstantPE(1e-4)),
        ),
        0, N,
    ),
    "array_dirac": lambda pg: pg.CropPE(
        pg.MixPE(pg.ArrayPE(_table()), pg.GainPE(pg.DiracPE(channels=2), 2.0)), 0, N
    ),
    "array_hold": lambda pg: pg.CropPE(
        pg.ArrayPE(_table(1, 500), extend_mode=pg.ExtendMode.HOLD_BOTH), 0, N
    ),
    "crop_hold_set_extent": lambda pg: pg.SetExtentPE(
        pg.CropPE(pg.SinePE(330.0), 700, 900, extend_mode=pg.ExtendMode.HOLD_BOTH),
        100, 2500,
    ),
    "transform": lambda pg: pg.CropPE(
        pg.TransformPE(pg.GainPE(pg.SinePE(110.0), 3.0), _tanh(pg)), 0, N
    ),
    "gates": lambda pg: pg.CropPE(
        pg.MixPE(pg.PeriodicGate(30.0, duty_cycle=0.2), pg.PeriodicTrigger(hz=70.0, phase=0.5)),
        0, N,
    ),
    "blit_saw": lambda pg: pg.CropPE(pg.BlitSawPE(220.0, amplitude=0.8, initial_phase=0.1), 0, N),
    "blit_saw_modulated": lambda pg: pg.CropPE(
        pg.BlitSawPE(pg.MixPE(pg.ConstantPE(180.0), pg.SinePE(4.0, amplitude=30.0))), 0, N
    ),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_matches_jax(name):
    want, got = _both(GRAPHS[name], block=1024)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_param_binding_matches_jax():
    def build(pg):
        return pg.CropPE(pg.GainPE(pg.SinePE(220.0), pg.ParamPE("g", default=0.5)), 0, N)

    for bindings in (None, {"g": 0.25}):
        want, got = _both(build, bindings=bindings)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() == pytest.approx(0.25, abs=1e-3)


def test_extent_zero_fill_and_pruning():
    def build(pg):
        a = pg.CropPE(pg.SinePE(440.0), 1000, 500)
        b = pg.CropPE(pg.GainPE(pg.SinePE(660.0), 0.5), 2500, 300)
        return pg.MixPE(a, b)

    ext = tpg.Extent(0, 4000)
    want = _render(jpg, build(jpg), extent=jpg.Extent(0, 4000), block=512)
    got = _render(tpg, build(tpg), extent=ext, block=512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    live = np.zeros(4000, bool)
    live[1000:1500] = live[2500:2800] = True
    assert not got[~live].any() and np.abs(got[live]).min() >= 0.0
    assert np.abs(got[1000:1500]).max() > 0.9

    # a request wholly outside a node's extent never renders the node
    # (CropPE fills its own edges and always renders; a gained ArrayPE
    # has the extent [0, 1200) and does not)
    inner = tpg.GainPE(tpg.ArrayPE(_table(1)), 0.5)
    graph = tpg.MixPE(build(tpg), inner)
    calls = []
    orig = inner._trace
    inner._trace = lambda ctx: calls.append(ctx.start) or orig(ctx)
    out = tpg.render_to_array(graph, extent=ext, block=512, device="cpu")
    assert calls == [0, 512, 1024]  # the three blocks that meet [0, 1200)
    np.testing.assert_allclose(out[:1200, 0] - got[:1200, 0], 0.5 * _table(1)[:, 0],
                               rtol=0, atol=1e-6)


def test_shared_node_renders_once_per_block():
    def build(pg):
        s = pg.SinePE(220.0)
        return pg.CropPE(pg.MixPE(pg.GainPE(s, 0.5), pg.GainPE(s, 0.25)), 0, N)

    graph = build(tpg)
    shared = graph.source.inputs()[0].source
    calls = []
    orig = shared._trace
    shared._trace = lambda ctx: calls.append(ctx.start) or orig(ctx)
    got = tpg.render_to_array(graph, block=1024, device="cpu")
    assert calls == [0, 1024, 2048]
    want = _render(jpg, build(jpg), block=1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["blit_saw_modulated", "sine_modulated"])
def test_state_resets_on_non_contiguous_start(name):
    port, ref = GRAPHS[name](tpg).source, GRAPHS[name](jpg).source
    port.render(0, 700, device="cpu")
    ref.render(0, 700)
    got = port.render(5000, 700, device="cpu").data
    want = np.asarray(ref.render(5000, 700).data)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    fresh = GRAPHS[name](tpg).source.render(5000, 700, device="cpu").data
    np.testing.assert_array_equal(got, fresh)
    # a contiguous request carries the state on
    cont = port.render(5700, 700, device="cpu").data
    ref_cont = np.asarray(ref.render(5700, 700).data)
    np.testing.assert_allclose(cont, ref_cont, rtol=0, atol=1e-5)


def _stateful(pg):
    saw = pg.BlitSawPE(pg.MixPE(pg.ConstantPE(150.0), pg.SinePE(3.0, amplitude=40.0)))
    lfo = pg.SinePE(pg.MixPE(pg.ConstantPE(5.0), pg.SinePE(0.5, amplitude=2.0)), 0.5)
    return pg.CropPE(pg.GainPE(saw, lfo), 0, 4000)


@pytest.mark.parametrize("block", [512, 1000, 1333])
def test_block_invariance(block):
    whole = tengine.render_scan(_stateful(tpg), 0, 4000, 4000, device="cpu")
    chunked = tengine.render_scan(_stateful(tpg), 0, 4000, block, device="cpu")
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0, atol=1e-6)


def test_block_invariance_with_serial_kernels():
    def build(pg):
        src = pg.BlitSawPE(220.0)
        lad = pg.LadderPE(src, pg.MixPE(pg.ConstantPE(900.0), pg.SinePE(3.0, amplitude=400.0)), 0.6)
        env = pg.AdsrGatedPE(pg.PeriodicGate(40.0), 0.002, 0.004, 0.5, 0.003)
        return pg.CropPE(pg.CombPE(pg.GainPE(lad, env), 500.0, feedback=0.5), 0, 1200)

    whole = tengine.render_scan(build(tpg), 0, 1200, 1200, device="cpu")
    chunked = tengine.render_scan(build(tpg), 0, 1200, 256, device="cpu")
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0, atol=1e-6)


def test_checkpoint_restore_resumes_on_rebuilt_graph():
    full = tengine.render_scan(_stateful(tpg), 0, 4000, 1000, device="cpu").numpy()
    first = _stateful(tpg)
    tengine.render_scan(first, 0, 2000, 1000, device="cpu")
    snap = tpg.checkpoint_state(first)
    assert all(isinstance(v["next"], np.ndarray) and v["next"] == 2000 for v in snap.values())
    second = _stateful(tpg)
    tpg.restore_state(second, snap)
    rest = tengine.render_scan(second, 2000, 2000, 1000, device="cpu").numpy()
    np.testing.assert_allclose(rest, full[2000:], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="structure"):
        tpg.restore_state(tpg.CropPE(tpg.SinePE(1.0), 0, 10), snap)


def test_checkpoint_format_matches_jax():
    jgraph, tgraph = _stateful(jpg), _stateful(tpg)
    jengine.render_scan(jgraph, 0, 2000, 1000)
    tengine.render_scan(tgraph, 0, 2000, 1000, device="cpu")
    jsnap, tsnap = jengine.checkpoint_state(jgraph), tpg.checkpoint_state(tgraph)
    assert sorted(jsnap) == sorted(tsnap)

    def leaves(tree):
        if isinstance(tree, dict):
            return {k: leaves(v) for k, v in tree.items()}
        return (np.asarray(tree).shape, np.asarray(tree).dtype)

    for key in jsnap:
        assert leaves(tsnap[key]) == leaves(jsnap[key]), key


def test_renderer_lifecycle_and_profile(tmp_path):
    graph = GRAPHS["sine"](tpg)
    renderer = tpg.NullRenderer(sample_rate=44100, device="cpu")
    renderer.set_source(graph)
    renderer.enable_profiling()
    with renderer:
        renderer.start()
        renderer.render(0, 1000)
        renderer.render(1000, 1000)
        snippet = renderer.render_extent(0, N, block=1024)
    assert not renderer.started
    report = renderer.get_profile_report()
    assert report.render_calls == 2 and report.total_samples == 2000
    assert "RENDER PROFILE REPORT" in report.summary()
    want = _render(jpg, GRAPHS["sine"](jpg))
    np.testing.assert_allclose(snippet.data, want, rtol=0, atol=1e-5)

    path = tmp_path / "sine.wav"
    tpg.render_to_file(graph, str(path), device="cpu")
    data, sr = wavio.read_wav(str(path))
    assert sr == 44100
    np.testing.assert_allclose(data, want, rtol=0, atol=1e-5)


def test_validation_rejects_shared_stateful_node():
    saw = tpg.BlitSawPE(110.0)
    graph = tpg.CropPE(tpg.MixPE(saw, tpg.GainPE(saw, 0.5)), 0, 100)
    with pytest.raises(ValueError, match="not pure but has multiple sinks"):
        tpg.render_to_array(graph, device="cpu")
    with pytest.raises(RuntimeError, match="infinite extent"):
        tpg.render_to_array(tpg.SinePE(1.0), device="cpu")


def test_gate_signal_validation_on_render():
    gate = tpg.PeriodicGate(5.0)
    snip = gate.render(0, 20000, device="cpu")
    assert set(np.unique(snip.data)) == {0.0, 1.0}
    with pytest.raises(ValueError, match="outside"):
        tpg.GateSignal._validate_gate_array(np.full((10, 1), 0.5, np.float32))
