"""PyTorch port, the subtractive patch: each PE on a serial kernel against
its JAX PE, the patch and the bank (``patch_workload``) against the JAX
render, and a JAX checkpoint resumed in the port.

The port renders with ``device="cpu"`` (the kernels' plain versions); the
JAX package renders on the CPU backend, where its PEs take their
``lax.scan`` and closed-form paths. Tolerances: each PE 1e-5, the patch,
the bank and the checkpoint crossings 1e-4 (the repo's render bound).
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu_torch import patch_workload
from pygmu2_tpu_torch.core import engine as tengine

torch.set_num_threads(1)

SECONDS = 0.1
TOTAL = 4410
BLOCK = 2048
HALF = BLOCK  # a checkpoint after one whole block: its ``next`` cursor


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _render(pg, graph, block=BLOCK):
    kw = {"device": "cpu"} if pg is tpg else {}
    return np.asarray(pg.render_to_array(graph, block=block, **kw))


def _sweep(pg, center, depth, hz=3.0):
    return pg.MixPE(pg.ConstantPE(center), pg.SinePE(hz, amplitude=depth))


def _stereo_saw(pg):
    return pg.ArrayPE(patch_workload.detuned_saws(1500, seed=5, channels=2))


PES = {
    "ladder_lp24": lambda pg: pg.LadderPE(pg.BlitSawPE(110.0), _sweep(pg, 1200.0, 900.0), 0.45),
    "ladder_bp12_stereo_drive": lambda pg: pg.LadderPE(
        _stereo_saw(pg), 800.0, 0.9, mode=pg.LadderMode.BP12, drive=2.5
    ),
    "ladder_hp24_modulated_res": lambda pg: pg.LadderPE(
        _stereo_saw(pg), 3000.0, _sweep(pg, 0.5, 0.4), mode=pg.LadderMode.HP24
    ),
    "comb_modulated": lambda pg: pg.CombPE(pg.BlitSawPE(110.0), _sweep(pg, 220.0, 20.0, 0.5), 0.6),
    "comb_constant": lambda pg: pg.CombPE(_stereo_saw(pg), 330.0, feedback=0.8),
    "comb_feedback_pe": lambda pg: pg.CombPE(
        pg.BlitSawPE(220.0), 150.0, feedback=_sweep(pg, 0.0, 0.99, 5.0)
    ),
    "adsr_gated": lambda pg: pg.AdsrGatedPE(pg.PeriodicGate(12.0), 0.01, 0.02, 0.6, 0.015),
    "adsr_gated_many_edges": lambda pg: pg.AdsrGatedPE(
        pg.PeriodicGate(150.0, duty_cycle=0.3), 0.001, 0.002, 0.4, 0.001
    ),
    "adsr_triggered": lambda pg: pg.AdsrTriggeredPE(
        pg.PeriodicTrigger(hz=9.0), 0.005, 0.01, 0.02, 0.7, 0.01
    ),
    "adsr_triggered_retrigger": lambda pg: pg.AdsrTriggeredPE(
        pg.PeriodicTrigger(hz=40.0), 0.005, 0.01, 0.2, 0.7, 0.01
    ),
}


@pytest.mark.parametrize("name", sorted(PES))
def test_pe_matches_jax(name):
    n = 2000  # one block: one JAX compile per case

    def build(pg):
        return pg.CropPE(PES[name](pg), 0, n)

    want, got = _render(jpg, build(jpg), n), _render(tpg, build(tpg), n)
    assert got.shape == want.shape and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# AdsrTriggeredPE outside the float32 count's range (a sustain of 0
# samples, or 2**24 - 1 and more): the JAX PE's lax.scan branch in both
CLOCK_PES = {
    "sustain_0_periodic": lambda pg: pg.CropPE(
        pg.AdsrTriggeredPE(pg.PeriodicTrigger(hz=5.0), 0.005, 0.01, 0.0, 0.7, 0.01), 0, 3000
    ),
    # one trigger, A = D = 1 ms, R = 10 ms: the JAX render peaks at 1.0
    "sustain_0_one_trigger": lambda pg: pg.AdsrTriggeredPE(
        pg.ArrayPE(np.array([1.0] + [0.0] * 999, np.float32)),
        attack_time=0.001, decay_time=0.001, sustain_time=0.0, release_time=0.01,
    ),
    "sustain_2_24_minus_1": lambda pg: pg.CropPE(
        pg.AdsrTriggeredPE(pg.PeriodicTrigger(hz=30.0), 0.002, 0.003, (2**24 - 1) / 44100,
                           0.6, 0.01), 0, 3000,
    ),
}


def _clock_case(name, block):
    want = _render(jpg, CLOCK_PES[name](jpg), block)
    got = _render(tpg, CLOCK_PES[name](tpg), block)
    assert got.shape == want.shape and np.abs(want).max() == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_adsr_triggered_outside_the_kernels_range_raises():
    """Once refused; now a sustain of 0 samples renders as the JAX PE's."""
    _clock_case("sustain_0_periodic", 1024)


@pytest.mark.parametrize("name", ["sustain_0_one_trigger", "sustain_2_24_minus_1"])
def test_adsr_triggered_clock_matches_jax(name):
    assert round((2**24 - 1) / 44100 * 44100) == 2**24 - 1  # the case's sustain samples
    _clock_case(name, 1024)


def _build(pg, which):
    if which == "patch":
        return patch_workload.build_patch(pg, SECONDS)
    return patch_workload.build_bank(pg, SECONDS, seed=0)


@pytest.fixture(scope="module", params=["patch", "bank"])
def workload(request):
    """The JAX render of one workload in two calls, with the checkpoint
    taken between them: (which, full render, snapshot at HALF)."""
    which = request.param
    graph = _build(jpg, which)
    first = np.asarray(jengine.render_scan(graph, 0, HALF, BLOCK))
    snap = jengine.checkpoint_state(graph)
    rest = np.asarray(jengine.render_scan(graph, HALF, TOTAL - HALF, BLOCK))
    return which, np.concatenate([first, rest]), snap


def _layout(tree):
    if isinstance(tree, (dict, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: _layout(v) for k, v in items}
    return np.asarray(tree).shape, np.asarray(tree).dtype


def test_workload_matches_jax(workload):
    which, want, snap = workload
    graph = _build(tpg, which)
    got = _render(tpg, graph)
    channels = 1 if which == "patch" else patch_workload.BANK_CHANNELS
    assert got.shape == want.shape == (TOTAL, channels)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the port's snapshot has the JAX package's layout, leaf for leaf
    assert _layout(tpg.checkpoint_state(graph)) == _layout(snap)


def test_jax_checkpoint_resumes_in_port(workload):
    which, want, snap = workload
    graph = _build(tpg, which)
    tpg.restore_state(graph, snap)
    rest = tengine.render_scan(graph, HALF, TOTAL - HALF, BLOCK, device="cpu").numpy()
    np.testing.assert_allclose(rest, want[HALF:], rtol=0, atol=1e-4)
