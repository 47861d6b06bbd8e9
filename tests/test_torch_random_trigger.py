"""PyTorch port: RandomPE and the trigger family (RandomSelectPE,
TriggerPE, TriggerRestartPE, ResetPE) against the JAX package on the CPU,
across two block splits, bit for bit.

RandomPE's values are the counter hash of the JAX package, its range
scaling XLA's fused multiply-add of the hash word. The walks step over
their events on the host with the JAX program's float32 operations: XLA
folds ``step_size * span`` into one float32 constant and
``v - lo - span`` into one subtraction, in the per-segment scan, the
per-sample scan (a clocked walk near the sample rate) and the triggered
scan alike. The clip players' sources are PEs the port renders bit for
bit (ArrayPE, AnalogOscPE, NoisePE), so their outputs are held bit for
bit too.
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _render(pg, graph, block):
    if pg is tpg:
        return tpg.render_to_array(graph, block=block, device="cpu")
    return np.asarray(pg.render_to_array(graph, block=block))


def _check(build, blocks=(4096, 1000)):
    """The JAX render at one block size, the port's at two, bit for bit."""
    want = _render(jpg, build(jpg), blocks[0])
    assert np.abs(want).max() > 0
    for block in blocks:
        np.testing.assert_array_equal(_render(tpg, build(tpg), block), want)


MODES = ["SAMPLE_HOLD", "LINEAR", "SMOOTH", "WALK"]
RANGES = [(0.0, 1.0), (-0.3, 0.7), (-2.37, 5.11)]


@pytest.mark.parametrize("rng", RANGES, ids=["unit", "offset", "wide"])
@pytest.mark.parametrize("mode", MODES)
def test_random_clocked(mode, rng):
    # 97.3 Hz: the walk's per-segment scan (few segments a block)
    _check(lambda pg: pg.CropPE(pg.RandomPE(97.3, *rng, getattr(pg.RandomMode, mode), seed=4,
                                            step_size=0.43), 0, 20000))


@pytest.mark.parametrize("mode", MODES)
def test_random_clocked_near_sample_rate(mode):
    # 15 kHz: the walk's per-sample scan
    _check(lambda pg: pg.CropPE(pg.RandomPE(15000.0, 0.13, 1.91, getattr(pg.RandomMode, mode),
                                            seed=2, step_size=0.3), 0, 5000), blocks=(1000, 512))


@pytest.mark.parametrize("rng", RANGES, ids=["unit", "offset", "wide"])
@pytest.mark.parametrize("mode", MODES)
def test_random_triggered(mode, rng):
    _check(lambda pg: pg.CropPE(pg.RandomPE(1.0, *rng, getattr(pg.RandomMode, mode), seed=9,
                                            step_size=0.41,
                                            trigger=pg.PeriodicTrigger(231.0)), 0, 20000))


def test_random_walk_triggered_by_a_gate():
    """Every positive sample of a gate is a trigger: hundreds of events a
    block, stepped in order."""
    _check(lambda pg: pg.CropPE(pg.RandomPE(1.0, 0.1, 0.9, pg.RandomMode.WALK, seed=1,
                                            step_size=0.37, trigger=pg.PeriodicGate(50.0)),
                                0, 5000), blocks=(1000, 512))


def test_random_unseeded_and_offset_start():
    _check(lambda pg: pg.CropPE(pg.RandomPE(5.0, mode=pg.RandomMode.WALK), 50000, 8000))
    _check(lambda pg: pg.CropPE(pg.RandomPE(5.0, -1.0, 1.0, pg.RandomMode.SMOOTH), 50000, 8000))


def test_random_walk_state_round_trips_through_a_checkpoint():
    build = lambda pg: pg.RandomPE(1.0, -2.0, 2.0, pg.RandomMode.WALK, seed=3,  # noqa: E731
                                   trigger=pg.PeriodicTrigger(40.0))
    pe = build(tpg)
    pe.render(0, 3000, device="cpu")
    snap = tpg.checkpoint_state(pe)
    want = pe.render(3000, 3000, device="cpu").data
    again = build(tpg)
    tpg.restore_state(again, snap)
    np.testing.assert_array_equal(again.render(3000, 3000, device="cpu").data, want)
    whole = _render(jpg, jpg.CropPE(build(jpg), 0, 6000), 6000)
    np.testing.assert_array_equal(want, whole[3000:])


def test_random_clocked_walk_restored_over_its_own_state():
    """A restored snapshot replaces the state a clocked walk stored last:
    the walk carries on from the snapshot's values, not its own."""
    build = lambda pg: pg.RandomPE(200.0, -2.0, 2.0, pg.RandomMode.WALK, seed=5)  # noqa: E731
    pe = build(tpg)
    pe.render(0, 3000, device="cpu")
    snap = tpg.checkpoint_state(pe)
    want = pe.render(3000, 3000, device="cpu").data
    again = build(tpg)
    again.render(0, 5000, device="cpu")  # a state of its own first
    tpg.restore_state(again, snap)
    np.testing.assert_array_equal(again.render(3000, 3000, device="cpu").data, want)
    whole = _render(jpg, jpg.CropPE(build(jpg), 0, 6000), 6000)
    np.testing.assert_array_equal(want, whole[3000:])


N = 20000


def _clip(pg, n, kind):
    if kind == "array":
        return pg.ArrayPE(np.random.default_rng(n).standard_normal((n, 2)).astype(np.float32))
    if kind == "rect":
        return pg.CropPE(pg.AnalogOscPE(220.0, channels=2), 0, n)
    if kind == "saw":
        return pg.CropPE(pg.AnalogOscPE(110.0, 0.3, "sawtooth", channels=2), 0, n)
    return pg.CropPE(pg.SpatialPE(pg.NoisePE(seed=3), method=pg.SpatialAdapter(2)), 0, n)


@pytest.mark.parametrize("n", [300, 3000, 6000], ids=["short", "mid", "over_a_block"])
def test_trigger_restart(n):
    _check(lambda pg: pg.CropPE(pg.TriggerRestartPE(pg.PeriodicTrigger(7.0), _clip(pg, n, "array")),
                                0, N), blocks=(1000, 512))


@pytest.mark.parametrize("mode", ["ONE_SHOT", "GATED"])
@pytest.mark.parametrize("n", [300, 3000, 6000], ids=["short", "mid", "over_a_block"])
def test_trigger_pe(mode, n):
    _check(lambda pg: pg.CropPE(pg.TriggerPE(pg.PeriodicGate(9.0, duty_cycle=0.3),
                                             _clip(pg, n, "rect"),
                                             getattr(pg.TriggerMode, mode)), 0, N),
           blocks=(1000, 512))


def test_trigger_pe_one_shot_ignores_edges_while_playing():
    """A clip longer than the gate's period: ONE_SHOT accepts only the
    edges that find it idle (several jumps a block at block 4096)."""
    _check(lambda pg: pg.CropPE(pg.TriggerPE(pg.PeriodicGate(40.0), _clip(pg, 1500, "saw")),
                                0, N), blocks=(4096, 333))


@pytest.mark.parametrize("n", [300, 6000], ids=["short", "over_a_block"])
def test_reset_pe(n):
    _check(lambda pg: pg.CropPE(pg.ResetPE(_clip(pg, n, "saw"), pg.PeriodicTrigger(3.0)), 0, N),
           blocks=(1000, 512))


def test_reset_pe_offset_source():
    _check(lambda pg: pg.CropPE(pg.ResetPE(pg.CropPE(pg.AnalogOscPE(330.0, 0.2),
                                                     700, 2000),
                                           pg.PeriodicGate(4.0)), 0, N), blocks=(1000, 512))


@pytest.mark.parametrize("weights", [[4, 2, 1, 1], None], ids=["weighted", "uniform"])
def test_random_select(weights):
    kinds = ["array", "rect", "saw", "noise"]
    _check(lambda pg: pg.CropPE(pg.RandomSelectPE(pg.PeriodicTrigger(11.0),
                                                  [_clip(pg, 400 * (k + 1), kind)
                                                   for k, kind in enumerate(kinds)],
                                                  weights=weights, seed=5), 0, N),
           blocks=(1000, 4096))


def test_finite_source_required():
    with pytest.raises(ValueError, match="finite extent"):
        tpg.render_to_array(tpg.CropPE(tpg.TriggerRestartPE(tpg.PeriodicTrigger(2.0),
                                                            tpg.SinePE(440.0)), 0, 100),
                            device="cpu")
