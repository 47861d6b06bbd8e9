"""PyTorch port: the ADSR's absolute-clock branch in its kernel's order.

``ops/adsr.adsr_clock_scan_runs`` is the order of ``csrc/adsr_scan.cu``
``adsr_clock``: tiles of ``CLOCK_TILE`` samples, the triggers compacted,
one walk over the events and the runs (``adsr_clock_runs``: a ramp's
envelope within a binade is m u, each update adding the same n u, so a run
is ``e0 + j delta``, exact in float64), every sample evaluated from its
run; a tile with many triggers walked sample by sample. It is held here to
the plain loop, ``adsr_clock_scan_ref``, bit for bit (the envelope's
float32 bits, the stage, the float64 envelope's bits and the int64
deadline), under hypothesis with a fixed seed: random slopes and slopes of
a power of two (every update a tie), sustains of 0 and 2**24 - 1 samples,
entering states in each stage, deadlines that fall in a later call, dense
and sparse triggers, walks cut short by a small record budget. Then
``AdsrTriggeredPE`` with a sustain of 0 samples and one of 2**24 samples
or more, rendered on the port's CPU block by block, against the JAX PE
(1e-5, the JAX tests' PE tolerance) and, with the run order in place of
the plain loop, against the port's own render bit for bit. On the card the
kernel is held to the plain loop bit for bit (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 5).
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, seed, settings
from hypothesis import strategies as st

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu_torch.ops import adsr

torch.set_num_threads(1)

SR = 44100.0


def _bits(a, b) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a, b)


def _state(stage, env, ends):
    return (torch.tensor(stage, dtype=torch.int32), torch.tensor(env, dtype=torch.float64),
            torch.tensor(ends, dtype=torch.int64))


def _same(got, want):
    y, st_ = got
    y_ref, st_ref = want
    assert _bits(y, y_ref), f"envelope off by {float((y - y_ref).abs().max())}"
    for a, b in zip(st_, st_ref):
        assert _bits(a, b), (a, b)


def _slopes(kind, times, sus):
    """(dA, dD, dR) as the PE forms them from seconds, or powers of two."""
    if kind == "pow2":
        a, d, r = times
        return 2.0 ** -a, -(2.0 ** -d), -(2.0 ** -r)
    a, d, r = times
    return 1.0 / (a * SR), (sus - 1.0) / (d * SR), -max(sus, 1e-3) / (r * SR)


def _trigger(kind, T, rng):
    g = np.zeros(T, np.float32)
    if kind == "sparse":
        g[rng.integers(0, T, size=3)] = 1.0
    elif kind == "dense":
        g[rng.random(T) < 0.4] = rng.uniform(0.1, 1.0)
    elif kind == "held":
        g[:] = 1.0
    return torch.from_numpy(g)


@seed(22)
@settings(max_examples=120, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    slope_kind=st.sampled_from(["seconds", "pow2"]),
    seconds=st.tuples(*[st.floats(0.0002, 0.05)] * 3),
    exps=st.tuples(*[st.integers(2, 14)] * 3),
    sus=st.sampled_from([0.0, 0.25, 0.6, 0.7, 1.0, 0.123456789]),
    sustain=st.sampled_from([0, 1, 7, 300, 2**24 - 1]),
    stage=st.integers(0, 4),
    env=st.sampled_from(["zero", "sus", "one", "mid"]),
    deadline=st.integers(-40, 2000),
    trig=st.sampled_from(["none", "sparse", "dense", "held"]),
    T=st.integers(1, 2500),
    walk=st.sampled_from([(adsr.CLOCK_DENSE_ABOVE, adsr.CLOCK_RECORDS), (10**9, 5),
                          (10**9, adsr.CLOCK_RECORDS), (-1, adsr.CLOCK_RECORDS)]),
    data_seed=st.integers(0, 2**16),
)
def test_run_order_equals_plain_loop(slope_kind, seconds, exps, sus, sustain, stage, env,
                                     deadline, trig, T, walk, data_seed):
    rng = np.random.default_rng(data_seed)
    dA, dD, dR = _slopes(slope_kind, exps if slope_kind == "pow2" else seconds, sus)
    e0 = {"zero": 0.0, "sus": sus, "one": 1.0, "mid": float(rng.uniform(0.0, 1.0))}[env]
    t0 = int(rng.integers(0, 10**7))
    args = (_trigger(trig, T, rng), *_state(stage, e0, t0 + deadline))
    kw = dict(t0=t0, dA=dA, dD=dD, dR=dR, sus=sus, sustain_samples=sustain)
    dense_above, records = walk
    _same(adsr.adsr_clock_scan_runs(*args, **kw, dense_above=dense_above, records=records),
          adsr.adsr_clock_scan_ref(*args, **kw))


@pytest.mark.parametrize("sustain", [0, 150, 2**24 - 1])
@pytest.mark.parametrize("cut", [1, 200, 777, 2999])
def test_run_order_hands_off_across_calls(sustain, cut):
    """A call cut in two, the state (and a deadline armed in the first)
    carried into the second, equals one call of the plain loop."""
    T = 3000
    g = torch.zeros(T)
    g[[5, 1500, 2600]] = 1.0
    kw = dict(dA=1 / 220.5, dD=-0.4 / 441.0, dR=-0.6 / 882.0, sus=0.6, sustain_samples=sustain)
    state = _state(0, 0.0, 0)
    want = adsr.adsr_clock_scan_ref(g, *state, t0=1000, **kw)
    first = adsr.adsr_clock_scan_runs(g[:cut], *state, t0=1000, **kw)
    second = adsr.adsr_clock_scan_runs(g[cut:], *first[1], t0=1000 + cut, **kw)
    _same((torch.cat([first[0], second[0]]), second[1]), want)


def test_records_count_the_binades():
    """A pluck (one trigger, a sustain of 0 samples): tens of records, not
    thousands of samples; a record's samples lie in one binade."""
    g = [0.0] * 16384
    g[100] = 1.0
    kw = dict(dA=1 / 441.0, dD=-0.4 / 2205.0, dR=-0.6 / 4410.0, sus=0.6, sustain_samples=0)
    recs, stop, _ = adsr.adsr_clock_runs(g, 0, 0.0, 0, t0=0, stop=16384, records=10**6, **kw)
    assert stop == 16384 and 10 < len(recs) < 120
    bounds = [r[0] for r in recs] + [16384]
    for (s0, v0, dl), s1 in zip(recs, bounds[1:]):
        if dl != 0.0 and v0 > 0.0:
            last = v0 + (s1 - s0 - 1) * dl
            assert math.frexp(last)[1] == math.frexp(v0)[1]
    y_ref, _ = adsr.adsr_clock_scan_ref(torch.tensor(g), *_state(0, 0.0, 0), t0=0, **kw)
    assert float(y_ref.max()) == 1.0


# ---- AdsrTriggeredPE on its clock branch, block by block ----

CLOCK_PES = {
    # a pluck: sustain 0 samples, retriggered
    "sustain_0": lambda pg: pg.AdsrTriggeredPE(pg.PeriodicTrigger(hz=7.0), 0.004, 0.02, 0.0,
                                               0.6, 0.03),
    # a drum: one trigger, A = D = 1 ms, no sustain
    "sustain_0_drum": lambda pg: pg.AdsrTriggeredPE(
        pg.ArrayPE(np.array([1.0] + [0.0] * 2999, np.float32)),
        attack_time=0.001, decay_time=0.001, sustain_time=0.0, release_time=0.02),
    # a sustain of 400 s (17,640,000 samples >= 2**24)
    "sustain_400_s": lambda pg: pg.AdsrTriggeredPE(pg.PeriodicTrigger(hz=11.0), 0.002, 0.005,
                                                   400.0, 0.7, 0.01),
}
CLOCK_N = 3000


def _render(pg, name, block):
    graph = pg.CropPE(CLOCK_PES[name](pg), 0, CLOCK_N)
    kw = {"device": "cpu"} if pg is tpg else {}
    return np.asarray(pg.render_to_array(graph, block=block, **kw))


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


@pytest.mark.parametrize("block", [256, 1000])
@pytest.mark.parametrize("name", sorted(CLOCK_PES))
def test_clock_pe_matches_jax_block_by_block(name, block, monkeypatch):
    assert round(400.0 * SR) + 1 >= 1 << 24
    want = _render(jpg, name, block)
    got = _render(tpg, name, block)
    assert got.shape == want.shape == (CLOCK_N, 1) and np.abs(want).max() == 1.0
    for b0 in range(0, CLOCK_N, block):  # each block of the render
        np.testing.assert_allclose(got[b0:b0 + block], want[b0:b0 + block], rtol=0, atol=1e-5)
    # the PE with the kernel's order in place of the plain loop: the same bits
    monkeypatch.setattr(adsr, "adsr_clock_scan_ref", adsr.adsr_clock_scan_runs)
    runs = _render(tpg, name, block)
    assert np.array_equal(runs.view(np.int32), got.view(np.int32))
