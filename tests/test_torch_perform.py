"""PyTorch port: the generative performance (``perform_workload``) as a
whole, against the JAX package's render on the CPU.

The graph is built from each package by the same function; at 0.5 s and
block 4096 the port's render must lie within 1e-4 of the JAX render
(observed within 3.6e-7: the HRTFs' FFTs and SuperSawPE's BLIT are the
only inexact parts). On the CPU the ladder and the ADSR run their plain
versions: no kernel launches.
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu_torch import perform_workload as pw
from pygmu2_tpu_torch.ops import adsr, ladder

torch.set_num_threads(1)

SECONDS = 0.5


@pytest.fixture(scope="module")
def renders():
    want = np.asarray(jpg.render_to_array(pw.build_performance(jpg, SECONDS), block=4096))
    before = (ladder.ladder_scan.launches, adsr.adsr_scan.launches)
    got = tpg.render_to_array(pw.build_performance(tpg, SECONDS), block=4096, device="cpu")
    after = (ladder.ladder_scan.launches, adsr.adsr_scan.launches)
    return want, got, before, after


def test_performance_matches_jax(renders):
    want, got, _, _ = renders
    assert got.shape == want.shape == (int(SECONDS * pw.SR), 2)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_cpu_render_launches_no_kernel(renders):
    _, _, before, after = renders
    assert before == after


def test_full_size_graph():
    root = pw.build_performance(tpg)
    assert root.extent().start == 0 and root.extent().end == 2_646_000
    assert root.channel_count() == 2
    assert -(-2_646_000 // pw.BLOCK) == 162
    kinds = {type(pe).__name__ for pe in tpg.core.engine._walk(root)}
    for name in ("PortamentoPE", "PiecewisePE", "SuperSawPE", "AnalogOscPE", "LadderPE",
                 "AdsrGatedPE", "RandomPE", "RandomSelectPE", "TriggerPE", "TriggerRestartPE",
                 "ResetPE", "SpatialPE", "NoisePE", "BlitSawPE", "ArrayPE", "MixPE"):
        assert name in kinds, name
    assert np.array_equal(pw.melody(0), pw.melody(0)) and pw.melody(0).min() >= 48
    assert pw.melody(0).max() <= 72 and len(pw.melody(0)) == 120
