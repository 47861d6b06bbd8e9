"""PyTorch port: LoopPE, SlicePE and SequencePE against the JAX package on
the CPU.

Inputs are made with numpy from a seed. LoopPE's seam mirrors XLA's
contraction (the blend's product of the loop's start fused into the sum)
and its reciprocal product, so loops are held bit for bit, as are slices
and sequences whose items do not overlap. Where faded items overlap, XLA
fuses the left item's fade product into the sum through the items'
masks, which MixPE's contraction rule does not read (ROADMAP queue 3):
those sequences are held at 1e-5, the per-PE bound (they sit within
2.4e-7).
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg

torch.set_num_threads(1)

N = 2048
X = np.random.default_rng(1).standard_normal((3000, 2)).astype(np.float32)


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _slices(pg, n, step, fades=True):
    kw = {"fade_in_seconds": 0.001, "fade_out_seconds": 0.002} if fades else {}
    return [(pg.SlicePE(pg.ArrayPE(X), 100 * i, 400, **kw), step * i) for i in range(n)]


GRAPHS = {
    "loop": lambda pg: pg.CropPE(pg.LoopPE(pg.ArrayPE(X[:700])), 0, N),
    "loop_region": lambda pg: pg.CropPE(pg.LoopPE(pg.ArrayPE(X), 250, 777), 0, N),
    "loop_count": lambda pg: pg.LoopPE(pg.ArrayPE(X[:300]), count=5),
    "loop_crossfade": lambda pg: pg.CropPE(
        pg.LoopPE(pg.ArrayPE(X[:700]), 100, 650, crossfade_seconds=0.002), 0, N),
    "loop_long_crossfade": lambda pg: pg.CropPE(
        pg.LoopPE(pg.ArrayPE(X[:400]), crossfade_seconds=1.0), 0, N),
    "slice": lambda pg: pg.SlicePE(pg.ArrayPE(X), 300, 1500),
    "slice_faded": lambda pg: pg.SlicePE(pg.ArrayPE(X), 300, 1500, fade_in_seconds=0.005,
                                         fade_out_seconds=0.01),
    "slice_fade_longer_than_slice": lambda pg: pg.SlicePE(
        pg.ArrayPE(X), 10, 100, fade_in_seconds=0.01, fade_out_seconds=0.01),
    "sequence_apart": lambda pg: pg.SequencePE(_slices(pg, 5, 450)),
    "sequence_overlap": lambda pg: pg.SequencePE(_slices(pg, 6, 250)),
    "sequence_non_overlap": lambda pg: pg.SequencePE(
        _slices(pg, 6, 250, fades=False), mode=pg.SequenceMode.NON_OVERLAP),
    "sequence_auto_advance": lambda pg: pg.SequencePE(
        [(pg.SlicePE(pg.ArrayPE(X), 100 * i, 300), None) for i in range(4)]),
    "sequence_single": lambda pg: pg.SequencePE(pg.SlicePE(pg.ArrayPE(X), 0, 500), 123),
    "sequence_of_loops": lambda pg: pg.CropPE(pg.SequencePE(
        [(pg.LoopPE(pg.ArrayPE(X[:200]), count=3), 0),
         (pg.LoopPE(pg.ArrayPE(X[200:350]), count=4), 700)], mode="non_overlap"), 0, N),
}
TOL = {"sequence_overlap": 1e-5}


def _render(pg, graph, block):
    if pg is tpg:
        return tpg.render_to_array(graph, block=block, device="cpu")
    return np.asarray(pg.render_to_array(graph, block=block))


@pytest.mark.parametrize("block", [256, 1000])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_matches_jax(name, block):
    want = _render(jpg, GRAPHS[name](jpg), block)
    got = _render(tpg, GRAPHS[name](tpg), block)
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL.get(name, 0.0))


def test_sequence_items_and_extent_match_jax():
    seqs = [pg.SequencePE([(pg.SlicePE(pg.ArrayPE(X), 0, 300), None),
                           (pg.SlicePE(pg.ArrayPE(X), 0, 200), 1000),
                           (pg.SlicePE(pg.ArrayPE(X), 0, 100), None)]) for pg in (jpg, tpg)]
    assert [s for _, s in seqs[1].items] == [s for _, s in seqs[0].items] == [0, 1000, 1200]
    e, f = seqs[1].extent(), seqs[0].extent()
    assert (e.start, e.end) == (f.start, f.end) == (0, 1300)


def test_loop_properties_match_jax():
    loops = [pg.LoopPE(pg.ArrayPE(X[:500]), 20, 420, count=2, crossfade_seconds=0.5)
             for pg in (jpg, tpg)]
    for attr in ("crossfade_samples", "loop_start", "loop_end", "count"):
        assert getattr(loops[1], attr) == getattr(loops[0], attr)
    with pytest.raises(ValueError):
        tpg.LoopPE(tpg.ConstantPE(1.0))  # infinite extent, no loop_end
