"""PyTorch port: SpatialPE with all four methods against the JAX package
on the CPU, across two block splits.

- SpatialAdapter, SpatialLinear and SpatialConstantPower bit for bit, with
  a constant and a dynamic (PE) azimuth, on 1-, 2- and 3-channel sources:
  the channel mean is a sum times 1/C; the linear law's ``/ 180`` is a
  product by its float32 reciprocal and ``1 - pan`` one fused
  multiply-add; the constant-power law's sine and cosine are glibc's; a
  constant azimuth's gains fold into one constant with the mean's 1/C.
- SpatialHRTF at 1e-5: the KEMAR IR read by path from the JAX package's
  asset folder, the convolution by FFT (pocketfft here, XLA's FFT there;
  observed within 4.2e-7), at a positive, a negative (L/R swapped) and an
  off-grid azimuth and elevation.
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.assets import get_kemar_dir as jax_kemar_dir
from pygmu2_tpu_torch.assets import get_kemar_dir, kemar_entries

torch.set_num_threads(1)

N = 6000


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _render(pg, graph, block):
    if pg is tpg:
        return tpg.render_to_array(graph, block=block, device="cpu")
    return np.asarray(pg.render_to_array(graph, block=block))


def _src(pg, channels):
    rng = np.random.default_rng(channels)
    return pg.ArrayPE(rng.uniform(-1, 1, (N, channels)).astype(np.float32))


def _check(build, atol=0.0):
    want = _render(jpg, build(jpg), 1000)
    assert np.abs(want).max() > 0.1
    for block in (1000, 512):
        got = _render(tpg, build(tpg), block)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("src_ch", [1, 2, 3, 5])
@pytest.mark.parametrize("out_ch", [1, 2, 4])
def test_adapter_bit_for_bit(src_ch, out_ch):
    _check(lambda pg: pg.SpatialPE(_src(pg, src_ch), method=pg.SpatialAdapter(out_ch)))


def _azimuth(pg, kind):
    if kind == "constant":
        return -61.7
    if kind == "hard_right":
        return 135.0  # clipped to 90
    return pg.RandomPE(3.0, -120.0, 120.0, pg.RandomMode.SMOOTH, seed=2)


@pytest.mark.parametrize("azimuth", ["constant", "hard_right", "dynamic"])
@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("law", ["SpatialLinear", "SpatialConstantPower"])
def test_pan_laws_bit_for_bit(law, channels, azimuth):
    _check(lambda pg: pg.SpatialPE(_src(pg, channels),
                                   method=getattr(pg, law)(_azimuth(pg, azimuth))))


@pytest.mark.parametrize("azimuth,elevation", [(30.0, 0.0), (-60.0, 10.0), (-47.3, 13.0),
                                               (170.0, -40.0)])
def test_hrtf_matches_jax(azimuth, elevation):
    _check(lambda pg: pg.SpatialPE(_src(pg, 2), method=pg.SpatialHRTF(azimuth, elevation)),
           atol=1e-5)


def test_hrtf_negative_azimuth_swaps_channels():
    ir_pos = tpg.SpatialHRTF(40.0)._load_ir(44100)
    ir_neg = tpg.SpatialHRTF(-40.0)._load_ir(44100)
    np.testing.assert_array_equal(ir_neg, ir_pos[:, ::-1])
    assert tpg.SpatialHRTF.hrtf_filename_for(-47.3, 13.0) == \
        jpg.SpatialHRTF.hrtf_filename_for(-47.3, 13.0)


def test_kemar_set_found_by_path(monkeypatch, tmp_path):
    assert get_kemar_dir() == jax_kemar_dir()
    entries = kemar_entries()
    assert len(entries) > 300 and entries[0][2].endswith(".wav")
    monkeypatch.setenv("PYGMU2_TPU_KEMAR_DIR", str(tmp_path))
    assert get_kemar_dir() == tmp_path and kemar_entries() == []


def test_hrtf_rejects_dynamic_position_and_extends_extent():
    with pytest.raises(ValueError, match="static"):
        tpg.SpatialHRTF(tpg.ConstantPE(10.0))
    pe = tpg.SpatialPE(_src(tpg, 1), method=tpg.SpatialHRTF(0.0))
    assert pe.extent().end == N + 127 and not pe.is_pure() and pe.channel_count() == 2
    with pytest.raises(TypeError):
        tpg.SpatialPE(_src(tpg, 1), method="hrtf")
