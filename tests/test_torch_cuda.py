"""PyTorch port on the card: the CUDA kernel against its plain version.

Marked ``cuda``; every test skips where no CUDA device is present. On a
machine with the card and nvcc:
``python -m pytest tests/test_torch_cuda.py --noconftest`` (no JAX needed).
"""

import numpy as np
import pytest
import torch

from pygmu2_tpu_torch import bench_workload
from pygmu2_tpu_torch.soundfont import filter_kernels as fk
from pygmu2_tpu_torch.soundfont import offline as off
from pygmu2_tpu_torch.soundfont.convert import schedule_to_torch, to_torch

pytestmark = pytest.mark.cuda

SECONDS = 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(large, device):
    synth, midi = bench_workload.build_workload(large)
    par, ch, snap, _nb = synth.build_schedule(midi, SECONDS)
    planes, flags = schedule_to_torch(par, ch, snap, device)
    ctrl = off._control_device(
        *planes, synth.block_size, flags, int(synth._minimum_voice_duration),
        float(synth.sample_rate),
    )
    wave = to_torch(synth._wave, device)
    rows = dict(off._gain_rows(ctrl, synth.master_volume), **off._osc_rows(ctrl, wave))
    return rows, wave, synth.block_size


@pytest.mark.parametrize("large", [False, True], ids=["small_font", "large_font"])
def test_kernel_matches_plain(cuda, large):
    rows, wave, N = _rows(large, cuda)
    before = fk.osc_filter_gain_mix.launches
    got, st = fk.osc_filter_gain_mix(rows, wave, N)
    torch.cuda.synchronize()
    assert fk.osc_filter_gain_mix.launches == before + 1
    ref, st_ref = fk.osc_filter_gain_mix_ref(rows, wave, N)
    assert ref.abs().max() > 1.0
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=0, atol=1e-4)


def test_kernel_state_handoff(cuda):
    rows, wave, N = _rows(False, cuda)
    cut = rows["ratio"].shape[0] // 2
    one, st_one = fk.osc_filter_gain_mix(rows, wave, N)
    o1, st1 = fk.osc_filter_gain_mix({k: v[:cut] for k, v in rows.items()}, wave, N)
    o2, st2 = fk.osc_filter_gain_mix(
        {k: v[cut:] for k, v in rows.items()}, wave, N, st1
    )
    torch.testing.assert_close(torch.cat([o1, o2]), one, rtol=0, atol=1e-5)
    torch.testing.assert_close(st2, st_one, rtol=0, atol=1e-5)


def test_render_on_card_matches_cpu(cuda):
    synth, midi = bench_workload.build_workload(True)
    on_cpu = off.render_midi_offline(synth, midi, SECONDS, device="cpu")
    on_card = off.render_midi_offline(synth, midi, SECONDS, device=cuda)
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-4)
    streamed = off.render_midi_offline_streamed(
        synth, midi, SECONDS, seg_blocks=5, device=cuda
    )
    np.testing.assert_allclose(streamed, on_card, rtol=0, atol=1e-5)
