"""PyTorch port: what it imports, how its kernel build fails, and that CPU
renders never touch the kernel."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch import bench_workload
from pygmu2_tpu_torch.soundfont import filter_kernels as fk
from pygmu2_tpu_torch.soundfont.offline import render_midi_offline

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import pygmu2_tpu_torch\n"
        "import pygmu2_tpu_torch.bench_workload, pygmu2_tpu_torch._ext\n"
        "import pygmu2_tpu_torch.soundfont.offline\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'pygmu2_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_ext, "_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _ext.build()


def test_cpu_render_launches_no_kernel():
    before = fk.osc_filter_gain_mix.launches
    synth, midi = bench_workload.build_workload(False)
    out = render_midi_offline(synth, midi, 0.05, device="cpu")
    assert out.shape == (2205, 2) and abs(out).max() > 0.1
    assert fk.osc_filter_gain_mix.launches == before
    if not torch.cuda.is_available():
        assert before == 0


def test_wrapper_refuses_other_devices():
    wave = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fk.osc_filter_gain_mix({}, wave, 8)
