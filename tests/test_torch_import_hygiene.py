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
    # every module of the port, found on disk
    pkg = ROOT / "pygmu2_tpu_torch"
    modules = sorted(
        ".".join(path.relative_to(ROOT).with_suffix("").parts)
        for path in pkg.rglob("*.py")
        if path.name != "__init__.py"
    ) + ["pygmu2_tpu_torch.assets"]
    assert "pygmu2_tpu_torch.core.engine" in modules
    assert "pygmu2_tpu_torch.ops.ladder" in modules
    for name in ("ops.ks", "ops.envelope", "ops.slew", "ops.reverse_echo",
                 "models.holds", "models.dynamics", "models.filters",
                 "models.reverse_echo", "fx_workload", "ops.linrec_kernel",
                 "ops.xla_math", "filter_workload", "ops.interp", "ops.noise",
                 "ops.fftconv", "models.io_pes", "models.lookup", "models.delay",
                 "models.loop_slice", "models.noise", "models.tralfam",
                 "models.convolve", "utils.flacio", "studio_workload",
                 "utils.temperament", "utils.conversions", "models.piecewise",
                 "models.portamento", "models.random_control", "models.trigger_restart",
                 "models.spatial", "utils.debug", "utils.assets", "utils.profiling",
                 "core.audio_renderer", "perform_workload", "__main__", "ops.diffable",
                 "fit_workload"):
        assert f"pygmu2_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        "import pygmu2_tpu_torch\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
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


def test_cpu_pe_graph_render_launches_no_kernel():
    from pygmu2_tpu_torch import patch_workload
    from pygmu2_tpu_torch.ops import adsr, comb, ladder
    from pygmu2_tpu_torch.utils.playback import render_to_array

    counters = (ladder.ladder_scan, comb.comb_scan, adsr.adsr_scan)
    before = [fn.launches for fn in counters]
    import pygmu2_tpu_torch as pg

    out = render_to_array(patch_workload.build_patch(pg, 0.02), device="cpu")
    assert out.shape == (882, 1) and abs(out).max() > 0.01
    assert [fn.launches for fn in counters] == before
    if not torch.cuda.is_available():
        assert before == [0, 0, 0]


def test_cpu_fx_chain_render_launches_no_kernel():
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import fx_workload
    from pygmu2_tpu_torch.ops import envelope, ks, reverse_echo, slew

    counters = (ks.ks_scan, envelope.envelope_ar_scan, slew.slew_scan,
                reverse_echo.reverse_echo_scan)
    before = [fn.launches for fn in counters]
    out = pg.render_to_array(fx_workload.build_chain(pg, 0.02), device="cpu")
    assert out.shape == (882, 1) and abs(out).max() > 0.01
    assert [fn.launches for fn in counters] == before
    if not torch.cuda.is_available():
        assert before == [0, 0, 0, 0]


def test_wrapper_refuses_other_devices():
    wave = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fk.osc_filter_gain_mix({}, wave, 8)


def test_cpu_filter_bank_and_high_score_launch_no_kernel():
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import filter_workload
    from pygmu2_tpu_torch.ops import linrec_kernel
    from pygmu2_tpu_torch.soundfont import MidiFile

    counters = (linrec_kernel.affine_scan_2_kernel, fk.filter_gain_mix)
    before = [fn.launches for fn in counters]
    out = pg.render_to_array(filter_workload.build_filter_bank(pg, 0.1), block=4096,
                             device="cpu")
    assert out.shape == (4410, 128) and abs(out).max() > 0.01
    synth, _ = bench_workload.build_workload(True)
    pcm = render_midi_offline(synth, MidiFile(bench_workload.build_high_midi_bytes(0.5)), 0.5,
                              device="cpu")
    assert pcm.shape == (22050, 2) and abs(pcm).max() > 0.01
    assert [fn.launches for fn in counters] == before
    if not torch.cuda.is_available():
        assert before == [0, 0]


def test_cpu_streaming_synth_launches_no_kernel():
    from pygmu2_tpu_torch.ops import linrec_kernel
    from pygmu2_tpu_torch.soundfont import SoundFont, Synthesizer, SynthesizerSettings

    before = linrec_kernel.affine_scan_2_kernel.launches
    synth = Synthesizer(SoundFont(bench_workload.build_font_bytes(False)),
                        SynthesizerSettings(block_size=256, maximum_polyphony=8), device="cpu")
    synth.note_on(0, 60, 100)
    out = synth.render_stereo(1000)
    assert out.shape == (1000, 2) and abs(out).max() > 0.01
    assert linrec_kernel.affine_scan_2_kernel.launches == before


def test_streaming_synth_on_a_missing_card_raises():
    """No fallback: a synthesizer on the card (the default) where there is
    none fails at its first block; it does not render on the CPU."""
    from pygmu2_tpu_torch.soundfont import SoundFont, Synthesizer, SynthesizerSettings

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    synth = Synthesizer(SoundFont(bench_workload.build_font_bytes(False)),
                        SynthesizerSettings(block_size=256, maximum_polyphony=8))
    synth.note_on(0, 60, 100)
    with pytest.raises((RuntimeError, AssertionError)):
        synth.render_stereo(256)


def test_port_exports_cover_the_jax_package():
    """Every public name of the JAX package is exported by the port
    (``browse`` since its player became a module of the port), and
    resolves."""
    import pygmu2_tpu
    import pygmu2_tpu_torch

    missing = set(pygmu2_tpu.__all__) - set(pygmu2_tpu_torch.__all__)
    assert missing == set()
    assert len(set(pygmu2_tpu_torch.__all__)) == len(pygmu2_tpu_torch.__all__)
    for name in pygmu2_tpu_torch.__all__:
        assert hasattr(pygmu2_tpu_torch, name), name
    assert pygmu2_tpu_torch.__version__ == pygmu2_tpu.__version__


def test_cpu_performance_launches_no_kernel():
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import perform_workload
    from pygmu2_tpu_torch.ops import adsr, ladder

    before = (ladder.ladder_scan.launches, adsr.adsr_scan.launches)
    out = pg.render_to_array(perform_workload.build_performance(pg, 0.01), device="cpu")
    assert out.shape == (441, 2) and abs(out).max() > 0.01
    assert (ladder.ladder_scan.launches, adsr.adsr_scan.launches) == before


def test_main_renders_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "pygmu2_tpu_torch", "0.2", "--device", "cpu"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "realtime" in proc.stdout and "device=cpu" in proc.stdout
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", "pygmu2_tpu_torch", "0.2"], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr
