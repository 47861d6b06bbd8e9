"""PyTorch port: the studio workload (``pygmu2_tpu_torch/studio_workload.py``,
``chip_smoke.py`` phase 13) rendered through both packages on the CPU.

The whole graph at 2 s (the recording cut to 3 s): a tape under a live
rate control over a crossfaded loop, 32 faded FLAC slices sequenced behind
a fractional delay, a wavetable drone, brown noise following the loop's
RMS, a phase-scrambled stretch, a compressor and a convolution reverb,
into a WAV writer. Held to the JAX render within 1e-5 × peak (the FFTs
are libraries'; the brown walk and overlapping slices' sums round apart,
ROADMAP queue 3). The writer's file must equal the returned render bit
for bit, with exactly the rendered frames.
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu_torch import studio_workload as sw
from pygmu2_tpu_torch.core import engine as tengine
from pygmu2_tpu_torch.utils import wavio

torch.set_num_threads(1)

SECONDS = 2.0
TOTAL = int(round(SECONDS * sw.SR))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return sw.make_files(tmp_path_factory.mktemp("studio"), seed=0, source_seconds=3.0)


@pytest.fixture(scope="module")
def readers(files):
    """Each package's readers (the FLAC decoded once per package)."""
    return {pg: sw.readers(pg, files) for pg in (jpg, tpg)}


@pytest.fixture(scope="module")
def renders(readers, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("out")
    got = {}
    for pg in (jpg, tpg):
        path = str(out_dir / f"{pg.__name__}.wav")
        root, parts = sw.build_studio(pg, SECONDS, readers[pg], out_path=path)
        kw = {"device": "cpu"} if pg is tpg else {}
        got[pg] = (np.asarray(pg.render_to_array(root, **kw)), path, parts["writer"])
    return got


def test_studio_matches_jax(renders):
    want, got = renders[jpg][0], renders[tpg][0]
    assert got.shape == want.shape == (TOTAL, 2)
    peak = float(np.abs(want).max())
    assert np.isfinite(got).all() and peak > 0.1
    err = float(np.abs(got - want).max())
    print(f"studio at {SECONDS} s: max abs err {err:.3g}, peak {peak:.3g}")
    assert err <= 1e-5 * peak


def test_studio_file_is_the_render(renders):
    out, path, writer = renders[tpg]
    data, sr = wavio.read_wav(path)
    assert sr == sw.SR and writer.frames_written == TOTAL
    np.testing.assert_array_equal(data, out)


def test_studio_files_are_reproducible(files, tmp_path):
    again = sw.make_files(tmp_path, seed=0, source_seconds=3.0)
    for name, path in files.items():
        assert open(path, "rb").read() == open(again[name], "rb").read(), name


def test_studio_live_rate_change_through_program_run(readers):
    """ControlPE.set_value between blocks k and k+1 moves the tape from
    block k+1 on, in both packages alike (the tape alone, block 4096)."""
    outs = []
    for pg in (jpg, tpg):
        _, parts = sw.build_studio(pg, SECONDS, readers[pg])
        tape, rate = parts["tape"], parts["rate"]
        prog = (tengine.get_program(tape, 4096, "cpu") if pg is tpg
                else jengine.get_program(tape, 4096))
        blocks = [np.asarray(prog.run(0))]
        assert tape.position == pytest.approx(4096.0)
        rate.set_value(1.5)
        blocks.append(np.asarray(prog.run(4096)))
        assert tape.position == pytest.approx(4096.0 + 1.5 * 4096)
        tape.seek(100_000.0)
        blocks.append(np.asarray(prog.run(8192)))
        assert tape.position == pytest.approx(100_000.0 + 1.5 * 4096)
        outs.append(np.concatenate(blocks))
    np.testing.assert_array_equal(outs[1], outs[0])


def test_studio_render_functional_touches_no_state(readers):
    seconds = 0.25
    root, _ = sw.build_studio(tpg, seconds, readers[tpg])
    n = int(round(seconds * sw.SR))
    tengine.render_scan(root, 0, n // 2, 4096, device="cpu")  # leaves state behind
    walked = tengine._walk(root)
    held = [pe._eng_state for pe in walked]
    got = tengine.render_functional(root, 0, n, 4096, device="cpu").numpy()
    assert all(pe._eng_state is st for pe, st in zip(walked, held))
    fresh, _ = sw.build_studio(tpg, seconds, readers[tpg])
    want = tengine.render_scan(fresh, 0, n, 4096, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
