"""PyTorch port, the engine's live half: live-control writes (the version
guard of ``Program.run``), block hooks (WavWriterPE's taps through
``Program.run`` and ``render_scan``), the host prelude and
``render_functional``, each held to the JAX package's behaviour on the
same inputs (``device="cpu"``).

Outputs are held to the JAX renders bit for bit (the PEs' arithmetic
mirrors XLA's CPU program); positions at 1e-3, the bound of
``tests/test_jogshuttle.py``.
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu_torch.core import engine as tengine
from pygmu2_tpu_torch.utils import wavio

torch.set_num_threads(1)

RAMP = 10_000


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _program(pg, root, block):
    if pg is tpg:
        return tengine.get_program(root, block, "cpu")
    return jengine.get_program(root, block)


def _tape(pg, rate=1.0):
    return pg.TimeWarpPE(pg.CropPE(pg.IdentityPE(), 0, RAMP), rate=pg.ControlPE(rate),
                         max_rate=8.0)


def _checkpoint(pg, root):
    return (tengine if pg is tpg else jengine).checkpoint_state(root)


def _run(prog, start):
    return np.asarray(prog.run(start))


# ---- TimeWarpPE.seek and ControlPE.set_value between blocks ---------------


def test_timewarp_seek_jumps_tape_between_blocks():
    got = {}
    for pg in (jpg, tpg):
        tw = _tape(pg)
        prog = _program(pg, tw, 64)
        b0 = _run(prog, 0)
        tw.seek(5000.0)
        assert tw.position == pytest.approx(5000.0)
        b1 = _run(prog, 64)  # contiguous block: no gap reset
        assert b1[0, 0] == pytest.approx(5000.0, abs=1e-3)
        assert tw.position == pytest.approx(5064.0)
        got[pg] = np.concatenate([b0, b1])
    assert got[jpg][-1, 0] == pytest.approx(5063.0, abs=1e-3)
    np.testing.assert_array_equal(got[tpg], got[jpg])


def test_seek_during_inflight_block_is_not_clobbered():
    """A seek that lands while a block renders survives the scatter after
    it; the next block plays from the sought position."""
    tw = _tape(tpg)
    prog = _program(tpg, tw, 64)
    prog.run(0)
    orig = prog._run

    def render_then_seek(start, states, bindings=None):  # the seek lands mid-render
        out = orig(start, states, bindings)
        tw.seek(5000.0)
        return out

    prog._run = render_then_seek
    prog.run(64)
    prog._run = orig
    assert tw.position == pytest.approx(5000.0), "seek was overwritten"
    b = _run(prog, 128)
    assert b[0, 0] == pytest.approx(5000.0, abs=1e-3)
    # the JAX engine keeps it the same way
    jtw = _tape(jpg)
    jprog = _program(jpg, jtw, 64)
    jprog.run(0)
    jorig = jprog._fn_step

    def step_then_seek(start, states):
        out = jorig(start, states)
        jtw.seek(5000.0)
        return out

    jprog._fn_step = step_then_seek
    jprog.run(64)
    jprog._fn_step = jorig
    np.testing.assert_array_equal(b, _run(jprog, 128))


def test_timewarp_seek_before_first_render_sets_initial_position():
    outs = []
    for pg in (jpg, tpg):
        tw = _tape(pg)
        tw.seek(1234.0)
        outs.append(_run(_program(pg, tw, 32), 0))
    assert outs[1][0, 0] == pytest.approx(1234.0, abs=1e-3)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_control_set_value_applies_from_the_next_block():
    """set_value(1.5) between blocks k and k+1 changes the rate from block
    k+1 on and not before, in both packages alike."""
    outs = []
    for pg in (jpg, tpg):
        tw = _tape(pg)
        rate = tw.rate
        prog = _program(pg, tw, 64)
        blocks = [_run(prog, 0), _run(prog, 64)]
        rate.set_value(1.5)
        assert rate.value == 1.5
        blocks += [_run(prog, 128), _run(prog, 192)]
        outs.append(np.concatenate(blocks)[:, 0])
        assert tw.position == pytest.approx(128 + 2 * 64 * 1.5)
    got, want = outs[1], outs[0]
    np.testing.assert_allclose(np.diff(got[:128]), 1.0, atol=1e-3)
    np.testing.assert_allclose(np.diff(got[128:]), 1.5, atol=1e-3)
    np.testing.assert_array_equal(got, want)


def test_control_set_value_inflight_is_kept():
    rate = tpg.ControlPE(1.0)
    tw = tpg.TimeWarpPE(tpg.CropPE(tpg.IdentityPE(), 0, RAMP), rate=rate, max_rate=8.0)
    prog = _program(tpg, tw, 64)
    prog.run(0)
    orig = prog._run

    def render_then_set(start, states, bindings=None):
        out = orig(start, states, bindings)
        rate.set_value(2.0)
        return out

    prog._run = render_then_set
    b1 = _run(prog, 64)
    prog._run = orig
    b2 = _run(prog, 128)
    np.testing.assert_allclose(np.diff(b1[:, 0]), 1.0, atol=1e-3)
    np.testing.assert_allclose(np.diff(b2[:, 0]), 2.0, atol=1e-3)
    assert float(rate._eng_state["user"]) == 2.0


def test_live_write_in_a_first_block_takes_the_blocks_device():
    """A write landing while the PEs render their first block (no carried
    state yet) keeps its live payload on the device of the block's state
    (stood in for by ``meta``), not on the host, where the next block
    would have to upload it."""
    rate = tpg.ControlPE(1.0)
    tw = tpg.TimeWarpPE(tpg.CropPE(tpg.IdentityPE(), 0, RAMP), rate=rate, max_rate=8.0)
    prog = _program(tpg, tw, 64)
    orig = prog._run

    def render_then_write(start, states, bindings=None):
        out, new = orig(start, states, bindings)
        tw.seek(5000.0)
        rate.set_value(2.0)
        for pe in (tw, rate):
            st = new[f"pe{pe._uid}"]
            new[f"pe{pe._uid}"] = {"user": st["user"].to("meta"), "next": st["next"]}
        return out, new

    prog._run = render_then_write
    prog.run(0)
    assert tw._eng_state["user"].device.type == "meta"
    assert rate._eng_state["user"].device.type == "meta"


def test_control_pe_matches_jax_checkpoint():
    """ControlPE's carried value and cursor, in the JAX package's format."""
    snaps = []
    for pg in (jpg, tpg):
        c = pg.ControlPE(0.25, channels=2)
        prog = _program(pg, c, 32)
        out = _run(prog, 0)
        c.set_value(-0.5)
        out = np.concatenate([out, _run(prog, 32)])
        assert out.shape == (64, 2)
        np.testing.assert_array_equal(out[:32], 0.25)
        np.testing.assert_array_equal(out[32:], -0.5)
        snaps.append(_checkpoint(pg, c))
    (k,) = snaps[0]
    assert list(snaps[1]) == [k]
    for part in ("user", "next"):
        np.testing.assert_array_equal(np.asarray(snaps[1][k][part]),
                                      np.asarray(snaps[0][k][part]))


# ---- WavWriterPE's taps -----------------------------------------------------


def _writer_graph(pg, path, n=1000):
    data = np.random.default_rng(3).uniform(-0.9, 0.9, (n, 2)).astype(np.float32)
    return pg.WavWriterPE(pg.GainPE(pg.ArrayPE(data), 0.5), path, subtype="FLOAT"), data * 0.5


def test_writer_tap_through_program_run(tmp_path):
    """Every block rendered through ``Program.run`` reaches the file, in
    order (tests/test_wav_io.py:67, in both packages)."""
    files = []
    for pg in (jpg, tpg):
        path = str(tmp_path / f"{pg.__name__}.wav")
        writer, want = _writer_graph(pg, path, 1000)
        kw = {"device": "cpu"} if pg is tpg else {}
        renderer = pg.NullRenderer(sample_rate=44100, **kw)
        renderer.set_source(writer)
        with renderer:
            renderer.start()
            for start in range(0, 1000, 250):
                renderer.render(start, 250)
        assert writer.frames_written == 1000
        out, _ = wavio.read_wav(path)
        np.testing.assert_array_equal(out, want)
        files.append(out)
    np.testing.assert_array_equal(files[1], files[0])


def test_writer_tap_through_render_scan(tmp_path, monkeypatch):
    """``render_scan`` hands the writer every block in order, after the last
    block, in one download: no host copy inside the block loop."""
    path = str(tmp_path / "scan.wav")
    writer, want = _writer_graph(tpg, path, 1024)
    runs, seen, copies = [], [], []
    prog = tengine.get_program(writer, 128, "cpu")
    orig_run = prog._run
    monkeypatch.setattr(prog, "_run", lambda *a: runs.append(a[0]) or orig_run(*a))
    orig_hook = writer._eng_on_block

    def hook(block):
        seen.append((len(runs), block.shape[0]))
        orig_hook(block)

    monkeypatch.setattr(writer, "_eng_on_block", hook)
    orig_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: copies.append(len(runs)) or orig_cpu(self, *a, **k))
    writer.on_start()
    out = tengine.render_scan(writer, 0, 1024, 128, device="cpu")
    writer.on_stop()
    monkeypatch.undo()
    assert runs == list(range(0, 1024, 128))
    assert seen == [(8, 128)] * 8  # after the last block, in block order
    assert copies and set(copies) == {8}  # host copies only after the loop
    got, _ = wavio.read_wav(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, out.numpy())


def test_writer_gets_the_render_not_the_last_blocks_padding(tmp_path):
    """``render_to_array`` over an extent that is not a whole number of
    blocks: the file holds exactly the returned frames. (The JAX package's
    scan hands the writer its fixed last block whole, padding included.)"""
    outs = {}
    for pg in (jpg, tpg):
        path = str(tmp_path / f"{pg.__name__}.wav")
        writer, want = _writer_graph(pg, path, 1000)
        out = np.asarray(tpg.render_to_array(writer, block=256, device="cpu")
                         if pg is tpg else pg.render_to_array(writer, block=256))
        got, _ = wavio.read_wav(path)
        outs[pg] = (out, got, writer.frames_written)
    out, got, frames = outs[tpg]
    assert frames == 1000
    np.testing.assert_array_equal(got, out)
    np.testing.assert_array_equal(out, outs[jpg][0])
    j_out, j_file, j_frames = outs[jpg]
    assert j_frames == 1024
    np.testing.assert_array_equal(got, j_file[:1000])


def test_writer_pruned_from_a_block_is_not_handed_it_again(tmp_path):
    """A writer whose extent misses a block publishes nothing in it: its
    carried payload is not written again. (The JAX package's taps repeat
    the carried payload in every block the writer is pruned from.)"""
    frames = {}
    for pg in (jpg, tpg):
        path = str(tmp_path / f"{pg.__name__}.wav")
        writer, want = _writer_graph(pg, path, 300)
        root = pg.MixPE(pg.DelayPE(writer, 0),
                        pg.CropPE(pg.ConstantPE(0.0, channels=2), 0, 1024))
        kw = {"device": "cpu"} if pg is tpg else {}
        pg.render_to_array(root, block=256, **kw)
        frames[pg] = writer.frames_written
        got, _ = wavio.read_wav(path)
        np.testing.assert_array_equal(got[:300], want)
    # blocks 0 and 1 render the writer (block 1 past its end, zeros); 2 and 3 prune it
    assert frames == {tpg: 512, jpg: 1024}


def test_graph_without_writer_collects_no_taps(monkeypatch):
    g = tpg.CropPE(tpg.SinePE(440.0), 0, 512)
    copies = []
    orig_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: copies.append(1) or orig_cpu(self, *a, **k))
    tengine.render_scan(g, 0, 512, 64, device="cpu")
    monkeypatch.undo()
    assert copies == []


# ---- render_functional --------------------------------------------------------


def _functional_graph(pg):
    x = np.random.default_rng(5).standard_normal((2000, 1)).astype(np.float32)
    src = pg.MixPE(pg.ArrayPE(x), pg.GainPE(pg.SinePE(220.0), pg.ParamPE("level", 0.5)))
    wet = pg.ConvolvePE(src, pg.ArrayPE(x[:64] * 0.1))
    return pg.CropPE(pg.TimeWarpPE(wet, pg.ControlPE(0.75), max_rate=2.0), 0, 1500)


def test_render_functional_is_a_fresh_render_scan_and_touches_nothing():
    g = _functional_graph(tpg)
    tpg.render_to_array(g, block=256, device="cpu")  # leaves carried state behind
    before = tpg.checkpoint_state(g)
    walked = tengine._walk(g)
    held = [pe._eng_state for pe in walked]
    got = tengine.render_functional(g, 0, 1500, 256, device="cpu").numpy()
    assert [pe._eng_state for pe in walked] == held
    after = tpg.checkpoint_state(g)
    assert sorted(after) == sorted(before)
    fresh = _functional_graph(tpg)
    want = tengine.render_scan(fresh, 0, 1500, 256, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_render_functional_bindings_match_jax():
    for level in (0.0, 0.5, 1.25):
        want = np.asarray(jengine.render_functional(
            _functional_graph(jpg), 0, 1500, 256, {"level": level}))
        got = tengine.render_functional(
            _functional_graph(tpg), 0, 1500, 256, {"level": level}, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_render_functional_fires_no_hook(tmp_path):
    writer, _ = _writer_graph(tpg, str(tmp_path / "f.wav"), 512)
    writer.on_start()
    tengine.render_functional(writer, 0, 512, 128, device="cpu")
    assert writer.frames_written == 0


# ---- the host prelude -----------------------------------------------------------


def _tralfam_of_stateful(pg):
    x = np.random.default_rng(6).standard_normal((2000, 1)).astype(np.float32)
    src = pg.CropPE(pg.TimeWarpPE(pg.ArrayPE(x), 0.75), 100, 900)
    return pg.MixPE(pg.TralfamPE(src, seed=2), pg.CropPE(pg.ConstantPE(0.0), 0, 1200))


def test_prelude_renders_the_source_once_and_leaves_its_state_as_jax_does():
    """TralfamPE's prelude renders its (stateful) source before the first
    block, through the source's own program: the source keeps the carried
    state of that render, as in the JAX package."""
    outs, snaps = [], []
    for pg in (jpg, tpg):
        g = _tralfam_of_stateful(pg)
        kw = {"device": "cpu"} if pg is tpg else {}
        outs.append(np.asarray(pg.render_to_array(g, block=256, **kw)))
        snaps.append(_checkpoint(pg, g))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert sorted(snaps[1]) == sorted(snaps[0])
    for k in snaps[0]:
        assert int(snaps[1][k]["next"]) == int(snaps[0][k]["next"])
        np.testing.assert_array_equal(np.asarray(snaps[1][k]["user"]),
                                      np.asarray(snaps[0][k]["user"]))


def test_prelude_renders_on_the_programs_device(monkeypatch):
    seen = []
    orig = tpg.ProcessingElement.render

    def spy(self, start, duration, *, device="cuda"):
        seen.append(str(device))
        return orig(self, start, duration, device=device)

    monkeypatch.setattr(tpg.ProcessingElement, "render", spy)
    g = tpg.ReverbPE(tpg.TralfamPE(tpg.ArrayPE(np.ones((300, 1), np.float32)), seed=1),
                     tpg.ArrayPE(np.full((50, 1), 0.1, np.float32)))
    tpg.render_to_array(g, block=128, device="cpu")
    assert seen and set(seen) == {"cpu"}
