"""PyTorch port, multi-device rendering (``parallel/render.py``) against the
JAX package on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's on a mesh of eight CPU shards, ``Mesh(["cpu"] * 8)``. The same
graphs, fonts and scores as ``tests/test_parallel.py``. Tolerances:

- against the JAX package: pure 1e-6, relay 2e-5, affine 1e-5 on the
  constant-coefficient chain and 1e-4 on the swept, SVF/stereo,
  convolve and non-zero-start graphs, the scanned synth 2e-5, the
  offline synth 1e-5;
- against the port's own one-device renders: pure and relay equal
  ``engine.render_scan`` bit for bit, the halo mode within 1e-5 past the
  first span, the affine mode at the JAX tests' bounds (1e-5, 1e-4),
  the offline synth within 1e-6 of ``render_midi_offline``;
- ``select_time_sharding`` returns the JAX package's (mode, D), and every
  gate raises where the JAX one does.

``python tests/test_torch_parallel.py`` prints each comparison's observed
maximum.
"""

import os
import struct

if __name__ == "__main__":  # the 8 virtual CPU devices of tests/conftest.py
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest
import torch

import pygmu2_tpu as pg
from pygmu2_tpu.parallel import render as jr
from pygmu2_tpu.soundfont import MidiFile as JMidiFile
from pygmu2_tpu.soundfont import SoundFont as JSoundFont
from pygmu2_tpu.soundfont import Synthesizer as JSynth
from pygmu2_tpu.soundfont import SynthesizerSettings as JSettings
import pygmu2_tpu_torch as pt
from pygmu2_tpu_torch.core import engine
from pygmu2_tpu_torch.parallel import render as tr
from pygmu2_tpu_torch.soundfont import MidiFile, SoundFont, Synthesizer, SynthesizerSettings
from pygmu2_tpu_torch.soundfont.build import build_sf2, make_looped_sample
from pygmu2_tpu_torch.soundfont.offline import render_midi_offline

torch.set_num_threads(1)

N_SHARDS = 8
TOTAL = 8 * 2048
BLOCK = 1024


@pytest.fixture(autouse=True)
def _port_rate():
    pt.set_sample_rate(44100)


def port_mesh(axis="t"):
    return tr.Mesh(["cpu"] * N_SHARDS, axis)


def jax_mesh(axis="t"):
    return jr.default_mesh(N_SHARDS, axis=axis)


# ---- the graphs, built in either package ----------------------------------


def tone(pk):
    return pk.GainPE(pk.SinePE(frequency=441.0), 0.5)


def modulated_chain(pk):
    # the modulated sine carries a phase accumulator: non-decaying state
    src = pk.SinePE(frequency=pk.ConstantPE(220.0), amplitude=0.7)
    return pk.BiquadPE(pk.BiquadPE(src, 3000.0, 1.2), 800.0, 0.9)


def filter_chain(pk):
    src = pk.SinePE(frequency=220.0, amplitude=0.7)
    return pk.BiquadPE(pk.BiquadPE(src, 3000.0, 1.2), 800.0, 0.9)


def one_biquad(pk):
    return pk.BiquadPE(pk.SinePE(frequency=220.0, amplitude=0.7), 3000.0, 1.2)


def swept(pk):
    sweep = pk.PiecewisePE([(0, 500.0), (8 * 2048, 4000.0)])
    return pk.BiquadPE(pk.SinePE(frequency=220.0, amplitude=0.7), sweep, 2.0)


def svf_stereo(pk):
    src = pk.SpatialPE(pk.SinePE(frequency=330.0, amplitude=0.5),
                       method=pk.SpatialLinear(0.3))
    return pk.SVFilterPE(src, 1200.0, 1.5)


def convolve(pk):
    ir = pk.ArrayPE(np.exp(-np.arange(300) / 40.0).astype(np.float32))
    return pk.ConvolvePE(pk.SinePE(frequency=220.0, amplitude=0.5), ir)


def ladder(pk):
    return pk.LadderPE(pk.SinePE(frequency=220.0), 2000.0, 0.3)


def pink(pk):
    return pk.BiquadPE(pk.NoisePE(seed=3, mode=pk.NoiseMode.PINK), 2000.0, 0.8)


def brown(pk):
    return pk.BiquadPE(pk.NoisePE(seed=3, mode=pk.NoiseMode.BROWN), 2000.0, 0.8)


def random_walk(pk):
    return pk.GainPE(pk.SinePE(frequency=440.0),
                     pk.RandomPE(rate=100.0, mode=pk.RandomMode.WALK, seed=1))


def random_smooth(pk):
    return pk.GainPE(pk.SinePE(frequency=440.0),
                     pk.RandomPE(rate=100.0, mode=pk.RandomMode.SMOOTH, seed=1))


# ---- the fonts and scores of tests/test_parallel.py -----------------------


def _varint(v):
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def _smf(body, res=480):
    body += _varint(0) + b"\xff\x2f\x00"
    return (b"MThd" + struct.pack(">ihhh", 6, 0, 1, res)
            + b"MTrk" + struct.pack(">i", len(body)) + body)


def chord_midi():
    """Four notes on at 0 s, off at 0.5 s (the scanned synth's score)."""
    tps = 480 * 120 / 60.0
    events = [(0.0, 0x90, k, 100) for k in (60, 64, 67, 72)]
    events += [(0.5, 0x80, k, 0) for k in (60, 64, 67, 72)]
    body, last = b"", 0
    for t, st, d1, d2 in events:
        tick = int(round(t * tps))
        body += _varint(tick - last) + bytes([st, d1, d2])
        last = tick
    return _smf(body)


def triad_midi():
    """Three notes on at 0, one off a beat later (the offline synth's score)."""
    body = b""
    for k in (60, 64, 67):
        body += _varint(0) + bytes([0x90, k, 100])
    body += _varint(480) + bytes([0x80, 60, 0])
    return _smf(body)


FONT = build_sf2([{"data": make_looped_sample(261.63), "rate": 44100,
                   "root_key": 60, "loop": True}])

SYNTHS = {  # name -> (block size, score, seconds)
    "scanned": (256, chord_midi(), 1.0),
    "offline": (128, triad_midi(), 0.6),
}


def jax_synth(block):
    return JSynth(JSoundFont(FONT), JSettings(block_size=block, maximum_polyphony=16))


def port_synth(block, poly=16):
    return Synthesizer(SoundFont(FONT), SynthesizerSettings(block_size=block,
                                                            maximum_polyphony=poly),
                       device="cpu")


# ---- each render once -------------------------------------------------------

# name -> (graph, start, kind, halo)
CASES = {
    "pure": (tone, 0, "pure", 0),
    "relay": (modulated_chain, 0, "relay", 0),
    "affine_chain": (filter_chain, 0, "affine", 0),
    "affine_swept": (swept, 0, "affine", 0),
    "affine_svf_stereo": (svf_stereo, 0, "affine", 0),
    "affine_convolve": (convolve, 0, "affine", 0),
    "affine_start": (filter_chain, 5000, "affine", 0),
    "halo": (filter_chain, 0, "halo", 4096),
}


def _render(r, mesh, name):
    if name in SYNTHS:
        block, midi, seconds = SYNTHS[name]
        if r is jr:
            synth, midi_file = jax_synth(block), JMidiFile(midi)
        else:
            synth, midi_file = port_synth(block), MidiFile(midi)
        fn = r.render_midi_sharded if name == "scanned" else r.render_midi_offline_sharded
        return fn(synth, midi_file, seconds, mesh)
    build, start, kind, halo = CASES[name]
    graph = build(pg if r is jr else pt)
    total = 44100 if kind == "pure" else TOTAL
    block = 2048 if kind == "pure" else BLOCK
    if kind == "pure":
        return r.render_time_sharded(graph, start, total, mesh, block=block)
    if kind == "affine":
        return r.render_time_sharded_affine(graph, start, total, mesh, block=block)
    return r.render_time_sharded_stateful(graph, start, total, mesh, block=block, halo=halo)


@pytest.fixture(scope="module")
def rendered():
    """``rendered(package, name)``: the sharded render of case ``name``
    through ``"jax"`` or ``"port"``, made once for the module."""
    cache = {}

    def get(package, name):
        if (package, name) not in cache:
            pg.set_sample_rate(44100)
            pt.set_sample_rate(44100)
            if package == "jax":
                cache[package, name] = np.asarray(_render(jr, jax_mesh(), name))
            else:
                cache[package, name] = _render(tr, port_mesh(), name)
        return cache[package, name]

    return get


def single(name):
    """The port's one-device render of case ``name`` (``render_scan``)."""
    build, start, kind, _halo = CASES[name]
    total = 44100 if kind == "pure" else TOTAL
    block = 2048 if kind == "pure" else BLOCK
    return engine.render_scan(build(pt), start, total, block, device="cpu").numpy()


def _flat(tree):
    """The leaves of a numpy state pytree, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


def _err(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a.astype(np.float64) - b).max())


# ---- against the JAX package ------------------------------------------------

JAX_TOL = {
    "pure": 1e-6,
    "relay": 2e-5,
    "affine_chain": 1e-5,
    "affine_swept": 1e-4,
    "affine_svf_stereo": 1e-4,
    "affine_convolve": 1e-4,
    "affine_start": 1e-4,
    "scanned": 2e-5,
    "offline": 1e-5,
}


@pytest.mark.parametrize("name", list(JAX_TOL))
def test_matches_jax(rendered, name):
    got, want = rendered("port", name), rendered("jax", name)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.01
    assert _err(got, want) <= JAX_TOL[name]


# ---- against the port's own one-device renders -------------------------------


@pytest.mark.parametrize("name", ["pure", "relay"])
def test_equals_render_scan_bit_for_bit(rendered, name):
    np.testing.assert_array_equal(rendered("port", name), single(name))


SINGLE_TOL = {  # tests/test_parallel.py's bounds against render_scan
    "affine_chain": 1e-5,
    "affine_swept": 1e-4,
    "affine_svf_stereo": 1e-5,
    "affine_convolve": 1e-4,
    "affine_start": 1e-5,
}


@pytest.mark.parametrize("name", list(SINGLE_TOL))
def test_affine_matches_render_scan(rendered, name):
    assert _err(rendered("port", name), single(name)) <= SINGLE_TOL[name]


def test_halo_converges_past_the_first_span(rendered):
    # the cold-start transient lives in the first shard's span only
    got, want = rendered("port", "halo"), single("halo")
    assert _err(got[2048:], want[2048:]) <= 1e-5


def test_offline_sharded_matches_one_device(rendered):
    block, midi, seconds = SYNTHS["offline"]
    want = render_midi_offline(port_synth(block), MidiFile(midi), seconds, device="cpu")
    assert _err(rendered("port", "offline"), want) <= 1e-6


@pytest.mark.parametrize("fn", ["render_midi_sharded", "render_midi_offline_sharded"])
def test_one_shard_equals_one_device(fn):
    """A mesh of one renders what the one-device entry point renders."""
    block, midi, seconds = 128, triad_midi(), 0.2
    got = getattr(tr, fn)(port_synth(block), MidiFile(midi), seconds, tr.Mesh(["cpu"]))
    if fn == "render_midi_sharded":
        want = port_synth(block).render_midi_schedule(MidiFile(midi), seconds)
    else:
        want = render_midi_offline(port_synth(block), MidiFile(midi), seconds, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("build", [tone, modulated_chain], ids=["pure", "relay"])
def test_renders_the_blocks_render_scan_renders(build, monkeypatch):
    """A timeline shorter than the mesh's spans: the shards render only the
    blocks that reach into it, at render_scan's starts, and match it bit
    for bit."""
    starts = []
    run = engine.Program._run

    def counted(self, block_start, states, bindings=None):
        starts.append(block_start)
        return run(self, block_start, states, bindings)

    monkeypatch.setattr(engine.Program, "_run", counted)
    total = 3 * BLOCK + 100
    if build is tone:
        got = tr.render_time_sharded(build(pt), 700, total, port_mesh(), block=BLOCK)
    else:
        got = tr.render_time_sharded_stateful(build(pt), 700, total, port_mesh(), block=BLOCK)
    sharded, starts[:] = list(starts), []
    want = engine.render_scan(build(pt), 700, total, BLOCK, device="cpu").numpy()
    assert sharded == starts == [700 + k * BLOCK for k in range(4)]
    np.testing.assert_array_equal(got, want)


# ---- strategy selection -------------------------------------------------------

SELECT = {  # name -> (graph, affine_max_basis), tests/test_parallel.py:236-290
    "pure": (tone, None),
    "affine_one_biquad": (one_biquad, None),
    "relay_cascade": (filter_chain, None),
    "relay_long_fir": (convolve, None),
    "relay_nonaffine": (ladder, None),
    "max_basis_override": (one_biquad, 1),
}


@pytest.mark.parametrize("name", list(SELECT))
def test_select_matches_jax(name):
    build, cap = SELECT[name]
    want = jr.select_time_sharding(build(pg), jax_mesh(), block=BLOCK, affine_max_basis=cap)
    got = tr.select_time_sharding(build(pt), port_mesh(), block=BLOCK, affine_max_basis=cap)
    assert got == want


@pytest.mark.parametrize("build", [tone, one_biquad, convolve], ids=["pure", "affine", "relay"])
def test_auto_matches_single_device(build):
    got = tr.render_time_sharded_auto(build(pt), 0, TOTAL, port_mesh(), block=BLOCK)
    want = engine.render_scan(build(pt), 0, TOTAL, BLOCK, device="cpu").numpy()
    assert _err(got, want) <= 1e-4


def test_auto_takes_the_selected_mode():
    graph = one_biquad(pt)
    assert tr.select_time_sharding(graph, port_mesh(), block=BLOCK) == ("affine", 4)
    got = tr.render_time_sharded_auto(graph, 0, TOTAL, port_mesh(), block=BLOCK)
    np.testing.assert_array_equal(
        got, tr.render_time_sharded_affine(one_biquad(pt), 0, TOTAL, port_mesh(), block=BLOCK))


# ---- the gates (tests/test_parallel.py:33, :87-150, :208) ----------------------


def _halo(graph):
    return tr.render_time_sharded_stateful(graph, 0, TOTAL, port_mesh(), block=BLOCK,
                                           halo=4096)


def test_pure_rejects_stateful_root():
    with pytest.raises(ValueError):
        tr.render_time_sharded(pt.NoisePE(seed=1, mode=pt.NoiseMode.PINK), 0, 100, port_mesh())


@pytest.mark.parametrize("build,match", [
    (modulated_chain, "non-decaying.*SinePE"),
    (brown, "NoisePE"),
    (random_walk, "RandomPE"),
], ids=["phase_accumulator", "brown_noise", "random_walk"])
def test_halo_rejects_non_decaying_state(build, match):
    with pytest.raises(ValueError, match=match):
        _halo(build(pt))


@pytest.mark.parametrize("build", [pink, random_smooth], ids=["pink_noise", "clocked_random"])
def test_halo_accepts_decaying_state(build):
    out = _halo(build(pt))
    assert out.shape == (TOTAL, 1) and np.isfinite(out).all()


def test_exact_relay_unaffected_by_gate(rendered):
    out = rendered("port", "relay")
    assert out.shape == (TOTAL, 1) and np.isfinite(out).all()


def test_affine_rejects_nonlinear_state():
    with pytest.raises(ValueError, match="affine"):
        tr.render_time_sharded_affine(ladder(pt), 0, TOTAL, port_mesh(), block=BLOCK)


@pytest.mark.parametrize("fn", ["render_midi_sharded", "render_midi_offline_sharded"])
def test_polyphony_must_divide(fn):
    block, midi, seconds = SYNTHS["offline"]
    with pytest.raises(ValueError, match="divide"):
        getattr(tr, fn)(port_synth(block), MidiFile(midi), seconds, tr.Mesh(["cpu"] * 3))


# ---- side effects --------------------------------------------------------------


def test_relay_leaves_instance_states_untouched():
    graph = modulated_chain(pt)
    engine.render_scan(graph, 0, 3 * BLOCK, BLOCK, device="cpu")
    before = engine.checkpoint_state(graph)
    out = tr.render_time_sharded_stateful(graph, 0, 4 * BLOCK, tr.Mesh(["cpu"] * 2),
                                          block=BLOCK)
    after = engine.checkpoint_state(graph)
    assert before.keys() == after.keys() and before
    for key in before:
        assert before[key]["next"] == after[key]["next"]
        got, want = _flat(after[key]["user"]), _flat(before[key]["user"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # and the relay started fresh, not from the instances' states
    fresh = engine.render_scan(modulated_chain(pt), 0, 4 * BLOCK, BLOCK, device="cpu").numpy()
    np.testing.assert_array_equal(out, fresh)


@pytest.mark.parametrize("fn", ["render_midi_sharded", "render_midi_offline_sharded"])
def test_synth_reset_afterwards(fn):
    synth = port_synth(128)
    getattr(tr, fn)(synth, MidiFile(triad_midi()), 0.1, tr.Mesh(["cpu"] * 2))
    assert synth.active_voice_count == 0 and synth._dyn is None


# ---- the mesh -------------------------------------------------------------------


def test_mesh():
    mesh = tr.Mesh(["cpu", torch.device("cpu")], "t")
    assert mesh.size == 2 and mesh.axis_names == ("t",)
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert tr.default_mesh(device="cpu").devices == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        tr.default_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        tr.Mesh([])


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == N_SHARDS
    pg.set_sample_rate(44100)
    pt.set_sample_rate(44100)
    port = {name: _render(tr, port_mesh(), name) for name in JAX_TOL}
    for name, tol in JAX_TOL.items():
        want = np.asarray(_render(jr, jax_mesh(), name))
        print(f"{name}: vs JAX {_err(port[name], want):.3g} (bound {tol:g})")
    for name in ("pure", "relay"):
        print(f"{name}: vs render_scan bit for bit: {np.array_equal(port[name], single(name))}")
    for name, tol in SINGLE_TOL.items():
        print(f"{name}: vs render_scan {_err(port[name], single(name)):.3g} (bound {tol:g})")
    halo = _render(tr, port_mesh(), "halo")
    print(f"halo: vs render_scan past the first span {_err(halo[2048:], single('halo')[2048:]):.3g}")
    block, midi, seconds = SYNTHS["offline"]
    want = render_midi_offline(port_synth(block), MidiFile(midi), seconds, device="cpu")
    print(f"offline: vs render_midi_offline {_err(port['offline'], want):.3g}")
