"""PyTorch port: AssetManager, AudioLibrary and the debug helpers
(``print_pe_tree``, ``format_pe_tree``, ``graph_stats``), on local files
only (no test reaches the network), and the profiling helpers on the CPU.

A graph built the same way in both packages prints the same tree where
the PEs' reprs agree.
"""

import json
import os

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.utils.debug import format_pe_tree as jax_format_pe_tree
from pygmu2_tpu_torch.utils import profiling, wavio
from pygmu2_tpu_torch.utils.assets import AssetLoader, AssetNotFound
from pygmu2_tpu_torch.utils.debug import format_pe_tree, graph_stats

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


class _LocalLoader(AssetLoader):
    """A remote stand-in serving files from a local folder."""

    def __init__(self, root):
        self._root = root

    def list_remote_assets(self, wildcard_spec):
        return sorted(p.name for p in self._root.glob(wildcard_spec))

    def load_remote_asset(self, wildcard_spec, cache_dir):
        names = self.list_remote_assets(wildcard_spec)
        if not names:
            return None
        dest = cache_dir / names[0]
        dest.write_bytes((self._root / names[0]).read_bytes())
        return dest


def test_asset_manager_cache_and_loaders(tmp_path):
    cache, remote = tmp_path / "cache", tmp_path / "remote"
    remote.mkdir()
    (remote / "kick.wav").write_bytes(b"kick")
    mgr = tpg.AssetManager([_LocalLoader(remote)], cache_dir=cache)
    assert mgr.cache_path == cache and not mgr.has_cached_asset("*.wav")
    assert mgr.list_remote_assets("k*.wav") == ["kick.wav"]
    got = mgr.load_asset("k*.wav")
    assert got == cache / "kick.wav" and got.read_bytes() == b"kick"
    assert mgr.list_cached_assets("*.wav") == [cache / "kick.wav"]
    assert mgr.load_asset("kick.wav") == got  # a cache hit
    with pytest.raises(AssetNotFound):
        mgr.load_asset("snare.wav")
    mgr.clear_cache()
    assert not mgr.has_cached_asset("*") and cache.exists()


def test_audio_library_from_strudel_json(tmp_path):
    wav = tmp_path / "snare.wav"
    wavio.write_wav(wav, np.linspace(-1, 1, 100, dtype=np.float32), 44100)
    (tmp_path / "strudel.json").write_text(
        json.dumps({"_base": "ignored/", "snare": ["snare.wav"], "kit": ["snare.wav", "x.wav"],
                    "one": "snare.wav"})
    )
    lib = tpg.AudioLibrary.from_strudel_json(tmp_path / "strudel.json")
    jlib = jpg.AudioLibrary.from_strudel_json(tmp_path / "strudel.json")
    assert lib.keys == jlib.keys == ["kit", "one", "snare"]
    assert lib.resolve("kit", 2) == jlib.resolve("kit", 2) == str(wav)
    assert repr(lib) == repr(jlib)
    reader = lib.reader("snare")
    assert isinstance(reader, tpg.WavReaderPE) and reader.extent().end == 100
    out = tpg.render_to_array(reader, device="cpu")
    np.testing.assert_array_equal(out, jpg.render_to_array(jlib.reader("snare")))
    with pytest.raises(KeyError):
        lib.resolve("zzz")


def _graph(pg):
    base = pg.SinePE(frequency=440.0)
    mix = pg.MixPE(pg.GainPE(base, 0.5), pg.GainPE(base, 0.25),
                   pg.PiecewisePE([(0, 0.0), (100, 1.0)]))
    return pg.CropPE(pg.SpatialPE(mix, method=pg.SpatialLinear(20.0)), 0, 1000)


def test_pe_tree_text_matches_jax():
    text = format_pe_tree(_graph(tpg))
    assert text == jax_format_pe_tree(_graph(jpg))
    assert "<shared: SinePE" in text and "SpatialLinear(azimuth=20.0)" in text
    deep = format_pe_tree(_graph(tpg), max_depth=1)
    assert "<max depth reached>" in deep


def test_print_pe_tree(capsys):
    tpg.print_pe_tree(tpg.ConstantPE(1.0))
    assert "ConstantPE" in capsys.readouterr().out


def test_graph_stats():
    g = tpg.CropPE(tpg.GainPE(tpg.ConstantPE(1.0), 0.5), 0, 100)
    g.render(0, 16, device="cpu")
    stats = graph_stats(g)
    assert stats["n_nodes"] == 3 and stats["n_stateful"] == 0
    assert stats["compiled_block_sizes"] == [16]
    assert stats["node_types"] == ["ConstantPE", "CropPE", "GainPE"]


def test_profiling_helpers_on_the_cpu(tmp_path, caplog):
    g = tpg.CropPE(tpg.SinePE(frequency=440.0), 0, 2000)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("render"):
            tpg.render_to_array(g, device="cpu")
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert any(e.key == "render" for e in prof.key_averages())
    with profiling.timed("render"):
        tpg.render_to_array(g, device="cpu")
    profiling.block_until_done()
