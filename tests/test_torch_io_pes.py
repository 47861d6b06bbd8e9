"""PyTorch port: WavReaderPE, AudioReaderPE, WavWriterPE and utils/flacio
against the JAX package on the CPU.

Files are written from numpy data made from a seed. The FLAC codec is a
copy of the JAX package's (numpy only): its bytes and decodes are held
bit for bit, as are the readers' renders, the resampling (scipy in both
packages) and the writer's files, byte for byte.
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.utils import flacio as jflacio
from pygmu2_tpu_torch.utils import flacio as tflacio
from pygmu2_tpu_torch.utils import wavio

torch.set_num_threads(1)

DATA = (0.7 * np.random.default_rng(10).uniform(-1, 1, (3000, 2))).astype(np.float32)


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _render(pg, graph, block=512):
    if pg is tpg:
        return tpg.render_to_array(graph, block=block, device="cpu")
    return np.asarray(pg.render_to_array(graph, block=block))


@pytest.fixture
def files(tmp_path):
    paths = {"wav": str(tmp_path / "a.wav"), "flac": str(tmp_path / "a.flac"),
             "wav22": str(tmp_path / "b.wav"), "flac22": str(tmp_path / "b.flac")}
    wavio.write_wav(paths["wav"], DATA, 44100)
    tflacio.write_flac(paths["flac"], DATA, 44100)
    wavio.write_wav(paths["wav22"], DATA[:1500], 22050)
    tflacio.write_flac(paths["flac22"], DATA[:1500, :1], 22050, blocksize=1000)
    return paths


def test_flac_encoder_bytes_and_decodes_match_jax(tmp_path):
    for i, (data, bs) in enumerate([(DATA, 4096), (DATA[:777, :1], 256),
                                    (np.zeros((5, 2), np.float32), 4096),
                                    ((DATA * 32767).astype(np.int16), 1000)]):
        a, b = str(tmp_path / f"t{i}.flac"), str(tmp_path / f"j{i}.flac")
        tflacio.write_flac(a, data, 44100, blocksize=bs)
        jflacio.write_flac(b, data, 44100, blocksize=bs)
        assert open(a, "rb").read() == open(b, "rb").read()
        got, sr = tflacio.read_flac(a)
        want, jsr = jflacio.read_flac(b)
        assert sr == jsr == 44100
        np.testing.assert_array_equal(got, want)
        assert tflacio.flac_info(a) == jflacio.flac_info(b)
    # 16-bit round trip
    got, _ = tflacio.read_flac(str(tmp_path / "t0.flac"))
    np.testing.assert_allclose(got, DATA, atol=1.0 / 32768)


@pytest.mark.parametrize("kind", ["wav", "flac", "wav22", "flac22", "wav_db", "flac_db"])
def test_readers_match_jax(files, kind):
    def build(pg):
        if kind == "wav":
            return pg.WavReaderPE(files["wav"])
        path = files[kind.split("_")[0]]
        db = -6.0 if kind.endswith("_db") else None
        return pg.AudioReaderPE(path, max_level_db=db)

    readers = [build(pg) for pg in (jpg, tpg)]
    e, f = readers[1].extent(), readers[0].extent()
    assert (e.start, e.end) == (f.start, f.end)
    assert readers[1].channel_count() == readers[0].channel_count()
    assert readers[1].file_sample_rate == readers[0].file_sample_rate
    want = _render(jpg, jpg.CropPE(readers[0], -100, f.end + 100))
    got = _render(tpg, tpg.CropPE(readers[1], -100, e.end + 100))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0.1
    if kind == "wav":
        np.testing.assert_array_equal(got, DATA)


def test_reader_zero_fill_outside(files):
    s = tpg.WavReaderPE(files["wav"]).render(-5, 20, device="cpu").data
    np.testing.assert_array_equal(s[:5], 0.0)
    np.testing.assert_array_equal(s[5:], DATA[:15])


def test_audio_reader_without_a_codec_raises_as_jax(tmp_path):
    path = str(tmp_path / "x.mp3")
    open(path, "wb").write(b"\0" * 64)
    msgs = []
    for pg in (jpg, tpg):
        with pytest.raises(RuntimeError) as err:
            pg.AudioReaderPE(path).extent()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "miniaudio" in msgs[1]


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "PCM_32", "FLOAT"])
def test_writer_files_match_jax_byte_for_byte(tmp_path, subtype):
    blobs = []
    for pg in (jpg, tpg):
        path = str(tmp_path / f"{pg.__name__}.wav")
        writer = pg.WavWriterPE(pg.GainPE(pg.ArrayPE(DATA[:2048]), 0.9), path, subtype=subtype)
        out = _render(pg, writer, block=512)
        assert writer.frames_written == 2048
        blobs.append(open(path, "rb").read())
    assert blobs[1] == blobs[0]
    got, _ = wavio.read_wav(str(tmp_path / "pygmu2_tpu_torch.wav"))
    if subtype == "FLOAT":
        np.testing.assert_array_equal(got, out)


def test_writer_sample_rate_and_renderer_lifecycle(tmp_path):
    path = str(tmp_path / "sr.wav")
    writer = tpg.WavWriterPE(tpg.ConstantPE(0.1), path, sample_rate=22050, subtype="FLOAT")
    renderer = tpg.NullRenderer(sample_rate=44100, device="cpu")
    renderer.set_source(writer)
    with renderer:
        renderer.start()
        renderer.render(0, 10)
        assert writer.frames_written == 10
    out, sr = wavio.read_wav(path)
    assert sr == 22050 and out.shape == (10, 1)
    np.testing.assert_array_equal(out, np.float32(0.1))
