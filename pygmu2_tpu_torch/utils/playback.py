"""Playback / offline-render conveniences (counterpart of
``pygmu2_tpu.utils.playback``).

``render_to_array`` and ``render_to_file`` render a finite PE graph on a
device (default ``"cuda"``; ``device="cpu"`` runs the kernels' plain
PyTorch versions) block by block through
:func:`pygmu2_tpu_torch.core.engine.render_scan`. ``play`` streams a graph
through :class:`~pygmu2_tpu_torch.core.audio_renderer.AudioRenderer`
(rendered on ``device``), and ``play_offline`` renders to a WAV file and
plays that back. ``browse`` renders to a WAV file and opens it in the
port's jog/shuttle player (:mod:`pygmu2_tpu_torch.utils.jogshuttle`) in a
separate process.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from pygmu2_tpu_torch.core import engine
from pygmu2_tpu_torch.core.config import get_sample_rate
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.core.renderer import NullRenderer
from pygmu2_tpu_torch.utils import wavio


def _resolve_sample_rate(sample_rate: int | None) -> int:
    if sample_rate is not None:
        return int(sample_rate)
    sr = get_sample_rate()
    if sr is None:
        raise RuntimeError(
            "Sample rate not set. Call pg.set_sample_rate() or pass sample_rate."
        )
    return int(sr)


def render_to_array(
    source: ProcessingElement,
    *,
    extent=None,
    block: int = 16384,
    bindings: dict | None = None,
    device="cuda",
) -> np.ndarray:
    """Render the source's full (finite) extent to a host float32 array.

    Validates the graph, runs lifecycle hooks, and renders in blocks of
    ``block`` samples on ``device``. ``bindings`` supplies values for any
    ``ParamPE`` nodes in the graph.
    """
    if extent is None:
        extent = source.extent()
    if extent.start is None or extent.end is None:
        raise RuntimeError("Cannot render: source has infinite extent.")
    renderer = NullRenderer(sample_rate=source.sample_rate or 44100, device=device)
    renderer.set_source(source)
    with renderer:
        renderer.start()
        out = engine.render_scan(
            source, extent.start, extent.end - extent.start, block,
            bindings=bindings, device=device,
        )
        return out.detach().cpu().numpy()


def render_to_file(
    source: ProcessingElement,
    out_path: str,
    *,
    sample_rate: int | None = None,
    extent=None,
    device="cuda",
) -> None:
    """Render a finite PE graph to a float32 WAV file."""
    sr = _resolve_sample_rate(sample_rate)
    data = render_to_array(source, extent=extent, device=device)
    wavio.write_wav(out_path, data, sr, fmt="float32")


def play(source: ProcessingElement, sample_rate: int | None = None, *,
         device="cuda") -> None:
    """Play a PE in real time through the audio output, rendering it on
    ``device``."""
    from pygmu2_tpu_torch.core.audio_renderer import AudioRenderer

    sr = _resolve_sample_rate(sample_rate)
    renderer = AudioRenderer(sample_rate=sr, device=device)
    renderer.set_source(source)
    with renderer:
        renderer.start()
        renderer.play_extent()


def play_offline(
    source: ProcessingElement,
    sample_rate: int | None = None,
    path: str | None = None,
    omit_playback: bool | None = None,
    *,
    device="cuda",
) -> None:
    """Render to a WAV file offline on ``device``, then play it back.

    With ``path=None`` a temp file is used and removed afterwards.
    """
    sr = _resolve_sample_rate(sample_rate)
    extent = source.extent()
    if extent.start is None or extent.end is None:
        raise RuntimeError("Cannot render offline: source has infinite extent.")

    def render_and_play(out_path):
        render_to_file(source, out_path, sample_rate=sr, extent=extent, device=device)
        if omit_playback is not True:
            from pygmu2_tpu_torch.models.io_pes import WavReaderPE

            play(WavReaderPE(out_path), sample_rate=sr, device=device)

    if path is not None:
        render_and_play(path)
        return
    fd, tmp_path = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    try:
        render_and_play(tmp_path)
    finally:
        try:
            os.remove(tmp_path)
        except FileNotFoundError:
            pass


def browse(
    source: ProcessingElement,
    sample_rate: int | None = None,
    path: str | None = None,
    *,
    device="cuda",
) -> None:
    """Render to a WAV file on ``device`` and open it in the jog/shuttle
    player, ``python -m pygmu2_tpu_torch.utils.jogshuttle`` (a separate
    process; returns at once). With ``path=None`` the player deletes its
    temp file when it closes."""
    import subprocess
    import sys
    from pathlib import Path

    sr = _resolve_sample_rate(sample_rate)
    extent = source.extent()
    if extent.start is None or extent.end is None:
        raise RuntimeError("Cannot browse: source has infinite extent.")

    delete_on_close = path is None
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".wav")
        os.close(fd)
    path = str(Path(path).resolve())
    render_to_file(source, path, sample_rate=sr, extent=extent, device=device)

    cmd = [sys.executable, "-m", "pygmu2_tpu_torch.utils.jogshuttle", path]
    if delete_on_close:
        cmd.append("--delete-on-close")
    subprocess.Popen(cmd)
