"""MidiInPE — live MIDI input bridge.

Counterpart of ``pygmu2_tpu.models.midi_in`` (reference:
src/pygmu2/midi_in_pe.py:45-125): a mido input callback feeds a
thread-safe queue; once per rendered block the queue drains and the user
callback receives ``(block_start, message)``. Output is one channel of
silence — the PE exists for its side effects (driving a synth's event
state between blocks). The port's engine is eager, so the drain runs
in the block's trace, in the graph's pull order. ``feed()`` lets tests (or
non-mido transports) inject messages.
"""

from __future__ import annotations

import queue
from typing import Callable

import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import SourcePE

try:
    import mido
except ImportError:  # pragma: no cover - optional dependency
    mido = None


class MidiInPE(SourcePE):
    """Drains live MIDI messages into a user callback, block by block."""

    def __init__(
        self,
        port_name: str | None = None,
        callback: Callable | None = None,
        require_mido: bool = True,
    ):
        if mido is None and require_mido and port_name is not None:
            raise RuntimeError(
                "MidiInPE requires mido to open a hardware port. Install "
                "mido, or construct with port_name=None and feed() events."
            )
        self._port_name = port_name
        self._callback = callback
        self._message_queue: queue.Queue = queue.Queue()
        self._port = None

    def feed(self, message) -> None:
        """Thread-safe: inject a message as if it arrived from the port."""
        self._message_queue.put_nowait(message)

    def _mido_callback(self, msg) -> None:
        self._message_queue.put_nowait(msg)

    def _on_start(self) -> None:
        if mido is not None and self._port_name is not None:
            self._port = mido.open_input(
                name=self._port_name, callback=self._mido_callback
            )

    def _on_stop(self) -> None:
        if self._port is not None:
            self._port.close()
            self._port = None

    def _drain(self, block_start: int) -> None:
        try:
            while True:
                msg = self._message_queue.get_nowait()
                if self._callback is not None:
                    self._callback(block_start, msg)
        except queue.Empty:
            pass

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int:
        return 1

    def _compute_extent(self) -> Extent:
        return Extent(None, None)

    def _trace(self, ctx):
        self._drain(int(ctx.start))
        return torch.zeros((ctx.duration, 1), dtype=prec.AUDIO, device=ctx.device)

    def __repr__(self) -> str:
        name = repr(self._port_name) if self._port_name is not None else "default"
        return f"MidiInPE(port_name={name})"
