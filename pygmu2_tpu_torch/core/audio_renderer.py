"""Realtime audio playback renderer.

Counterpart of ``pygmu2_tpu.core.audio_renderer`` (reference:
src/pygmu2/audio_renderer.py:23-310): blocking playback (``play_range`` /
``play_extent``) and callback streaming (``stream_start/stop/wait``) via
PortAudio through the optional ``sounddevice`` package.

The graph renders on the renderer's ``device`` (default ``"cuda"``), one
block per render call, and each block's frames come back to the host as
float32 numpy for the output stream. ``device`` is the compute device, as
for every renderer of the port; the audio output device, which the JAX
package's renderer calls ``device``, is ``output_device`` here.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from pygmu2_tpu_torch.core.config import handle_error
from pygmu2_tpu_torch.core.logger import get_logger
from pygmu2_tpu_torch.core.renderer import Renderer
from pygmu2_tpu_torch.core.snippet import Snippet

_log = get_logger(__name__)

try:  # PortAudio is an optional host dependency.
    import sounddevice as _sd
except Exception:  # pragma: no cover - absent in CI image
    _sd = None


def _require_sd():
    if _sd is None:
        raise RuntimeError(
            "AudioRenderer requires the 'sounddevice' package (PortAudio). "
            "Install it, or use NullRenderer / render_to_file for offline use."
        )
    return _sd


class AudioRenderer(Renderer):
    """Plays the graph through the default audio output device."""

    def __init__(
        self,
        sample_rate: int = 44100,
        blocksize: int = 1024,
        device="cuda",
        latency=None,
        output_device=None,
    ):
        super().__init__(sample_rate=sample_rate, device=device)
        self._blocksize = int(blocksize)
        self._output_device = output_device
        self._latency = latency
        self._stream = None
        self._stream_position = 0
        self._stream_done = threading.Event()
        self._stream_underruns = 0
        self._stream_batch = 1

    @property
    def device(self):
        """The device the graph renders on (``"cuda"`` or ``"cpu"``)."""
        return self._device

    @property
    def output_device(self):
        """Audio output device index/name (None = system default)."""
        return self._output_device

    @property
    def blocksize(self) -> int:
        return self._blocksize

    # ---- blocking playback ----------------------------------------------

    def _output(self, snippet: Snippet) -> None:
        sd = _require_sd()
        if self._stream is None:
            self._stream = sd.OutputStream(
                samplerate=self._sample_rate,
                channels=snippet.channels,
                blocksize=self._blocksize,
                device=self._output_device,
                latency=self._latency,
                dtype="float32",
            )
            self._stream.start()
        self._stream.write(np.ascontiguousarray(snippet.data))

    def play_range(self, start: int, duration: int, chunk_size: int | None = None) -> None:
        """Blocking playback of ``[start, start+duration)`` in chunks."""
        chunk = chunk_size or self._blocksize * 16
        pos = start
        end = start + duration
        while pos < end:
            n = min(chunk, end - pos)
            self.render(pos, n)
            pos += n
        self._close_stream()

    def play_extent(self, chunk_size: int | None = None) -> None:
        """Blocking playback of the source's full (finite) extent."""
        if self._source is None:
            handle_error("No source set. Call set_source() first.", fatal=True)
        extent = self._source.extent()
        if extent.start is None or extent.end is None:
            handle_error(
                "Cannot play infinite extent; use play_range() or streaming.",
                fatal=True,
            )
        self.play_range(extent.start, extent.end - extent.start, chunk_size)

    def _close_stream(self) -> None:
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None

    def stop(self) -> None:
        self.stream_stop()
        self._close_stream()
        super().stop()

    # ---- callback streaming ---------------------------------------------

    def stream_start(
        self,
        start: int = 0,
        end: int | None = None,
        *,
        batch_blocks: int | None = None,
        queue_seconds: float = 0.25,
    ) -> None:
        """Start callback-driven playback of ``[start, end)`` (``end=None``
        plays to the source extent's end).

        The PortAudio callback thread pulls pre-rendered blocks; a feeder
        thread keeps the device ahead of the DAC. The feeder renders
        ``batch_blocks`` blocks per render call so a fixed per-call cost
        (the host's enqueue and the block's download) is amortised below
        one block duration; ``batch_blocks=None`` adapts automatically —
        the batch doubles whenever a call takes more than half the audio
        duration it produced (chunked==oneshot invariance makes the K-block
        render equal K single-block renders). ``queue_seconds`` sizes
        the read-ahead queue — the underrun cushion — and bounds the extra
        live-control latency; live players should lower it.
        """
        sd = _require_sd()
        if self._source is None:
            handle_error("No source set. Call set_source() first.", fatal=True)
        if not self._started:
            handle_error("Not started. Call start() first.", fatal=True)
        if self.is_streaming:
            handle_error(
                "Already streaming. Call stream_stop() first.", fatal=True
            )

        import queue

        self._stream_position = start
        self._stream_done.clear()
        self._stream_underruns = 0
        channels = self.channel_count or 1
        bs = self._blocksize
        sr = self._sample_rate
        maxq = max(4, int(round(queue_seconds * sr / bs)))
        q: "queue.Queue[np.ndarray | None]" = queue.Queue(maxsize=maxq)
        extent = self._source.extent()
        stop_at = end if end is not None else extent.end
        stop_flag = threading.Event()

        def put(item) -> bool:
            # Bounded put so stream_stop() can always unblock the feeder:
            # after stop, nothing drains the queue, and a daemon thread
            # parked in q.put() at interpreter exit aborts the process
            # mid-render.
            while not stop_flag.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            pos = start
            k = 1 if batch_blocks is None else max(1, int(batch_blocks))
            adaptive = batch_blocks is None
            k_max = 64
            try:
                while not stop_flag.is_set():
                    if stop_at is not None and pos >= stop_at:
                        put(None)
                        return
                    n = k * bs
                    if stop_at is not None:
                        n = min(n, int(stop_at) - pos)
                    t0 = time.monotonic()
                    snippet = self._source.render(pos, n, device=self._device)
                    data = np.ascontiguousarray(snippet.data)
                    dt = time.monotonic() - t0
                    if adaptive and k < k_max and dt > 0.5 * (n / sr):
                        k = min(k_max, k * 2)
                    self._stream_batch = k
                    for i in range(0, data.shape[0], bs):
                        if not put(data[i : i + bs]):
                            return
                    pos += n
            except Exception:  # pragma: no cover - render failure mid-stream
                _log.exception("stream feeder failed; ending stream")
                put(None)

        self._feeder_stop = stop_flag
        self._stream_batch = 1
        self._feeder = threading.Thread(target=feeder, daemon=True)
        self._feeder.start()

        def callback(outdata, frames, time_info, status):
            try:
                block = q.get_nowait()
            except Exception:
                block = np.zeros((frames, channels), np.float32)
                self._stream_underruns += 1
            if block is None:
                raise sd.CallbackStop()
            n = min(frames, block.shape[0])
            outdata[:n] = block[:n]
            if n < frames:
                outdata[n:] = 0
            self._stream_position += frames

        self._cb_stream = sd.OutputStream(
            samplerate=self._sample_rate,
            channels=channels,
            blocksize=self._blocksize,
            device=self._output_device,
            latency=self._latency,
            dtype="float32",
            callback=callback,
            finished_callback=self._stream_done.set,
        )
        # Prefill: don't open the DAC until the read-ahead cushion can
        # cover a render call — opening on an empty (or one-block) queue
        # plays the first calls (the kernels' first load, and the
        # adaptive batch ramp) as an underrun burst of silence. Half the
        # queue bounds the added startup latency at queue_seconds/2.
        prefill = max(1, maxq // 2)
        while q.qsize() < prefill and self._feeder.is_alive():
            time.sleep(0.002)
        self._cb_stream.start()

    def stream_stop(self) -> None:
        """Stop callback streaming (no-op if not streaming)."""
        if getattr(self, "_feeder_stop", None) is not None:
            self._feeder_stop.set()
        stream = getattr(self, "_cb_stream", None)
        if stream is not None:
            stream.stop()
            stream.close()
            self._cb_stream = None
        feeder = getattr(self, "_feeder", None)
        if feeder is not None and feeder.is_alive():
            # Let an in-flight render finish — a daemon thread killed
            # inside a render at interpreter exit aborts the process.
            feeder.join(timeout=5.0)
        self._stream_done.set()

    def stream_wait(self, timeout: float | None = None) -> bool:
        """Block until streaming finishes; returns False on timeout."""
        return self._stream_done.wait(timeout)

    @property
    def stream_position(self) -> int:
        """Current playback position in samples."""
        return self._stream_position

    @property
    def stream_underruns(self) -> int:
        """Callback invocations that found the read-ahead queue empty
        (zero-filled output) since the last ``stream_start``."""
        return self._stream_underruns

    @property
    def stream_batch(self) -> int:
        """Current feeder batch size in blocks (adapts upward when a
        render call costs more than half the audio duration it renders)."""
        return self._stream_batch

    @property
    def is_streaming(self) -> bool:
        """True while callback streaming is active and unfinished."""
        return (
            getattr(self, "_cb_stream", None) is not None
            and not self._stream_done.is_set()
        )

    # ---- device info -----------------------------------------------------

    @staticmethod
    def list_devices():
        """Enumerate audio output devices."""
        sd = _require_sd()
        return sd.query_devices()

    @staticmethod
    def get_default_device():
        """Info dict for the system default output device."""
        sd = _require_sd()
        devices = sd.query_devices()
        default = getattr(sd, "default", None)
        idx = None
        if default is not None:
            dev = getattr(default, "device", None)
            if isinstance(dev, (tuple, list)) and len(dev) == 2:
                idx = dev[1]  # (input, output)
            elif isinstance(dev, int):
                idx = dev
        if idx is None or idx < 0:
            for i, d in enumerate(devices):
                if d.get("max_output_channels", 0) > 0:
                    idx = i
                    break
        return devices[idx] if idx is not None else None

    def __repr__(self) -> str:
        return (
            f"AudioRenderer(sample_rate={self._sample_rate}, "
            f"blocksize={self._blocksize}, device={self._device!r})"
        )
