"""Jog/shuttle audio player on the port's PE graph.

Counterpart of the JAX package's ``scripts/jogshuttle.py``, as a module of
the port (that script imports the JAX package): a waveform view with
click-and-drag scrubbing, a spring-loaded shuttle slider with a power rate
curve and snap-to-zero, transport buttons (|< Play Pause Stop >|), the
keys Space / Home / End / Escape, playhead polling with a stop at either
end, peaks re-binned on resize, and ``--delete-on-close``.

Three frontends over one toolkit-independent core, ``JogShuttleCore``:

- the Tk window (``TkJogShuttleApp``), where a display and tkinter are
  present;
- a terminal transport (``terminal_transport``): play, a range and a
  rate typed on stdin;
- headless: the core drives the port's ``AudioRenderer`` on ``device``
  (default ``"cuda"``; ``"cpu"`` renders with the kernels' plain
  versions), tested without a sound card in
  ``tests/test_torch_jogshuttle.py``.

The graph is ``WavReaderPE -> TimeWarpPE(rate=ControlPE) -> GainPE``
played as one continuous stream: a pause sets the rate to 0 (the tape
holds), so ``TimeWarpPE``'s carried position is never reset by a gap, and
a scrub is ``TimeWarpPE.seek``, a live state write that the block being
rendered does not overwrite.

Usage: ``python -m pygmu2_tpu_torch.utils.jogshuttle [FILE.wav]
[--delete-on-close] [--terminal] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np

from pygmu2_tpu_torch.utils.wavio import read_wav

AUDIO_DIR = Path(__file__).resolve().parents[2] / "examples" / "audio"

# The shuttle's geometry and the frontends' timers
SHUTTLE_MIN = -8.0
SHUTTLE_MAX = 8.0
SHUTTLE_SNAP_ZERO = 0.3
SHUTTLE_CURVE = 2.0
SPRING_FACTOR = 0.30
PLAYHEAD_POLL_MS = 33
SPRING_BACK_MS = 16


def compute_peaks(path: str, target_width: int = 2000) -> np.ndarray:
    """(target_width, 2) [min, max] peak bins of the file's mono mix."""
    data, _sr = read_wav(path)
    if data.ndim == 2:
        data = data.mean(axis=1)
    n = len(data)
    if n == 0:
        return np.zeros((target_width, 2), dtype=np.float32)
    bin_size = max(1, n // target_width)
    trim = bin_size * target_width
    if trim > n:
        target_width = n // bin_size
        trim = bin_size * target_width
    if target_width == 0:
        return np.zeros((1, 2), dtype=np.float32)
    chunk = data[:trim].reshape(target_width, bin_size)
    return np.column_stack([chunk.min(axis=1), chunk.max(axis=1)]).astype(np.float32)


def slider_to_rate(val: float) -> float:
    """The shuttle's power curve: slider position -> playback rate."""
    if val == 0.0:
        return 0.0
    sign = 1.0 if val > 0 else -1.0
    return sign * (abs(val) / SHUTTLE_MAX) ** SHUTTLE_CURVE * SHUTTLE_MAX


def rate_to_slider(rate: float) -> float:
    """The inverse of :func:`slider_to_rate`."""
    if rate == 0.0:
        return 0.0
    sign = 1.0 if rate > 0 else -1.0
    return sign * (abs(rate) / SHUTTLE_MAX) ** (1.0 / SHUTTLE_CURVE) * SHUTTLE_MAX


class JogShuttleCore:
    """Toolkit-independent transport: the PE graph and the shuttle and
    scrub state. The frontends only draw and forward events.

    ``renderer_factory(sample_rate)`` makes the renderer (default: the
    port's ``AudioRenderer`` at blocks of 1024 on ``device``)."""

    def __init__(self, renderer_factory=None, device="cuda"):
        import pygmu2_tpu_torch as pg

        self._pg = pg
        self.device = device
        self._renderer_factory = renderer_factory or (
            lambda sr: pg.AudioRenderer(sample_rate=sr, blocksize=1024, latency="low",
                                        device=device)
        )
        self.wav_path: str | None = None
        self.sample_rate = 44100
        self.total_frames = 0
        self.channels = 1
        self._wav_pe = None
        self._timewarp = None
        self._rate_control = None
        self._renderer = None
        self.rate = 0.0
        self.shuttle_rest = 0.0  # the rate the shuttle springs back to
        self.shuttle_value = 0.0
        self._scrubbing = False
        self._scrub_was_stopped = False
        self._lock = threading.Lock()

    # ---- file / graph ----

    def load_file(self, path: str) -> None:
        self.teardown()
        data, sr = read_wav(path)
        self.wav_path = path
        self.sample_rate = int(sr)
        self.total_frames = int(len(data))
        self.channels = int(data.shape[1]) if data.ndim == 2 else 1
        self._pg.set_sample_rate(self.sample_rate)
        self._build_graph(path)

    def _build_graph(self, path: str) -> None:
        pg = self._pg
        self._rate_control = pg.ControlPE(initial_value=0.0)
        self._wav_pe = pg.WavReaderPE(path)
        self._timewarp = pg.TimeWarpPE(self._wav_pe, rate=self._rate_control,
                                       max_rate=SHUTTLE_MAX)
        output = pg.GainPE(self._timewarp, 0.8)
        self._renderer = self._renderer_factory(self.sample_rate)
        self._renderer.set_source(output)
        self._renderer.start()
        # one continuous stream; rate 0 is a pause
        self._renderer.stream_start(start=0, end=None)

    def teardown(self) -> None:
        if self._renderer is not None:
            for stop in (self._renderer.stream_stop, self._renderer.stop):
                try:
                    stop()
                except Exception:
                    pass
            self._renderer = None
        self._timewarp = None
        self._rate_control = None
        self._wav_pe = None
        self.rate = 0.0

    close = teardown

    # ---- transport (set_rate is the one point of control) ----

    @property
    def playing(self) -> bool:
        return self.rate != 0.0

    @property
    def position(self) -> float:
        """The tape head's position in source frames."""
        return self._timewarp.position if self._timewarp is not None else 0.0

    def set_rate(self, rate: float) -> None:
        with self._lock:
            self.rate = float(rate)
            if self._rate_control is not None:
                self._rate_control.set_value(float(rate))

    def seek(self, frames: float) -> None:
        if self._timewarp is not None:
            frames = min(max(frames, 0.0), float(self.total_frames))
            self._timewarp.seek(frames)

    def play(self) -> None:
        self.shuttle_rest = 1.0
        self.shuttle_value = rate_to_slider(1.0)
        self.set_rate(1.0)

    def pause(self) -> None:
        self.shuttle_rest = 0.0
        self.shuttle_value = 0.0
        self.set_rate(0.0)

    def toggle_play_pause(self) -> None:
        if self.playing:
            self.pause()
        else:
            self.play()

    def stop(self) -> None:
        """Pause and rewind."""
        self.pause()
        self.seek(0.0)

    def to_beginning(self) -> None:
        self.seek(0.0)

    def to_end(self) -> None:
        self.seek(float(self.total_frames))

    # ---- shuttle ----

    def shuttle_changed(self, val: float) -> float:
        """The slider moved; returns its (possibly snapped) value."""
        if abs(val) < SHUTTLE_SNAP_ZERO:
            val = 0.0
        self.shuttle_value = val
        self.set_rate(slider_to_rate(val))
        return val

    def shuttle_released(self) -> None:
        self.set_rate(self.shuttle_rest)

    def spring_tick(self) -> bool:
        """One step of the spring back; True when settled."""
        target = rate_to_slider(self.shuttle_rest)
        diff = target - self.shuttle_value
        if abs(diff) < 0.05:
            self.shuttle_value = target
            return True
        self.shuttle_value += diff * SPRING_FACTOR
        return False

    # ---- scrubbing on the waveform ----

    def scrub_start(self, frac: float) -> None:
        if self.total_frames == 0 or self._timewarp is None:
            return
        self._scrub_was_stopped = not self.playing
        self._scrubbing = True
        if self._scrub_was_stopped:
            self.set_rate(1.0)  # a scrub from a stop is heard
        self.seek(frac * self.total_frames)

    def scrub_move(self, frac: float) -> None:
        if self._scrubbing:
            self.seek(frac * self.total_frames)

    def scrub_end(self) -> None:
        if self._scrubbing and self._scrub_was_stopped:
            self.set_rate(0.0)
        self._scrubbing = False

    # ---- polling ----

    def poll(self) -> dict:
        """Clamps the playhead, stops at either end, reports the UI state."""
        pos = self.position
        if self._timewarp is not None:
            if pos < 0:
                self.seek(0.0)
                pos = 0.0
            elif pos > self.total_frames:
                self.seek(float(self.total_frames))
                pos = float(self.total_frames)
            if self.playing and not self._scrubbing:
                at_end = pos >= self.total_frames and self.rate > 0
                at_start = pos <= 0 and self.rate < 0
                if at_end or at_start:
                    self.pause()
        frac = pos / self.total_frames if self.total_frames else 0.0
        return {"pos": pos, "frac": frac, "rate": self.rate, "playing": self.playing,
                "time": self.format_time(pos)}

    def format_time(self, frames: float) -> str:
        if self.sample_rate == 0:
            return "00:00.000"
        secs = abs(frames) / self.sample_rate
        mins = int(secs // 60)
        return f"{mins:02d}:{secs - mins * 60:06.3f}"


# ---- the Tk frontend ----


class TkJogShuttleApp:
    """The tkinter jog/shuttle window: waveform scrub canvas, spring-back
    shuttle, transport, keys."""

    WAVE_H = 160
    SHUTTLE_RES = 0.01

    def __init__(self, initial_path: str | None = None, delete_on_close: bool = False,
                 device="cuda"):
        import tkinter as tk
        from tkinter import filedialog

        self._tk = tk
        self._filedialog = filedialog
        self.core = JogShuttleCore(device=device)
        self._delete_on_close = delete_on_close
        self._peaks: np.ndarray | None = None
        self._spring_job = None
        self._resize_job = None
        self._shuttle_held = False

        root = self.root = tk.Tk()
        root.title("pygmu2_tpu_torch Jog/Shuttle Player")
        root.minsize(640, 400)
        root.protocol("WM_DELETE_WINDOW", self._on_close)

        top = tk.Frame(root)
        top.pack(fill="x", padx=8, pady=(8, 0))
        self._file_label = tk.Label(top, text="No file loaded", anchor="w")
        self._file_label.pack(side="left", fill="x", expand=True)
        tk.Button(top, text="Open…", command=self._on_open).pack(side="right")

        self.canvas = tk.Canvas(root, height=self.WAVE_H, bg="#101418", highlightthickness=0)
        self.canvas.pack(fill="both", expand=True, padx=8, pady=8)
        self.canvas.bind("<ButtonPress-1>", self._on_wave_press)
        self.canvas.bind("<B1-Motion>", self._on_wave_drag)
        self.canvas.bind("<ButtonRelease-1>", self._on_wave_release)
        self.canvas.bind("<Configure>", self._on_resize)

        transport = tk.Frame(root)
        transport.pack(pady=(0, 4))
        for text, cmd in [
            ("|<", self.core.to_beginning),
            ("Play", self.core.play),
            ("Pause", self.core.toggle_play_pause),
            ("Stop", self.core.stop),
            (">|", self.core.to_end),
        ]:
            tk.Button(transport, text=text, width=6, command=cmd).pack(side="left", padx=2)

        shuttle_row = tk.Frame(root)
        shuttle_row.pack(fill="x", padx=16)
        self._rate_label = tk.Label(shuttle_row, text="rate 0.00x", width=12)
        self._rate_label.pack(side="right")
        self.shuttle = tk.Scale(
            shuttle_row, from_=SHUTTLE_MIN, to=SHUTTLE_MAX, resolution=self.SHUTTLE_RES,
            orient="horizontal", showvalue=False, command=self._on_shuttle_change,
        )
        self.shuttle.pack(fill="x", expand=True)
        self.shuttle.bind("<ButtonPress-1>", self._on_shuttle_press)
        self.shuttle.bind("<ButtonRelease-1>", self._on_shuttle_release)

        self._pos_label = tk.Label(root, text="Position: --:--.--- (0 samples)",
                                   font="TkFixedFont", anchor="w")
        self._pos_label.pack(fill="x", padx=8, pady=(0, 8))

        root.bind("<space>", lambda e: self.core.toggle_play_pause())
        root.bind("<Home>", lambda e: self.core.to_beginning())
        root.bind("<End>", lambda e: self.core.to_end())
        root.bind("<Escape>", lambda e: self.core.stop())

        if initial_path:
            self._load_file(initial_path)
        self._poll_tick()

    # ---- file ----

    def _on_open(self):
        init_dir = str(AUDIO_DIR) if AUDIO_DIR.is_dir() else ""
        path = self._filedialog.askopenfilename(
            title="Open audio file", initialdir=init_dir,
            filetypes=[("WAV files", "*.wav"), ("All files", "*.*")],
        )
        if path:
            self._load_file(path)

    def _load_file(self, path: str):
        self.core.load_file(path)
        width = max(self.canvas.winfo_width(), 64)
        self._peaks = compute_peaks(path, target_width=width)
        self._draw_wave(0.0)
        dur = self.core.format_time(self.core.total_frames)
        self._file_label.config(text=f"File: {Path(path).name}  ({dur})")

    # ---- the waveform canvas ----

    def _draw_wave(self, frac: float):
        c = self.canvas
        c.delete("all")
        w = max(c.winfo_width(), 1)
        h = max(c.winfo_height(), 1)
        mid = h / 2
        c.create_line(0, mid, w, mid, fill="#2a3138")
        if self._peaks is not None and len(self._peaks):
            n = len(self._peaks)
            for x in range(w):
                i = min(int(x * n / w), n - 1)
                lo, hi = self._peaks[i]
                y0 = mid - hi * (mid - 4)
                y1 = mid - lo * (mid - 4)
                c.create_line(x, y0, x, max(y1, y0 + 1), fill="#4da3ff")
        x = frac * w
        c.create_line(x, 0, x, h, fill="#ff5050", width=2)

    def _wave_frac(self, event) -> float:
        w = max(self.canvas.winfo_width(), 1)
        return min(max(event.x / w, 0.0), 1.0)

    def _on_wave_press(self, event):
        self.core.scrub_start(self._wave_frac(event))

    def _on_wave_drag(self, event):
        self.core.scrub_move(self._wave_frac(event))

    def _on_wave_release(self, event):
        self.core.scrub_end()

    def _on_resize(self, event):
        if self._resize_job is not None:
            self.root.after_cancel(self._resize_job)
        self._resize_job = self.root.after(200, self._do_resize)

    def _do_resize(self):
        self._resize_job = None
        if self.core.wav_path is not None:
            width = self.canvas.winfo_width()
            if width > 10:
                self._peaks = compute_peaks(self.core.wav_path, target_width=width)

    # ---- shuttle ----

    def _on_shuttle_change(self, val):
        if not self._shuttle_held:
            return  # a .set() of the spring back
        snapped = self.core.shuttle_changed(float(val))
        if snapped != float(val):
            self.shuttle.set(snapped)

    def _on_shuttle_press(self, event):
        self._shuttle_held = True
        if self._spring_job is not None:
            self.root.after_cancel(self._spring_job)
            self._spring_job = None

    def _on_shuttle_release(self, event):
        self._shuttle_held = False
        self.core.shuttle_released()
        self._spring_tick()

    def _spring_tick(self):
        settled = self.core.spring_tick()
        self.shuttle.set(self.core.shuttle_value)
        self._spring_job = None if settled else self.root.after(SPRING_BACK_MS,
                                                                self._spring_tick)

    # ---- poll ----

    def _poll_tick(self):
        if self.core.total_frames:
            st = self.core.poll()
            self._draw_wave(st["frac"])
            self._rate_label.config(text=f"rate {st['rate']:+.2f}x")
            self._pos_label.config(text=f"Position: {st['time']} ({int(st['pos'])} samples)")
            if (not st["playing"] and not self._shuttle_held and self._spring_job is None
                    and abs(self.core.shuttle_value) > 1e-9):
                self._spring_tick()
        self.root.after(PLAYHEAD_POLL_MS, self._poll_tick)

    def _on_close(self):
        self.core.close()
        path = self.core.wav_path
        if self._delete_on_close and path is not None:
            try:
                os.remove(path)
            except OSError:
                pass
        self.root.destroy()

    def run(self):
        self.root.mainloop()


# ---- the terminal transport ----


def terminal_transport(path: str, device="cuda") -> None:
    """Plays the file, a range of it or at a rate, by commands on stdin;
    without an audio device each render goes to ``jogshuttle_out.wav`` in
    the temp folder."""
    import pygmu2_tpu_torch as pg

    pg.set_sample_rate(44100)
    reader = pg.WavReaderPE(path)
    n = reader.extent().end or 0
    print(f"{path}: {n} samples ({n / 44100:.2f} s)")
    print("commands: p=play all  h FIRST LAST=play range  r RATE=rate  q=quit")
    rate = 1.0
    out = os.path.join(tempfile.gettempdir(), "jogshuttle_out.wav")
    try:
        import sounddevice  # noqa: F401

        can_play = True
    except ImportError:
        can_play = False
        print(f"(no audio device; renders go to {out})")

    while True:
        try:
            line = input("> ").strip().split()
        except EOFError:
            return
        if not line:
            continue
        if line[0] == "q":
            return
        if line[0] == "r" and len(line) > 1:
            rate = float(line[1])
            print(f"rate = {rate}")
            continue
        if line[0] == "p":
            lo, hi = 0, n
        elif line[0] == "h" and len(line) == 3:
            lo, hi = int(float(line[1]) * 44100), int(float(line[2]) * 44100)
        else:
            continue
        clip = pg.SlicePE(reader, lo, max(1, hi - lo))
        graph = clip if rate == 1.0 else pg.TimeWarpPE(clip, rate=rate)
        if can_play:
            pg.play(graph, device=device)
        else:
            pg.render_to_file(graph, out, device=device)
            print(f"wrote {out}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="pygmu2_tpu_torch Jog/Shuttle Player")
    parser.add_argument("file", nargs="?")
    parser.add_argument("--delete-on-close", action="store_true")
    parser.add_argument("--terminal", action="store_true",
                        help="the stdin transport instead of the window")
    parser.add_argument("--device", default="cuda",
                        help="where the graph renders (cuda or cpu)")
    args = parser.parse_args(argv)

    gui_ok = not args.terminal and os.environ.get("DISPLAY")
    if gui_ok:
        try:
            import tkinter  # noqa: F401
        except ImportError:
            gui_ok = False
    if gui_ok:
        TkJogShuttleApp(initial_path=args.file, delete_on_close=args.delete_on_close,
                        device=args.device).run()
        return 0

    if not args.file:
        print("terminal transport needs a FILE argument", file=sys.stderr)
        return 2
    try:
        terminal_transport(args.file, device=args.device)
    finally:
        if args.delete_on_close:
            Path(args.file).unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
