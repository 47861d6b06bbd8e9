"""Standard MIDI file parsing and sequencing.

Copy of ``pygmu2_tpu.soundfont.midi`` for the PyTorch port (numpy only,
no JAX): SMF format 0/1, running status, tempo-map merge to absolute
seconds. ``MidiFileSequencer`` drives a Synthesizer block by block
(``render``, the streaming engine on the synthesizer's device);
``render_to_array`` renders offline through
:func:`pygmu2_tpu_torch.soundfont.offline.render_midi_offline`.
"""

from __future__ import annotations

import enum
import io
import struct

import numpy as np

from pygmu2_tpu_torch.soundfont.model import MeltysynthError


class MidiMessageType(enum.IntEnum):
    NORMAL = 0
    TEMPO_CHANGE = 252
    END_OF_TRACK = 255


class MidiMessage:
    __slots__ = ("channel", "command", "data1", "data2")

    def __init__(self, channel: int, command: int, data1: int, data2: int):
        self.channel = channel & 0xFF
        self.command = command & 0xFF
        self.data1 = data1 & 0xFF
        self.data2 = data2 & 0xFF

    @property
    def type(self) -> MidiMessageType:
        if self.channel == MidiMessageType.TEMPO_CHANGE:
            return MidiMessageType.TEMPO_CHANGE
        if self.channel == MidiMessageType.END_OF_TRACK:
            return MidiMessageType.END_OF_TRACK
        return MidiMessageType.NORMAL

    @property
    def tempo(self) -> float:
        return 60000000.0 / ((self.command << 16) | (self.data1 << 8) | self.data2)

    def __repr__(self) -> str:
        return (
            f"MidiMessage(ch={self.channel}, cmd=0x{self.command:02x}, "
            f"d1={self.data1}, d2={self.data2})"
        )


def _read_u8(f) -> int:
    b = f.read(1)
    if not b:
        raise MeltysynthError("Unexpected end of MIDI data.")
    return b[0]


def _read_varint(f) -> int:
    value = 0
    for _ in range(4):
        b = _read_u8(f)
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value
    raise MeltysynthError("Invalid variable-length quantity.")


class MidiFile:
    """Parsed SMF with messages merged onto one absolute-time stream."""

    def __init__(self, source):
        if isinstance(source, (str,)):
            with open(source, "rb") as f:
                data = f.read()
        elif isinstance(source, bytes):
            data = source
        else:
            data = source.read()
        self._parse(io.BytesIO(data))

    @classmethod
    def from_file(cls, file_path) -> "MidiFile":
        return cls(str(file_path))

    def _parse(self, f) -> None:
        if f.read(4) != b"MThd":
            raise MeltysynthError("The chunk type must be 'MThd'.")
        size = struct.unpack(">i", f.read(4))[0]
        if size != 6:
            raise MeltysynthError("The MThd chunk has invalid data.")
        fmt, track_count, resolution = struct.unpack(">hhh", f.read(6))
        if fmt not in (0, 1):
            raise MeltysynthError(f"The format {fmt} is not supported.")
        self._track_count = track_count
        self._resolution = resolution

        tracks = [self._read_track(f) for _ in range(track_count)]
        self._messages, self._times = self._merge(tracks, resolution)

    @staticmethod
    def _read_track(f):
        if f.read(4) != b"MTrk":
            raise MeltysynthError("The chunk type must be 'MTrk'.")
        end = struct.unpack(">i", f.read(4))[0] + f.tell()
        messages: list[MidiMessage] = []
        ticks: list[int] = []
        tick = 0
        last_status = 0
        while True:
            tick += _read_varint(f)
            first = _read_u8(f)
            if (first & 0x80) == 0:
                # running status: `first` is data1
                command = last_status & 0xF0
                if command in (0xC0, 0xD0):
                    messages.append(
                        MidiMessage(last_status & 0x0F, command, first, 0)
                    )
                else:
                    messages.append(
                        MidiMessage(last_status & 0x0F, command, first, _read_u8(f))
                    )
                ticks.append(tick)
                continue
            if first in (0xF0, 0xF7):
                f.seek(_read_varint(f), io.SEEK_CUR)
            elif first == 0xFF:
                meta = _read_u8(f)
                if meta == 0x2F:
                    _read_u8(f)
                    messages.append(
                        MidiMessage(MidiMessageType.END_OF_TRACK, 0, 0, 0)
                    )
                    ticks.append(tick)
                    if f.tell() < end:
                        f.seek(end, io.SEEK_SET)
                    return messages, ticks
                elif meta == 0x51:
                    if _read_varint(f) != 3:
                        raise MeltysynthError("Failed to read the tempo value.")
                    b1, b2, b3 = _read_u8(f), _read_u8(f), _read_u8(f)
                    messages.append(
                        MidiMessage(MidiMessageType.TEMPO_CHANGE, b1, b2, b3)
                    )
                    ticks.append(tick)
                else:
                    f.seek(_read_varint(f), io.SEEK_CUR)
            else:
                command = first & 0xF0
                if command in (0xC0, 0xD0):
                    messages.append(
                        MidiMessage(first & 0x0F, command, _read_u8(f), 0)
                    )
                else:
                    d1 = _read_u8(f)
                    d2 = _read_u8(f)
                    messages.append(MidiMessage(first & 0x0F, command, d1, d2))
                ticks.append(tick)
                last_status = first

    @staticmethod
    def _merge(tracks, resolution):
        """K-way merge by tick, applying the tempo map for wall times."""
        messages: list[MidiMessage] = []
        times: list[float] = []
        indices = [0] * len(tracks)
        current_tick = 0
        current_time = 0.0
        tempo = 120.0
        while True:
            best = -1
            best_tick = None
            for i, (msgs, ticks) in enumerate(tracks):
                if indices[i] < len(ticks):
                    t = ticks[indices[i]]
                    if best_tick is None or t < best_tick:
                        best_tick = t
                        best = i
            if best < 0:
                break
            delta = best_tick - current_tick
            current_time += 60.0 / (resolution * tempo) * delta
            current_tick = best_tick
            msg = tracks[best][0][indices[best]]
            if msg.type == MidiMessageType.TEMPO_CHANGE:
                tempo = msg.tempo
            else:
                messages.append(msg)
                times.append(current_time)
            indices[best] += 1
        return messages, times

    @property
    def track_count(self) -> int:
        return self._track_count

    @property
    def resolution(self) -> int:
        return self._resolution

    @property
    def length(self) -> float:
        """Duration in seconds (time of the last event)."""
        return self._times[-1] if self._times else 0.0

    @property
    def messages(self):
        return self._messages

    @property
    def times(self):
        return self._times

    def __repr__(self) -> str:
        return f"MidiFile(tracks={self._track_count}, events={len(self._messages)})"


class MidiFileSequencer:
    """Feeds a MidiFile's events to a Synthesizer while rendering."""

    def __init__(self, synthesizer):
        self._synthesizer = synthesizer
        self._midi_file: MidiFile | None = None
        self._loop = False
        self._block_wrote = 0
        self._current_time = 0.0
        self._msg_index = 0

    def play(self, midi_file: MidiFile, loop: bool = False) -> None:
        self._midi_file = midi_file
        self._loop = loop
        self._block_wrote = self._synthesizer.block_size
        self._current_time = 0.0
        self._msg_index = 0
        self._synthesizer.reset()

    def stop(self) -> None:
        self._midi_file = None
        self._synthesizer.reset()

    def render(self, left, right, offset: int | None = None, count: int | None = None) -> None:
        """Block-accurate streaming render into the provided buffers: the
        events due at a block's start go to the synthesizer before it
        renders that block (``Synthesizer.render``, on its device)."""
        if len(left) != len(right):
            raise MeltysynthError(
                "The output buffers for the left and right must be the same length."
            )
        if offset is None:
            offset = 0
        elif count is None:
            raise ValueError("'count' must be set if 'offset' is set.")
        if count is None:
            count = len(left)
        wrote = 0
        while wrote < count:
            if self._block_wrote == self._synthesizer.block_size:
                self._process_events()
                self._block_wrote = 0
                self._current_time += (
                    self._synthesizer.block_size / self._synthesizer.sample_rate
                )
            src_rem = self._synthesizer.block_size - self._block_wrote
            rem = min(src_rem, count - wrote)
            self._synthesizer.render(left, right, offset + wrote, rem)
            self._block_wrote += rem
            wrote += rem

    def _process_events(self) -> None:
        if self._midi_file is None:
            return
        while self._msg_index < len(self._midi_file.messages):
            time = self._midi_file.times[self._msg_index]
            msg = self._midi_file.messages[self._msg_index]
            if time <= self._current_time:
                if msg.type == MidiMessageType.NORMAL:
                    self._synthesizer.process_midi_message(
                        msg.channel, msg.command, msg.data1, msg.data2
                    )
                self._msg_index += 1
            else:
                break
        if self._loop and self._msg_index == len(self._midi_file.messages):
            self._current_time = 0.0
            self._msg_index = 0
            self._synthesizer.note_off_all(False)

    def render_to_array(self, seconds: float, device="cuda") -> np.ndarray:
        """Offline render of the playing score on ``device``.

        Returns (samples, 2) float32. With no score playing (before
        ``play`` / after ``stop``) returns silence. ``play(..., loop=True)``
        is honored by tiling the event list every score length with an
        all-notes-off (CC 123 on every channel) at each rewind.
        """
        from pygmu2_tpu_torch.soundfont.offline import render_midi_offline

        if self._midi_file is None:
            total = int(round(seconds * self._synthesizer.sample_rate))
            return np.zeros((total, 2), np.float32)
        midi = self._midi_file
        if self._loop and midi.length > 0 and seconds > midi.length:
            midi = _tiled_midi(midi, seconds)
        return render_midi_offline(
            self._synthesizer, midi, seconds, device=device
        )


class _TiledMidi:
    """Looped view of a MidiFile: events repeated every score length."""

    __slots__ = ("messages", "times", "length")

    def __init__(self, messages, times, length):
        self.messages = messages
        self.times = times
        self.length = length


def _tiled_midi(midi: MidiFile, seconds: float) -> _TiledMidi:
    period = float(midi.length)
    reps = int(np.ceil(seconds / period))
    msgs: list[MidiMessage] = []
    times: list[float] = []
    for k in range(reps):
        t0 = k * period
        if k > 0:
            # rewind boundary: release everything still sounding
            for ch in range(16):
                msgs.append(MidiMessage(ch, 0xB0, 0x7B, 0))
                times.append(t0)
        for t, m in zip(midi.times, midi.messages):
            if m.type != MidiMessageType.NORMAL:
                continue
            msgs.append(m)
            times.append(t0 + float(t))
    return _TiledMidi(msgs, times, reps * period)
