"""MeltysynthPE — SoundFont synthesis as a source PE.

Counterpart of ``pygmu2_tpu.models.meltysynth_pe`` (reference:
src/pygmu2/meltysynth_pe.py:28-107): wraps the soundfont Synthesizer into
the PE graph. The port's engine is eager, so the block's trace calls the
synthesizer directly, between its MIDI events, and the stereo block stays
on the render's device (``Synthesizer._render_stereo_device``): no host
round trip. The synthesizer is built at start and runs on the device of
the render that pulls it.

Expose ``.synthesizer`` so a MidiInPE callback can drive
note_on/note_off/process_midi_message between blocks.
"""

from __future__ import annotations

from pathlib import Path

from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.processing_element import SourcePE


class MeltysynthPE(SourcePE):
    """Stereo SoundFont synth source; drive it via ``.synthesizer``."""

    def __init__(
        self,
        soundfont_path: str,
        block_size: int = 64,
        program: int | None = None,
    ):
        self._soundfont_path = str(Path(soundfont_path).resolve())
        self._block_size = block_size
        self._program = program
        self._synthesizer = None

    @property
    def synthesizer(self):
        """The Synthesizer (None until start)."""
        return self._synthesizer

    def _ensure_synth(self):
        if self._synthesizer is None:
            from pygmu2_tpu_torch.soundfont import (
                SoundFont,
                Synthesizer,
                SynthesizerSettings,
            )

            if not Path(self._soundfont_path).exists():
                raise FileNotFoundError(
                    f"SoundFont not found: {self._soundfont_path}"
                )
            sound_font = SoundFont.from_file(self._soundfont_path)
            settings = SynthesizerSettings(
                sample_rate=self.sample_rate or 44100,
                block_size=self._block_size,
            )
            self._synthesizer = Synthesizer(sound_font, settings)
            if self._program is not None:
                self._synthesizer.process_midi_message(0, 0xC0, self._program, 0)

    def _on_start(self) -> None:
        self._ensure_synth()

    def _on_stop(self) -> None:
        self._synthesizer = None

    def is_pure(self) -> bool:
        return False

    def channel_count(self) -> int:
        return 2

    def _compute_extent(self) -> Extent:
        return Extent(None, None)

    def _trace(self, ctx):
        self._ensure_synth()
        synth = self._synthesizer
        if synth.device != ctx.device:
            synth._move_to(ctx.device)
        return synth._render_stereo_device(ctx.duration)

    def __repr__(self) -> str:
        return f"MeltysynthPE(soundfont_path='{self._soundfont_path}')"
