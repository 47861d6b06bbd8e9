"""SoundFont (SF2) synthesizer subsystem of the PyTorch port.

Counterpart of ``pygmu2_tpu.soundfont``. Host side (numpy): SF2/MIDI
parsing, region matching, the offline event simulation and the host
control pass. Device side (PyTorch, hand-written CUDA kernels on the
card): the offline render of :mod:`pygmu2_tpu_torch.soundfont.offline`
and the streaming voice engine of the Synthesizer (``render``,
``render_midi_schedule``; ``MidiFileSequencer.render``).
"""

from pygmu2_tpu_torch.soundfont.model import (
    Generator,
    GeneratorType,
    MeltysynthError,
    Instrument,
    InstrumentRegion,
    LoopMode,
    Preset,
    PresetRegion,
    SampleHeader,
    SampleType,
    SoundFont,
    SoundFontInfo,
    SoundFontVersion,
)
from pygmu2_tpu_torch.soundfont.midi import MidiFile, MidiFileSequencer
from pygmu2_tpu_torch.soundfont.synthesizer import Synthesizer, SynthesizerSettings

__all__ = [
    "Generator",
    "GeneratorType",
    "Instrument",
    "InstrumentRegion",
    "LoopMode",
    "MeltysynthError",
    "MidiFile",
    "MidiFileSequencer",
    "Preset",
    "PresetRegion",
    "SampleHeader",
    "SampleType",
    "SoundFont",
    "SoundFontInfo",
    "SoundFontVersion",
    "Synthesizer",
    "SynthesizerSettings",
]
