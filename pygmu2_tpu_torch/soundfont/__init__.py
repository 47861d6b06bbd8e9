"""SoundFont (SF2) synthesizer subsystem of the PyTorch port.

Counterpart of ``pygmu2_tpu.soundfont``. Host side (numpy): SF2/MIDI
parsing, region matching and the offline event simulation. Device side
(PyTorch, a hand-written CUDA kernel on the card): the offline render of
:mod:`pygmu2_tpu_torch.soundfont.offline`.
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
