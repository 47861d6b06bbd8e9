"""pygmu2_tpu_torch: the PyTorch + CUDA port of pygmu2_tpu.

This first slice is the offline SoundFont render: a MIDI score through a
SoundFont to stereo audio, with the audio-rate pass in a hand-written
CUDA kernel for Hopper (``csrc/osc_filter_gain_mix.cu``). Every public
render function takes an explicit ``device`` (default ``"cuda"``); CPU
tensors run the kernels' plain PyTorch versions.
"""

from pygmu2_tpu_torch.soundfont import (
    MidiFile,
    MidiFileSequencer,
    SoundFont,
    Synthesizer,
    SynthesizerSettings,
)
from pygmu2_tpu_torch.soundfont.filter_kernels import (
    osc_filter_gain_mix,
    osc_filter_gain_mix_ref,
)
from pygmu2_tpu_torch.soundfont.offline import (
    render_midi_offline,
    render_midi_offline_streamed,
)

__all__ = [
    "MidiFile",
    "MidiFileSequencer",
    "SoundFont",
    "Synthesizer",
    "SynthesizerSettings",
    "osc_filter_gain_mix",
    "osc_filter_gain_mix_ref",
    "render_midi_offline",
    "render_midi_offline_streamed",
]
