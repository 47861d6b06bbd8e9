"""pygmu2_tpu_torch: the PyTorch + CUDA port of pygmu2_tpu.

The slices so far:

- the offline SoundFont render: a MIDI score through a SoundFont to
  stereo audio, with the audio-rate pass in a hand-written CUDA kernel
  (``csrc/osc_filter_gain_mix.cu``; the control pass on the device, or on
  the host in numpy: ``render_midi_offline_hostctl``);
- the streaming SoundFont synth: ``Synthesizer.render`` /
  ``render_stereo`` / ``render_midi_schedule`` and
  ``MidiFileSequencer.render`` render block by block on the device, the
  per-voice biquad's feedback on the order-2 scan kernel
  (``csrc/affine_scan_2.cu``); ``MeltysynthPE`` and ``MidiInPE`` bring it
  into the PE graph;
- the PE-graph render engine (``core/``) with the PEs of a subtractive
  patch (``models/``): LadderPE, CombPE and the ADSR pair run on
  hand-written CUDA kernels (``csrc/ladder_scan.cu``, ``comb_scan.cu``,
  ``adsr_scan.cu``);
- the effects chain: KarplusStrongPE, EnvelopePE (and with it the
  dynamics family), SlewLimiterPE and ReversePitchEchoPE on hand-written
  CUDA kernels (``csrc/ks_scan.cu``, ``envelope_ar_scan.cu``,
  ``slew_scan.cu``, ``reverse_echo_scan.cu``), with the holds, CachePE,
  BiquadPE and SVFilterPE in plain tensor ops;
- the engine's live half and the PEs that need it: block hooks
  (WavWriterPE, with WavReaderPE and AudioReaderPE), live-control writes
  (ControlPE, TimeWarpPE.seek), the host prelude (TralfamPE, ReverbPE's
  IR energy) and ``render_functional``; with them WavetablePE, WindowPE,
  DelayPE, LoopPE, SlicePE, SequencePE, NoisePE and ConvolvePE/ReverbPE
  (``torch.fft``), all in plain tensor ops;
- the rest of the JAX package's PEs and user utilities, in plain tensor
  ops: RandomPE, the trigger family (TriggerPE, TriggerRestartPE,
  ResetPE, RandomSelectPE), PiecewisePE and PortamentoPE, SuperSawPE and
  AnalogOscPE, SpatialPE with the KEMAR HRTF (read by path from the JAX
  package's asset folder), temperaments and conversions, print_pe_tree,
  the asset loaders, and AudioRenderer with ``play`` / ``play_offline``;
  ``perform_workload`` drives them with the ladder and ADSR kernels;
- ``browse`` with the jog/shuttle player (``utils/jogshuttle.py``), the
  live MIDI demo (``utils/meltysynth_midi_demo.py``), and the comb's and
  the echo's block-order functions (``ops/comb_block.py``,
  ``ops/reverse_echo_block.py``) in plain torch.

Every public render function takes an explicit ``device`` (default
``"cuda"``); CPU tensors run the kernels' plain PyTorch versions.
"""

from pygmu2_tpu_torch.core.audio_renderer import AudioRenderer
from pygmu2_tpu_torch.core.config import (
    ErrorMode,
    get_error_mode,
    get_sample_rate,
    handle_error,
    set_error_mode,
    set_sample_rate,
)
from pygmu2_tpu_torch.core.engine import (
    checkpoint_state,
    render_functional,
    render_scan,
    reset_graph_states,
    restore_state,
)
from pygmu2_tpu_torch.core.extent import Extent, ExtendMode
from pygmu2_tpu_torch.core.logger import get_logger, set_global_logging
from pygmu2_tpu_torch.core.processing_element import ProcessingElement, SourcePE
from pygmu2_tpu_torch.core.renderer import (
    NullRenderer,
    PEProfile,
    ProfileReport,
    Renderer,
)
from pygmu2_tpu_torch.core.snippet import Snippet
from pygmu2_tpu_torch.models.basic import (
    ArrayPE,
    ConstantPE,
    DiracPE,
    GainPE,
    IdentityPE,
    MixPE,
    ParamPE,
    TransformPE,
)
from pygmu2_tpu_torch.models.convolve import ConvolvePE, ReverbPE
from pygmu2_tpu_torch.models.delay import DelayPE
from pygmu2_tpu_torch.models.dynamics import (
    CompressorPE,
    DynamicsPE,
    ExpanderPE,
    LimiterPE,
)
from pygmu2_tpu_torch.models.envelopes import AdsrGatedPE, AdsrTriggeredPE, EnvelopePE
from pygmu2_tpu_torch.models.filters import BiquadPE, SVFilterPE
from pygmu2_tpu_torch.models.gates import (
    GateSignal,
    PeriodicGate,
    PeriodicTrigger,
    TriggerSignal,
)
from pygmu2_tpu_torch.models.holds import (
    CachePE,
    ControlPE,
    SampleHoldPE,
    SlewLimiterPE,
    TrackHoldPE,
)
from pygmu2_tpu_torch.models.io_pes import AudioReaderPE, WavReaderPE, WavWriterPE
from pygmu2_tpu_torch.models.lookup import TimeWarpPE, WavetablePE, WindowPE
from pygmu2_tpu_torch.models.loop_slice import LoopPE, SequencePE, SlicePE
from pygmu2_tpu_torch.models.meltysynth_pe import MeltysynthPE
from pygmu2_tpu_torch.models.midi_in import MidiInPE
from pygmu2_tpu_torch.models.modes import (
    BiquadMode,
    DetectionMode,
    DynamicsMode,
    InterpolationMode,
    LadderMode,
    NoiseMode,
    OutOfBoundsMode,
    RandomMode,
    SequenceMode,
    SlewMode,
    TransitionType,
    WindowMode,
)
from pygmu2_tpu_torch.models.noise import NoisePE
from pygmu2_tpu_torch.models.osc_bandlimited import AnalogOscPE, BlitSawPE, SuperSawPE
from pygmu2_tpu_torch.models.oscillators import FunctionGenPE, SinePE
from pygmu2_tpu_torch.models.physical import CombPE, KarplusStrongPE, LadderPE, rho_for_decay_db
from pygmu2_tpu_torch.models.piecewise import PiecewisePE
from pygmu2_tpu_torch.models.portamento import PortamentoPE
from pygmu2_tpu_torch.models.random_control import RandomPE
from pygmu2_tpu_torch.models.reverse_echo import ReversePitchEchoPE
from pygmu2_tpu_torch.models.spatial import (
    SpatialAdapter,
    SpatialConstantPower,
    SpatialHRTF,
    SpatialLinear,
    SpatialMethod,
    SpatialPE,
)
from pygmu2_tpu_torch.models.tralfam import TralfamPE
from pygmu2_tpu_torch.models.trigger_restart import (
    RandomSelectPE,
    ResetPE,
    TriggerMode,
    TriggerPE,
    TriggerRestartPE,
)
from pygmu2_tpu_torch.models.window import CropPE, SetExtentPE
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
    render_midi_offline_hostctl,
    render_midi_offline_streamed,
)
from pygmu2_tpu_torch.utils.conversions import (
    db_to_ratio,
    freq_to_pitch,
    pitch_to_freq,
    ratio_to_db,
    ratio_to_semitones,
    samples_to_seconds,
    seconds_to_samples,
    semitones_to_ratio,
)
from pygmu2_tpu_torch.utils.assets import (
    AssetLoader,
    AssetManager,
    AudioLibrary,
    GithubUserContentAssetLoader,
    GoogleDriveAssetLoader,
)
from pygmu2_tpu_torch.utils.debug import print_pe_tree
from pygmu2_tpu_torch.utils.playback import (
    browse,
    play,
    play_offline,
    render_to_array,
    render_to_file,
)
from pygmu2_tpu_torch.utils.temperament import (
    CustomTemperament,
    EqualTemperament,
    JustIntonation,
    PythagoreanTuning,
    Temperament,
    get_reference_frequency,
    get_temperament,
    set_baroque_pitch,
    set_concert_pitch,
    set_reference_frequency,
    set_temperament,
    set_verdi_tuning,
)

__version__ = "0.1.0"

__all__ = [
    # configuration and engine
    "ErrorMode",
    "get_error_mode",
    "get_sample_rate",
    "handle_error",
    "set_error_mode",
    "set_sample_rate",
    "Extent",
    "ExtendMode",
    "get_logger",
    "set_global_logging",
    "ProcessingElement",
    "SourcePE",
    "Renderer",
    "NullRenderer",
    "PEProfile",
    "ProfileReport",
    "Snippet",
    "checkpoint_state",
    "render_functional",
    "render_scan",
    "reset_graph_states",
    "restore_state",
    "render_to_array",
    "render_to_file",
    # PEs
    "ArrayPE",
    "ConstantPE",
    "DiracPE",
    "GainPE",
    "IdentityPE",
    "MixPE",
    "ParamPE",
    "TransformPE",
    "CropPE",
    "SetExtentPE",
    "SinePE",
    "FunctionGenPE",
    "GateSignal",
    "TriggerSignal",
    "PeriodicGate",
    "PeriodicTrigger",
    "BlitSawPE",
    "LadderMode",
    "LadderPE",
    "CombPE",
    "AdsrGatedPE",
    "AdsrTriggeredPE",
    "KarplusStrongPE",
    "rho_for_decay_db",
    "EnvelopePE",
    "DetectionMode",
    "DynamicsPE",
    "CompressorPE",
    "LimiterPE",
    "ExpanderPE",
    "DynamicsMode",
    "SlewLimiterPE",
    "SlewMode",
    "SampleHoldPE",
    "TrackHoldPE",
    "CachePE",
    "BiquadPE",
    "SVFilterPE",
    "BiquadMode",
    "ReversePitchEchoPE",
    "MeltysynthPE",
    "MidiInPE",
    "ControlPE",
    "WavReaderPE",
    "AudioReaderPE",
    "WavWriterPE",
    "WavetablePE",
    "TimeWarpPE",
    "WindowPE",
    "InterpolationMode",
    "OutOfBoundsMode",
    "WindowMode",
    "DelayPE",
    "LoopPE",
    "SlicePE",
    "SequencePE",
    "SequenceMode",
    "NoisePE",
    "NoiseMode",
    "TralfamPE",
    "ConvolvePE",
    "ReverbPE",
    # the SoundFont renders, offline and streaming
    "MidiFile",
    "MidiFileSequencer",
    "SoundFont",
    "Synthesizer",
    "SynthesizerSettings",
    "osc_filter_gain_mix",
    "osc_filter_gain_mix_ref",
    "render_midi_offline",
    "render_midi_offline_hostctl",
    "render_midi_offline_streamed",
    # the generative and control PEs
    "RandomPE",
    "RandomMode",
    "RandomSelectPE",
    "TriggerPE",
    "TriggerMode",
    "TriggerRestartPE",
    "ResetPE",
    "PiecewisePE",
    "TransitionType",
    "PortamentoPE",
    "SuperSawPE",
    "AnalogOscPE",
    # spatialisation
    "SpatialPE",
    "SpatialAdapter",
    "SpatialLinear",
    "SpatialConstantPower",
    "SpatialHRTF",
    "SpatialMethod",
    # tuning and conversions
    "Temperament",
    "EqualTemperament",
    "JustIntonation",
    "PythagoreanTuning",
    "CustomTemperament",
    "pitch_to_freq",
    "freq_to_pitch",
    "ratio_to_db",
    "db_to_ratio",
    "semitones_to_ratio",
    "ratio_to_semitones",
    "samples_to_seconds",
    "seconds_to_samples",
    "set_temperament",
    "get_temperament",
    "set_reference_frequency",
    "get_reference_frequency",
    "set_concert_pitch",
    "set_verdi_tuning",
    "set_baroque_pitch",
    # assets, debugging, playback
    "print_pe_tree",
    "AssetManager",
    "AssetLoader",
    "GithubUserContentAssetLoader",
    "GoogleDriveAssetLoader",
    "AudioLibrary",
    "AudioRenderer",
    "play",
    "play_offline",
    "browse",
    "__version__",
]
