"""SF2 unit math and note→voice parameter resolution (host side).

Copy of ``pygmu2_tpu.soundfont.params`` (numpy only, so the PyTorch port
imports no JAX). Rebuild of the reference's math_utils + region_pair + region_ex
(reference: src/pygmu2/meltysynth/math_utils.py, synth/region_pair.py,
synth/region_ex.py, voice.py:49-112). All SF2 region complexity resolves
HOST-side at note-on into one flat ``VoiceParams`` record of plain floats
— the device engine only ever sees numeric arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from pygmu2_tpu_torch.soundfont.model import GeneratorType as G
from pygmu2_tpu_torch.soundfont.model import InstrumentRegion, LoopMode, PresetRegion

NON_AUDIBLE = 1.0e-3
LOG_NON_AUDIBLE = math.log(NON_AUDIBLE)
HALF_PI = math.pi / 2


def timecents_to_seconds(x: float) -> float:
    return 2.0 ** (x / 1200.0)


def cents_to_hertz(x: float) -> float:
    return 8.176 * 2.0 ** (x / 1200.0)


def cents_to_multiplying_factor(x: float) -> float:
    return 2.0 ** (x / 1200.0)


def decibels_to_linear(x: float) -> float:
    return 10.0 ** (0.05 * x)


def linear_to_decibels(x: float) -> float:
    return 20.0 * math.log10(x)


def key_number_to_multiplying_factor(cents: int, key: int) -> float:
    return timecents_to_seconds(cents * (60 - key))


def exp_cutoff(x: float) -> float:
    return 0.0 if x < LOG_NON_AUDIBLE else math.exp(x)


def clamp(value, lo, hi):
    return max(lo, min(hi, value))


class RegionPair:
    """Preset generators add to instrument generators (SF2 rule)."""

    def __init__(self, preset: PresetRegion, instrument: InstrumentRegion):
        self.preset = preset
        self.instrument = instrument

    def gen(self, gtype: G) -> int:
        return int(self.preset._gs[gtype]) + int(self.instrument._gs[gtype])


@dataclass
class EnvelopeParams:
    """Closed-form envelope timeline (times in seconds from voice start)."""

    attack_start: float
    hold_start: float
    decay_start: float
    attack_slope: float
    decay_slope: float
    release_slope: float
    sustain: float
    # Modulation envelope extras (linear decay/release toward sustain/zero)
    decay_end: float = 0.0
    release_end: float = 0.0


@dataclass
class VoiceParams:
    """Everything the engine needs to run one voice (flat floats/ints)."""

    channel: int
    key: int
    velocity: int
    exclusive_class: int
    note_gain: float
    cutoff: float
    resonance: float
    vib_lfo_to_pitch: float
    mod_lfo_to_pitch: float
    mod_env_to_pitch: float
    mod_lfo_to_cutoff: float
    mod_env_to_cutoff: float
    mod_lfo_to_volume: float
    instrument_pan: float
    vol_env: EnvelopeParams = None
    mod_env: EnvelopeParams = None
    vib_lfo_delay: float = 0.0
    vib_lfo_period: float = 0.0  # 0 = inactive
    mod_lfo_delay: float = 0.0
    mod_lfo_period: float = 0.0
    # Oscillator
    sample_start: int = 0
    sample_end: int = 0
    start_loop: int = 0
    end_loop: int = 0
    loop_mode: int = 0
    root_key: int = 60
    tune: float = 0.0
    pitch_change_scale: float = 1.0
    sample_rate_ratio: float = 1.0


def resolve_voice_params(
    region: RegionPair, channel: int, key: int, velocity: int, synth_rate: int
) -> VoiceParams:
    """The note-on computation (reference voice.py:49-112 + region_ex)."""
    inst = region.instrument

    if velocity > 0:
        sample_attenuation = 0.4 * (0.1 * region.gen(G.INITIAL_ATTENUATION))
        filter_attenuation = 0.5 * (0.1 * region.gen(G.INITIAL_FILTER_Q))
        decibels = (
            2 * linear_to_decibels(velocity / 127.0)
            - sample_attenuation
            - filter_attenuation
        )
        note_gain = decibels_to_linear(decibels)
    else:
        note_gain = 0.0

    cutoff = cents_to_hertz(region.gen(G.INITIAL_FILTER_CUTOFF_FREQUENCY))
    resonance = decibels_to_linear(0.1 * region.gen(G.INITIAL_FILTER_Q))

    # Volume envelope
    vol_delay = timecents_to_seconds(region.gen(G.DELAY_VOLUME_ENVELOPE))
    vol_attack = timecents_to_seconds(region.gen(G.ATTACK_VOLUME_ENVELOPE))
    vol_hold = timecents_to_seconds(
        region.gen(G.HOLD_VOLUME_ENVELOPE)
    ) * key_number_to_multiplying_factor(
        region.gen(G.KEY_NUMBER_TO_VOLUME_ENVELOPE_HOLD), key
    )
    vol_decay = timecents_to_seconds(
        region.gen(G.DECAY_VOLUME_ENVELOPE)
    ) * key_number_to_multiplying_factor(
        region.gen(G.KEY_NUMBER_TO_VOLUME_ENVELOPE_DECAY), key
    )
    vol_sustain = decibels_to_linear(-(0.1 * region.gen(G.SUSTAIN_VOLUME_ENVELOPE)))
    vol_release = max(
        timecents_to_seconds(region.gen(G.RELEASE_VOLUME_ENVELOPE)), 0.01
    )
    vol_env = EnvelopeParams(
        attack_start=vol_delay,
        hold_start=vol_delay + vol_attack,
        decay_start=vol_delay + vol_attack + vol_hold,
        attack_slope=1.0 / vol_attack,
        decay_slope=-9.226 / vol_decay,
        release_slope=-9.226 / vol_release,
        sustain=clamp(vol_sustain, 0.0, 1.0),
    )

    # Modulation envelope (linear ramps; reference ModulationEnvelope)
    mod_delay = timecents_to_seconds(region.gen(G.DELAY_MODULATION_ENVELOPE))
    mod_attack = timecents_to_seconds(
        region.gen(G.ATTACK_MODULATION_ENVELOPE)
    ) * ((145 - velocity) / 144.0)
    mod_hold = timecents_to_seconds(
        region.gen(G.HOLD_MODULATION_ENVELOPE)
    ) * key_number_to_multiplying_factor(
        region.gen(G.KEY_NUMBER_TO_MODULATION_ENVELOPE_HOLD), key
    )
    mod_decay = timecents_to_seconds(region.gen(G.DECAY_MODULATION_ENVELOPE))
    mod_decay *= key_number_to_multiplying_factor(
        region.gen(G.KEY_NUMBER_TO_MODULATION_ENVELOPE_DECAY), key
    )
    mod_sustain = clamp(
        1.0 - (0.1 * region.gen(G.SUSTAIN_MODULATION_ENVELOPE)) / 100.0, 0.0, 1.0
    )
    mod_release = timecents_to_seconds(region.gen(G.RELEASE_MODULATION_ENVELOPE))
    mod_env = EnvelopeParams(
        attack_start=mod_delay,
        hold_start=mod_delay + mod_attack,
        decay_start=mod_delay + mod_attack + mod_hold,
        attack_slope=1.0 / mod_attack,
        decay_slope=1.0 / mod_decay,
        release_slope=1.0 / mod_release,
        sustain=mod_sustain,
        decay_end=mod_delay + mod_attack + mod_hold + mod_decay,
        release_end=mod_release,
    )

    vib_freq = cents_to_hertz(region.gen(G.FREQUENCY_VIBRATO_LFO))
    mod_freq = cents_to_hertz(region.gen(G.FREQUENCY_MODULATION_LFO))

    sample_rate = inst.sample.sample_rate

    return VoiceParams(
        channel=channel,
        key=key,
        velocity=velocity,
        exclusive_class=inst.exclusive_class,
        note_gain=note_gain,
        cutoff=cutoff,
        resonance=resonance,
        vib_lfo_to_pitch=0.01 * region.gen(G.VIBRATO_LFO_TO_PITCH),
        mod_lfo_to_pitch=0.01 * region.gen(G.MODULATION_LFO_TO_PITCH),
        mod_env_to_pitch=0.01 * region.gen(G.MODULATION_ENVELOPE_TO_PITCH),
        mod_lfo_to_cutoff=float(
            region.gen(G.MODULATION_LFO_TO_FILTER_CUTOFF_FREQUENCY)
        ),
        mod_env_to_cutoff=float(
            region.gen(G.MODULATION_ENVELOPE_TO_FILTER_CUTOFF_FREQUENCY)
        ),
        mod_lfo_to_volume=0.1 * region.gen(G.MODULATION_LFO_TO_VOLUME),
        instrument_pan=clamp(0.1 * region.gen(G.PAN), -50.0, 50.0),
        vol_env=vol_env,
        mod_env=mod_env,
        vib_lfo_delay=timecents_to_seconds(region.gen(G.DELAY_VIBRATO_LFO)),
        vib_lfo_period=(1.0 / vib_freq) if vib_freq > 1.0e-3 else 0.0,
        mod_lfo_delay=timecents_to_seconds(region.gen(G.DELAY_MODULATION_LFO)),
        mod_lfo_period=(1.0 / mod_freq) if mod_freq > 1.0e-3 else 0.0,
        sample_start=inst.sample_start,
        sample_end=inst.sample_end,
        start_loop=inst.sample_start_loop,
        end_loop=inst.sample_end_loop,
        loop_mode=int(inst.sample_modes),
        root_key=inst.root_key,
        tune=inst.coarse_tune + 0.01 * inst.fine_tune,
        pitch_change_scale=0.01 * inst.scale_tuning,
        sample_rate_ratio=sample_rate / synth_rate,
    )
