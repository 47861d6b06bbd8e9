"""SoundFont synthesizer: the host event machine and the per-block voice
engine on a PyTorch device.

Counterpart of ``pygmu2_tpu.soundfont.synthesizer`` for the PyTorch port.
Every per-voice quantity is a struct-of-arrays of shape
``(polyphony,)``: ``note_on`` resolves SF2 regions to a flat numeric
parameter record (see ``params.resolve_voice_params``) written into numpy
mirrors, and voice allocation/stealing uses closed-form envelope
priorities on the host. The offline event simulation
(``build_schedule`` / ``build_schedule_segments``) is bit-identical to
the JAX package's.

The streaming engine (``render``, ``render_stereo``,
``render_midi_schedule``) renders one block for all voices at once on the
synthesizer's device (``device=``, the card unless the caller asks for the
CPU): :meth:`Synthesizer._block_kernel` in tensor ops, the envelopes and
LFOs as closed forms of voice time (the control helpers of
:mod:`pygmu2_tpu_torch.soundfont.offline`), the oscillator a gather and a
lerp over ``(voices, block)``, the per-voice biquad's feedback one launch
of the order-2 scan kernel (``ops/linrec_kernel.affine_scan_2_kernel``,
``csrc/affine_scan_2.cu`` on the card) and the stereo mix a reduction over
voices. The device passes of the one-launch offline render live in
:mod:`pygmu2_tpu_torch.soundfont.offline`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from pygmu2_tpu_torch.ops.linrec_kernel import affine_scan_2_kernel
from pygmu2_tpu_torch.ops.xla_math import fmaf
from pygmu2_tpu_torch.soundfont import offline as _ctl
from pygmu2_tpu_torch.soundfont.convert import (
    _CH_F32,
    _PAR_F32,
    _PAR_F64,
    _PAR_I32,
    _pack_schedule_np,
    to_torch,
)
from pygmu2_tpu_torch.soundfont.midi import MidiFile, MidiMessageType
from pygmu2_tpu_torch.soundfont.model import LoopMode, MeltysynthError, SoundFont
from pygmu2_tpu_torch.soundfont.params import (
    NON_AUDIBLE,
    RegionPair,
    VoiceParams,
    resolve_voice_params,
)
LOG_NON_AUDIBLE = math.log(NON_AUDIBLE)
_NO_RELEASE = np.int32(2**31 - 1)

# Parameter fields: (name, dtype). All arrays are (polyphony,).
_PAR_FIELDS = [
    ("epoch", np.int32),
    ("channel", np.int32),
    ("key", np.float32),
    ("note_gain", np.float32),
    ("cutoff", np.float32),
    ("resonance", np.float32),
    ("vib2pitch", np.float32),
    ("mod2pitch", np.float32),
    ("modenv2pitch", np.float32),
    ("modlfo2cut", np.float32),
    ("modenv2cut", np.float32),
    ("modlfo2vol", np.float32),
    ("inst_pan", np.float32),
    ("v_att_start", np.float32),
    ("v_hold_start", np.float32),
    ("v_dec_start", np.float32),
    ("v_att_slope", np.float32),
    ("v_dec_slope", np.float32),
    ("v_rel_slope", np.float32),
    ("v_sustain", np.float32),
    ("m_att_start", np.float32),
    ("m_hold_start", np.float32),
    ("m_dec_start", np.float32),
    ("m_att_slope", np.float32),
    ("m_dec_slope", np.float32),
    ("m_dec_end", np.float32),
    ("m_rel_dur", np.float32),
    ("m_sustain", np.float32),
    ("vib_delay", np.float32),
    ("vib_period", np.float32),
    ("mod_delay", np.float32),
    ("mod_period", np.float32),
    ("smp_start", np.float64),
    ("smp_end", np.float64),
    ("loop_start", np.float64),
    ("loop_end", np.float64),
    ("loop_mode", np.int32),
    ("root_key", np.float32),
    ("tune", np.float32),
    ("pitch_scale", np.float32),
    ("srate_ratio", np.float64),
    ("release_req", np.int32),
    # offset of this voice's loop view inside the JAX package's extended
    # wavetable (-1 when the region has no usable loop); unused by the
    # port's renderer, kept so the schedule matches the JAX one bit for bit
    ("lv_off", np.int32),
]

# Field order of the batched note-on bundles (_build_bundle /
# _write_slots_batch): the float32 / float64 planes _write_slot stores,
# minus the non-VoiceParams ones (epoch increments, release_req resets,
# lv_off / channel / loop_mode ride the i32 rows).
_BATCH_F32 = (
    "key", "note_gain", "cutoff", "resonance", "vib2pitch", "mod2pitch",
    "modenv2pitch", "modlfo2cut", "modenv2cut", "modlfo2vol", "inst_pan",
    "v_att_start", "v_hold_start", "v_dec_start", "v_att_slope",
    "v_dec_slope", "v_rel_slope", "v_sustain", "m_att_start",
    "m_hold_start", "m_dec_start", "m_att_slope", "m_dec_slope",
    "m_dec_end", "m_rel_dur", "m_sustain", "vib_delay", "vib_period",
    "mod_delay", "mod_period", "root_key", "tune", "pitch_scale",
)
_BF32 = {name: j for j, name in enumerate(_BATCH_F32)}
_BATCH_F64 = ("smp_start", "smp_end", "loop_start", "loop_end", "srate_ratio")

_CH_FIELDS = [
    ("ch_mod", np.float32),
    ("ch_vol_exp", np.float32),
    ("ch_pan", np.float32),
    ("ch_pitch", np.float32),
    ("ch_hold", np.bool_),
]


@dataclass
class SynthesizerSettings:
    """Reference: synth/settings.py (block 8–1024 default 64)."""

    sample_rate: int = 44100
    block_size: int = 64
    maximum_polyphony: int = 64
    enable_reverb_and_chorus: bool = True

    def __post_init__(self):
        if not (16000 <= self.sample_rate <= 192000):
            raise MeltysynthError("sample_rate must be in [16000, 192000]")
        if not (8 <= self.block_size <= 1024):
            raise MeltysynthError("block_size must be in [8, 1024]")
        if not (8 <= self.maximum_polyphony <= 256):
            raise MeltysynthError("maximum_polyphony must be in [8, 256]")


class Channel:
    """Per-MIDI-channel controller state (reference: synth/channel.py)."""

    def __init__(self, is_percussion: bool):
        self.is_percussion_channel = is_percussion
        self.reset()

    def reset(self):
        self.bank_number = 128 if self.is_percussion_channel else 0
        self.patch_number = 0
        self._modulation = 0
        self._volume = 100 << 7
        self._pan = 64 << 7
        self._expression = 127 << 7
        self.hold_pedal = False
        self._reverb_send = 40
        self._chorus_send = 0
        self._rpn = -1
        self._pitch_bend_range = 2 << 7
        self._coarse_tune = 0
        self._fine_tune = 8192
        self._pitch_bend = 0.0

    def reset_all_controllers(self):
        self._modulation = 0
        self._expression = 127 << 7
        self.hold_pedal = False
        self._rpn = -1
        self._pitch_bend = 0.0

    # 14-bit coarse/fine controller writes
    def set_modulation_coarse(self, v):
        self._modulation = (self._modulation & 0x7F) | (v << 7)

    def set_modulation_fine(self, v):
        self._modulation = (self._modulation & 0xFF80) | v

    def set_volume_coarse(self, v):
        self._volume = (self._volume & 0x7F) | (v << 7)

    def set_volume_fine(self, v):
        self._volume = (self._volume & 0xFF80) | v

    def set_pan_coarse(self, v):
        self._pan = (self._pan & 0x7F) | (v << 7)

    def set_pan_fine(self, v):
        self._pan = (self._pan & 0xFF80) | v

    def set_expression_coarse(self, v):
        self._expression = (self._expression & 0x7F) | (v << 7)

    def set_expression_fine(self, v):
        self._expression = (self._expression & 0xFF80) | v

    def set_hold_pedal(self, v):
        self.hold_pedal = v >= 64

    def set_reverb_send(self, v):
        self._reverb_send = v

    def set_chorus_send(self, v):
        self._chorus_send = v

    def set_rpn_coarse(self, v):
        self._rpn = (self._rpn & 0x7F) | (v << 7)

    def set_rpn_fine(self, v):
        self._rpn = (self._rpn & 0xFF80) | v

    def data_entry_coarse(self, v):
        if self._rpn == 0:
            self._pitch_bend_range = (self._pitch_bend_range & 0x7F) | (v << 7)
        elif self._rpn == 1:
            self._fine_tune = (self._fine_tune & 0x7F) | (v << 7)
        elif self._rpn == 2:
            self._coarse_tune = v - 64

    def data_entry_fine(self, v):
        if self._rpn == 0:
            self._pitch_bend_range = (self._pitch_bend_range & 0xFF80) | v
        elif self._rpn == 1:
            self._fine_tune = (self._fine_tune & 0xFF80) | v

    def set_pitch_bend(self, data1, data2):
        self._pitch_bend = (1.0 / 8192.0) * ((data1 | (data2 << 7)) - 8192)

    @property
    def modulation(self) -> float:
        return (50.0 / 16383.0) * self._modulation

    @property
    def volume(self) -> float:
        return (1.0 / 16383.0) * self._volume

    @property
    def pan(self) -> float:
        return (100.0 / 16383.0) * self._pan - 50.0

    @property
    def expression(self) -> float:
        return (1.0 / 16383.0) * self._expression

    @property
    def pitch_bend_range(self) -> float:
        return (self._pitch_bend_range >> 7) + 0.01 * (
            self._pitch_bend_range & 0x7F
        )

    @property
    def tune(self) -> float:
        return self._coarse_tune + (1.0 / 8192.0) * (self._fine_tune - 8192)

    @property
    def pitch_bend(self) -> float:
        return self.pitch_bend_range * self._pitch_bend

    @property
    def reverb_send(self) -> float:
        return (1.0 / 127.0) * self._reverb_send

    @property
    def chorus_send(self) -> float:
        return (1.0 / 127.0) * self._chorus_send

class Synthesizer:
    """SoundFont synthesizer with the reference's public API."""

    _CHANNEL_COUNT = 16
    _PERCUSSION_CHANNEL = 9

    def __init__(self, sound_font, settings: SynthesizerSettings | None = None,
                 device="cuda"):
        self._vp_cache = {}
        # the streaming engine's device (the card unless the caller asks
        # for the CPU); nothing moves there before the first block
        self._device = torch.device(device)
        if isinstance(sound_font, str):
            sound_font = SoundFont.from_file(sound_font)
        if settings is None:
            settings = SynthesizerSettings()
        self._sound_font = sound_font
        self._settings = settings
        self._sample_rate = settings.sample_rate
        self._block_size = settings.block_size
        self._maximum_polyphony = settings.maximum_polyphony
        self._minimum_voice_duration = self._sample_rate // 500
        self.master_volume = 0.5

        self._preset_lookup = {}
        min_id = None
        self._default_preset = None
        for preset in sound_font.presets:
            pid = (preset.bank_number << 16) | preset.patch_number
            self._preset_lookup[pid] = preset
            if min_id is None or pid < min_id:
                min_id = pid
                self._default_preset = preset

        # host copy; the offline renderer moves it to its device, the
        # streaming engine to each device it runs on, once (_device_wave)
        self._wave = np.asarray(sound_font.wave_data, np.float32)
        self._wave_dev = {}  # by device
        # Loop-view offsets (the ``lv_off`` schedule plane). The JAX
        # package's windowed-DMA oscillator reads them; the port keeps
        # them only so its schedule stays bit-identical to the JAX one.
        self._lv_guard = 8 * self._block_size + 2
        self._lv_map: dict[tuple[int, int], int] = {}
        self._lv_total = 0  # samples appended past the original wave
        self._channels = [
            Channel(i == self._PERCUSSION_CHANNEL)
            for i in range(self._CHANNEL_COUNT)
        ]

        P = self._maximum_polyphony
        self._par = {name: np.zeros(P, dtype=dt) for name, dt in _PAR_FIELDS}
        self._par["release_req"][:] = _NO_RELEASE
        self._par["lv_off"][:] = -1
        self._par["vib_period"][:] = 0.0
        self._par["srate_ratio"][:] = 1.0
        # host mirrors for allocation
        self._host_voice_blocks = np.zeros(P, dtype=np.int64)  # blocks since start
        self._host_active = np.zeros(P, dtype=bool)
        self._slot_exclusive_class = np.zeros(P, dtype=np.int32)
        self._pri_cache = None  # memoized _host_priorities vector
        # (channel, key) -> slots holding that note; each slot appears in
        # at most one list (_slot_ck is the back-pointer). Entries are
        # re-validated against _host_active/release_req on use, so stale
        # slots (killed, device-retired, reset) are harmless.
        self._ck_index: dict = {}
        self._slot_ck: list = [None] * P

        self._dyn = None  # device state; created lazily
        self._block_cache = np.zeros((self._block_size, 2), np.float32)
        self._block_read = self._block_size
        self._block_cache_dev = None  # the same block on the device
        self._consts = {}  # per-block constants by device (_engine_consts)

    # ---- public properties ----------------------------------------------

    @property
    def sound_font(self):
        return self._sound_font

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def maximum_polyphony(self) -> int:
        return self._maximum_polyphony

    @property
    def channel_count(self) -> int:
        return self._CHANNEL_COUNT

    @property
    def percussion_channel(self) -> int:
        return self._PERCUSSION_CHANNEL

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def active_voice_count(self) -> int:
        self._sync_active()
        return int(self._host_active.sum())

    # ---- MIDI dispatch ---------------------------------------------------

    def process_midi_message(self, channel, command, data1, data2=0):
        if not (0 <= channel < self._CHANNEL_COUNT):
            return
        ch = self._channels[channel]
        if command == 0x80:
            self.note_off(channel, data1)
        elif command == 0x90:
            self.note_on(channel, data1, data2)
        elif command == 0xB0:
            if data1 == 0x00:
                ch.bank_number = data2
            elif data1 == 0x01:
                ch.set_modulation_coarse(data2)
            elif data1 == 0x21:
                ch.set_modulation_fine(data2)
            elif data1 == 0x06:
                ch.data_entry_coarse(data2)
            elif data1 == 0x26:
                ch.data_entry_fine(data2)
            elif data1 == 0x07:
                ch.set_volume_coarse(data2)
            elif data1 == 0x27:
                ch.set_volume_fine(data2)
            elif data1 == 0x0A:
                ch.set_pan_coarse(data2)
            elif data1 == 0x2A:
                ch.set_pan_fine(data2)
            elif data1 == 0x0B:
                ch.set_expression_coarse(data2)
            elif data1 == 0x2B:
                ch.set_expression_fine(data2)
            elif data1 == 0x40:
                ch.set_hold_pedal(data2)
            elif data1 == 0x5B:
                ch.set_reverb_send(data2)
            elif data1 == 0x5D:
                ch.set_chorus_send(data2)
            elif data1 == 0x65:
                ch.set_rpn_coarse(data2)
            elif data1 == 0x64:
                ch.set_rpn_fine(data2)
            elif data1 == 0x78:
                self.note_off_all_channel(channel, True)
            elif data1 == 0x79:
                ch.reset_all_controllers()
            elif data1 == 0x7B:
                self.note_off_all_channel(channel, False)
        elif command == 0xC0:
            ch.patch_number = data1
        elif command == 0xE0:
            ch.set_pitch_bend(data1, data2)

    # ---- note handling ---------------------------------------------------

    def note_off(self, channel, key):
        # Index lookup instead of a 4-mask vector scan (the scan was the
        # top cost of build_schedule on long scores); conditions are
        # re-checked per slot so the result is identical.
        slots = self._ck_index.get((channel, key))
        if not slots:
            return
        rr = self._par["release_req"]
        touched = False
        for slot in slots:
            if self._host_active[slot] and rr[slot] == _NO_RELEASE:
                vt = int(self._host_voice_blocks[slot]) * self._block_size
                rr[slot] = max(vt, self._minimum_voice_duration)
                touched = True
        if touched:
            self._invalidate_pri()

    def note_off_batch(self, offs) -> None:
        """Vectorized run of :meth:`note_off` calls ((channel, key)
        pairs). Identical result: the per-slot release stores are
        independent and idempotent (a slot already marked keeps its
        earlier release_req), so one masked vector store matches the
        sequential loop bitwise."""
        slots = []
        for c, k in offs:
            s = self._ck_index.get((c, k))
            if s:
                slots.extend(s)
        if not slots:
            return
        sl = np.asarray(slots, np.intp)
        rr = self._par["release_req"]
        mask = self._host_active[sl] & (rr[sl] == _NO_RELEASE)
        if not mask.any():
            return
        hit = sl[mask]
        vt = self._host_voice_blocks[hit] * self._block_size
        rr[hit] = np.maximum(vt, self._minimum_voice_duration).astype(
            rr.dtype
        )
        self._invalidate_pri()

    def note_on(self, channel, key, velocity):
        if velocity == 0:
            self.note_off(channel, key)
            return
        ent = self._resolve_note(channel, key, velocity)
        if ent is None:
            return
        for params in ent[0]:
            slot = self._allocate_slot(params)
            self._write_slot(slot, params)

    def _resolve_note(self, channel, key, velocity):
        """Memoized (voice list, batch bundle) for one note-on.

        Region matching + generator resolution are pure in
        (preset, key, velocity, channel); notes repeat constantly, so
        memoize the whole matched-and-resolved voice list. channel is
        part of the key so the cached records are used verbatim (a
        dataclasses.replace per note_on dominated the schedule pass,
        and the region-range double scan was the next hotspot). The
        bundle is the same data as per-field numpy rows for
        :meth:`_write_slots_batch`.
        """
        if not (0 <= channel < self._CHANNEL_COUNT):
            return None
        ch = self._channels[channel]
        pid = (ch.bank_number << 16) | ch.patch_number
        preset = self._preset_lookup.get(pid)
        if preset is None:
            gm_pid = ch.patch_number if ch.bank_number < 128 else (128 << 16)
            preset = self._preset_lookup.get(gm_pid, self._default_preset)
        if preset is None:
            return None
        nk = (id(preset), key, velocity, channel)
        ent = self._vp_cache.get(nk)
        if ent is None:
            plist = []
            for preset_region in preset.regions:
                if preset_region.contains(key, velocity):
                    for inst_region in preset_region.instrument.regions:
                        if inst_region.contains(key, velocity):
                            pair = RegionPair(preset_region, inst_region)
                            plist.append(resolve_voice_params(
                                pair, channel, key, velocity,
                                self._sample_rate,
                            ))
            plist = tuple(plist)
            ent = (plist, self._build_bundle(plist))
            self._vp_cache[nk] = ent
        return ent

    def _build_bundle(self, plist) -> dict:
        """Per-field numpy rows for a resolved voice list (memoized with
        it): everything :meth:`_write_slot` stores, stacked so a chord
        strike writes each plane once (:meth:`_write_slots_batch`).
        ``pri0`` is each voice's t=0 priority computed with the exact
        :meth:`_host_priorities` arithmetic on the float32-stored field
        values, so the batch path's memoized-priority patch is bitwise
        identical to the sequential :meth:`_priority_of` patch."""
        n = len(plist)
        f32 = np.zeros((n, len(_BATCH_F32)), np.float32)
        f64 = np.zeros((n, len(_BATCH_F64)), np.float64)
        i32 = np.zeros((n, 3), np.int32)
        excl = np.zeros((n,), np.int32)
        cks = []
        for r, vp in enumerate(plist):
            ve, me = vp.vol_env, vp.mod_env
            f32[r] = (
                vp.key, vp.note_gain, vp.cutoff, vp.resonance,
                vp.vib_lfo_to_pitch, vp.mod_lfo_to_pitch,
                vp.mod_env_to_pitch, vp.mod_lfo_to_cutoff,
                vp.mod_env_to_cutoff, vp.mod_lfo_to_volume,
                vp.instrument_pan, ve.attack_start, ve.hold_start,
                ve.decay_start, ve.attack_slope, ve.decay_slope,
                ve.release_slope, ve.sustain, me.attack_start,
                me.hold_start, me.decay_start, me.attack_slope,
                me.decay_slope, me.decay_end, me.release_end, me.sustain,
                vp.vib_lfo_delay, vp.vib_lfo_period, vp.mod_lfo_delay,
                vp.mod_lfo_period, vp.root_key, vp.tune,
                vp.pitch_change_scale,
            )
            f64[r] = (
                vp.sample_start, vp.sample_end, vp.start_loop,
                vp.end_loop, vp.sample_rate_ratio,
            )
            i32[r] = (
                vp.channel, vp.loop_mode,
                self._loop_view_offset(int(vp.start_loop), int(vp.end_loop)),
            )
            excl[r] = vp.exclusive_class
            cks.append((vp.channel, vp.key))
        # t = 0, not released: the _host_priorities stage chain on the
        # f32-stored envelope fields (f32 -> f64 promotion is exact)
        att = f32[:, _BF32["v_att_start"]].astype(np.float64)
        hold = f32[:, _BF32["v_hold_start"]].astype(np.float64)
        dec = f32[:, _BF32["v_dec_start"]].astype(np.float64)
        t = np.float64(0.0)
        with np.errstate(over="ignore", invalid="ignore"):
            x = f32[:, _BF32["v_att_slope"]] * (t - att)
            xd = f32[:, _BF32["v_dec_slope"]] * (t - dec)
            value = np.where(
                t < att,
                0.0,
                np.where(
                    t < hold,
                    x,
                    np.where(
                        t < dec,
                        1.0,
                        np.maximum(
                            np.where(
                                xd < LOG_NON_AUDIBLE, 0.0, np.exp(xd)
                            ),
                            f32[:, _BF32["v_sustain"]],
                        ),
                    ),
                ),
            )
        bonus = np.where(
            t < att, 4.0, np.where(t < hold, 3.0, np.where(t < dec, 2.0, 1.0))
        )
        gain = f32[:, _BF32["note_gain"]]
        pri0 = np.where(gain < NON_AUDIBLE, 0.0, bonus + value)
        return {
            "n": n,
            "f32": f32,
            "f64": f64,
            "i32": i32,
            "excl": excl,
            "cks": cks,
            "pri0": pri0,
            "pri0_min": float(pri0.min()) if n else np.inf,
            "audible": bool((gain >= NON_AUDIBLE).all()),
            "has_excl": bool(excl.any()),
        }

    def note_on_batch(self, notes) -> None:
        """Process a run of same-block note-ons, bitwise-identically to
        sequential :meth:`note_on` calls but with the slot writes (and
        the steal selection) batched — a 128-voice chord strike was the
        dominant cost of :meth:`build_schedule` on chordal scores.

        The batch path engages only when its selections provably match
        the sequential ones: no exclusive classes (those retrigger
        in-burst slots), every voice audible (an inaudible write leaves
        its slot re-allocatable), and every stolen slot's priority
        strictly below the lowest priority any newly written voice gets
        (so later steals never pick an in-burst write). Sequential
        semantics: free slots fill in index order first, then steals in
        (priority asc, age desc, index asc) order — exactly the
        argmin/argmax-age chain of :meth:`_allocate_slot`. Anything
        else (velocity 0, live device state, tiny bursts) falls back to
        the sequential loop.
        """
        if self._dyn is not None or len(notes) < 8:
            for c, k, v in notes:
                self.note_on(c, k, v)
            return
        ents = []
        for c, k, v in notes:
            if v == 0:  # caller filters these; stay exact regardless
                for c2, k2, v2 in notes:
                    self.note_on(c2, k2, v2)
                return
            ents.append(self._resolve_note(c, k, v))
        bundles = [e[1] for e in ents if e is not None and e[1]["n"]]
        if not bundles:
            return
        if not all(b["audible"] for b in bundles) or any(
            b["has_excl"] for b in bundles
        ):
            for (c, k, v), ent in zip(notes, ents):
                if ent is None:
                    continue
                for params in ent[0]:
                    slot = self._allocate_slot(params)
                    self._write_slot(slot, params)
            return
        n = sum(b["n"] for b in bundles)
        self._sync_active()
        act = self._host_active
        free = np.nonzero(~act)[0]
        n_free = min(free.size, n)
        n_steal = n - n_free
        if n_steal == 0:
            slots = free[:n]
        else:
            act_idx = np.nonzero(act)[0]
            pri = self._host_priorities()
            min_new = min(b["pri0_min"] for b in bundles)
            if n_steal > act_idx.size:
                slots = None
            else:
                order = np.lexsort(
                    (-self._host_voice_blocks[act_idx], pri[act_idx])
                )
                steal = act_idx[order[:n_steal]]
                slots = (
                    np.concatenate([free, steal])
                    if float(pri[steal].max()) < min_new
                    else None
                )
            if slots is None:  # guard failed: sequential steals
                for (c, k, v), ent in zip(notes, ents):
                    if ent is None:
                        continue
                    for params in ent[0]:
                        slot = self._allocate_slot(params)
                        self._write_slot(slot, params)
                return
        self._write_slots_batch(slots, bundles)

    def _write_slots_batch(self, slots, bundles) -> None:
        """:meth:`_write_slot` over distinct ``slots`` (len = total
        bundle voices, in voice order), one vectorized store per
        plane."""
        p = self._par
        one = len(bundles) == 1
        f32 = bundles[0]["f32"] if one else np.concatenate(
            [b["f32"] for b in bundles]
        )
        f64 = bundles[0]["f64"] if one else np.concatenate(
            [b["f64"] for b in bundles]
        )
        i32 = bundles[0]["i32"] if one else np.concatenate(
            [b["i32"] for b in bundles]
        )
        excl = bundles[0]["excl"] if one else np.concatenate(
            [b["excl"] for b in bundles]
        )
        p["epoch"][slots] += 1
        for j, name in enumerate(_BATCH_F32):
            p[name][slots] = f32[:, j]
        for j, name in enumerate(_BATCH_F64):
            p[name][slots] = f64[:, j]
        p["channel"][slots] = i32[:, 0]
        p["loop_mode"][slots] = i32[:, 1]
        p["lv_off"][slots] = i32[:, 2]
        p["release_req"][slots] = _NO_RELEASE
        self._host_active[slots] = True  # batch path is all-audible
        self._host_voice_blocks[slots] = 0
        self._slot_exclusive_class[slots] = excl
        for slot, ck in zip(
            slots.tolist(), (ck for b in bundles for ck in b["cks"])
        ):
            old_ck = self._slot_ck[slot]
            if old_ck != ck:
                if old_ck is not None:
                    try:
                        self._ck_index[old_ck].remove(slot)
                    except ValueError:
                        pass
                self._slot_ck[slot] = ck
                self._ck_index.setdefault(ck, []).append(slot)
        if self._pri_cache is not None:
            self._pri_cache[slots] = (
                bundles[0]["pri0"]
                if one
                else np.concatenate([b["pri0"] for b in bundles])
            )

    def note_off_all(self, immediate: bool):
        if immediate:
            self._kill_all()
        else:
            mask = self._host_active & (self._par["release_req"] == _NO_RELEASE)
            vt = self._host_voice_blocks * self._block_size
            self._par["release_req"][mask] = np.maximum(
                vt[mask], self._minimum_voice_duration
            )
        self._invalidate_pri()

    def note_off_all_channel(self, channel, immediate: bool):
        chmask = self._host_active & (self._par["channel"] == channel)
        if immediate:
            self._par["note_gain"][chmask] = 0.0
            self._host_active[chmask] = False
        else:
            mask = chmask & (self._par["release_req"] == _NO_RELEASE)
            vt = self._host_voice_blocks * self._block_size
            self._par["release_req"][mask] = np.maximum(
                vt[mask], self._minimum_voice_duration
            )
        self._invalidate_pri()

    def reset_all_controllers(self):
        for ch in self._channels:
            ch.reset_all_controllers()

    def reset_all_controllers_channel(self, channel):
        """Reference: synth/synthesizer.py:178."""
        if 0 <= channel < len(self._channels):
            self._channels[channel].reset_all_controllers()

    def reset(self):
        self._kill_all()
        for ch in self._channels:
            ch.reset()
        self._dyn = None
        self._block_read = self._block_size

    def _kill_all(self):
        self._host_active[:] = False
        self._par["note_gain"][:] = 0.0
        self._par["release_req"][:] = _NO_RELEASE
        self._invalidate_pri()

    # ---- voice allocation (host) ----------------------------------------

    def _invalidate_pri(self) -> None:
        self._pri_cache = None

    def _priority_of(self, i: int) -> float:
        """Scalar replica of one row of :meth:`_host_priorities`.

        Used to keep the memoized priority vector exact after
        ``_write_slot`` touches a single slot (a chord strike allocates
        up to P voices in one block; recomputing the full vector per
        steal dominated ``build_schedule``). Arithmetic mirrors the
        vector path step for step in float64 (f32 fields promote to f64
        exactly; ``np.exp`` is used for the one transcendental so the
        rounding matches) — ``tests/test_soundfont_alloc.py`` fuzzes
        bitwise equality against the vector computation.
        """
        p = self._par
        if not self._host_active[i]:
            return -1.0
        if float(p["note_gain"][i]) < NON_AUDIBLE:
            return 0.0
        t = (int(self._host_voice_blocks[i]) * self._block_size) / self._sample_rate
        rr = float(p["release_req"][i])
        released = rr != _NO_RELEASE
        att = float(p["v_att_start"][i])
        hold = float(p["v_hold_start"][i])
        dec = float(p["v_dec_start"][i])
        if t < att:
            value, bonus = 0.0, 4.0
        elif t < hold:
            value, bonus = float(p["v_att_slope"][i]) * (t - att), 3.0
        elif t < dec:
            value, bonus = 1.0, 2.0
        else:
            x = float(p["v_dec_slope"][i]) * (t - dec)
            decayed = 0.0 if x < LOG_NON_AUDIBLE else float(np.exp(x))
            value, bonus = max(decayed, float(p["v_sustain"][i])), 1.0
        if released and t >= rr / self._sample_rate:
            bonus = 0.0
        return bonus + value

    def _host_priorities(self) -> np.ndarray:
        """Reference VolumeEnvelope.priority, computed in closed form.

        The result is memoized: any mutation of the inputs either
        invalidates the cache (:meth:`_invalidate_pri` — note-offs,
        block advances, device sync, kill-all) or patches the one
        affected row (:meth:`_write_slot` via :meth:`_priority_of`).
        """
        if self._pri_cache is not None:
            return self._pri_cache
        p = self._par
        t = (self._host_voice_blocks * self._block_size) / self._sample_rate
        released = p["release_req"] != _NO_RELEASE
        rel_t = np.where(
            released, p["release_req"] / self._sample_rate, np.inf
        )
        # stage at time t (pre-release)
        value = np.where(
            t < p["v_att_start"],
            0.0,
            np.where(
                t < p["v_hold_start"],
                p["v_att_slope"] * (t - p["v_att_start"]),
                np.where(
                    t < p["v_dec_start"],
                    1.0,
                    np.maximum(
                        np.where(
                            p["v_dec_slope"] * (t - p["v_dec_start"])
                            < LOG_NON_AUDIBLE,
                            0.0,
                            np.exp(p["v_dec_slope"] * (t - p["v_dec_start"])),
                        ),
                        p["v_sustain"],
                    ),
                ),
            ),
        )
        stage_bonus = np.where(
            released & (t >= rel_t),
            0.0,
            np.where(
                t < p["v_att_start"],
                4.0,
                np.where(
                    t < p["v_hold_start"],
                    3.0,
                    np.where(t < p["v_dec_start"], 2.0, 1.0),
                ),
            ),
        )
        pri = stage_bonus + value
        pri = np.where(p["note_gain"] < NON_AUDIBLE, 0.0, pri)
        pri = np.where(~self._host_active, -1.0, pri)  # free slots first
        self._pri_cache = pri
        return pri

    def _allocate_slot(self, params: VoiceParams) -> int:
        self._sync_active()
        # exclusive class: retrigger the same voice
        if params.exclusive_class != 0:
            same = (
                self._host_active
                & (self._par["channel"] == params.channel)
                & (self._par["epoch"] >= 0)
            )
            for i in np.nonzero(same)[0]:
                if self._slot_exclusive_class[i] == params.exclusive_class:
                    return int(i)
        act = self._host_active
        if not act.all():
            return int(act.argmin())  # first free slot
        pri = self._host_priorities()
        lowest = pri.min()
        cands = np.nonzero(pri == lowest)[0]
        if cands.size > 1:
            ages = self._host_voice_blocks[cands]
            return int(cands[np.argmax(ages)])
        return int(cands[0])

    def _write_slot(self, slot: int, vp: VoiceParams) -> None:
        p = self._par
        p["epoch"][slot] += 1
        p["channel"][slot] = vp.channel
        p["key"][slot] = vp.key
        p["note_gain"][slot] = vp.note_gain
        p["cutoff"][slot] = vp.cutoff
        p["resonance"][slot] = vp.resonance
        p["vib2pitch"][slot] = vp.vib_lfo_to_pitch
        p["mod2pitch"][slot] = vp.mod_lfo_to_pitch
        p["modenv2pitch"][slot] = vp.mod_env_to_pitch
        p["modlfo2cut"][slot] = vp.mod_lfo_to_cutoff
        p["modenv2cut"][slot] = vp.mod_env_to_cutoff
        p["modlfo2vol"][slot] = vp.mod_lfo_to_volume
        p["inst_pan"][slot] = vp.instrument_pan
        ve = vp.vol_env
        p["v_att_start"][slot] = ve.attack_start
        p["v_hold_start"][slot] = ve.hold_start
        p["v_dec_start"][slot] = ve.decay_start
        p["v_att_slope"][slot] = ve.attack_slope
        p["v_dec_slope"][slot] = ve.decay_slope
        p["v_rel_slope"][slot] = ve.release_slope
        p["v_sustain"][slot] = ve.sustain
        me = vp.mod_env
        p["m_att_start"][slot] = me.attack_start
        p["m_hold_start"][slot] = me.hold_start
        p["m_dec_start"][slot] = me.decay_start
        p["m_att_slope"][slot] = me.attack_slope
        p["m_dec_slope"][slot] = me.decay_slope
        p["m_dec_end"][slot] = me.decay_end
        p["m_rel_dur"][slot] = me.release_end
        p["m_sustain"][slot] = me.sustain
        p["vib_delay"][slot] = vp.vib_lfo_delay
        p["vib_period"][slot] = vp.vib_lfo_period
        p["mod_delay"][slot] = vp.mod_lfo_delay
        p["mod_period"][slot] = vp.mod_lfo_period
        p["smp_start"][slot] = vp.sample_start
        p["smp_end"][slot] = vp.sample_end
        p["loop_start"][slot] = vp.start_loop
        p["loop_end"][slot] = vp.end_loop
        p["loop_mode"][slot] = vp.loop_mode
        p["root_key"][slot] = vp.root_key
        p["tune"][slot] = vp.tune
        p["pitch_scale"][slot] = vp.pitch_change_scale
        p["srate_ratio"][slot] = vp.sample_rate_ratio
        p["release_req"][slot] = _NO_RELEASE
        p["lv_off"][slot] = self._loop_view_offset(
            int(vp.start_loop), int(vp.end_loop)
        )
        self._host_active[slot] = vp.note_gain >= NON_AUDIBLE
        self._host_voice_blocks[slot] = 0
        self._slot_exclusive_class[slot] = vp.exclusive_class
        old_ck = self._slot_ck[slot]
        ck = (vp.channel, vp.key)
        if old_ck != ck:
            if old_ck is not None:
                try:
                    self._ck_index[old_ck].remove(slot)
                except ValueError:
                    pass
            self._slot_ck[slot] = ck
            self._ck_index.setdefault(ck, []).append(slot)
        if self._pri_cache is not None:
            self._pri_cache[slot] = self._priority_of(slot)

    _slot_exclusive_class: np.ndarray

    # ---- loop-view offsets -------------------------------------------------

    def _loop_view_offset(self, loop_start: int, loop_end: int) -> int:
        """Register (or look up) the loop view for a region's loop.

        Returns the 128-aligned offset of the view inside the JAX
        package's extended wavetable, or -1 for degenerate loops.
        """
        ll = loop_end - loop_start
        L = len(self._sound_font.wave_data)
        if ll < 1 or loop_start < 0 or loop_end > L:
            return -1
        key = (loop_start, loop_end)
        off = self._lv_map.get(key)
        if off is None:
            off = -(-L // 128) * 128 + self._lv_total
            view_len = ll + self._lv_guard
            self._lv_total += -(-view_len // 128) * 128
            self._lv_map[key] = off
        return off

    # ---- device state ------------------------------------------------------

    def _sync_active(self):
        """Pull the device's liveness verdict back to the host mirror."""
        if self._dyn is not None:
            self._host_active &= self._dyn["active"].cpu().numpy()
            self._invalidate_pri()

    def _init_dyn(self, polyphony: int | None = None, device=None):
        """The voices' device state before their first block, on ``device``
        (the synthesizer's by default)."""
        P = polyphony or self._maximum_polyphony
        dev = self._device if device is None else torch.device(device)

        def full(value, dtype):
            return torch.full((P,), value, dtype=dtype, device=dev)

        f32 = torch.float32
        return {
            "epoch": full(-1, torch.int32),
            "active": full(False, torch.bool),
            "voice_time": full(0, torch.int32),
            "released": full(False, torch.bool),
            "rel_t": full(0.0, f32),
            "rel_vol": full(0.0, f32),
            "rel_mod": full(0.0, f32),
            "osc_pos": full(0.0, torch.float64),
            "fx1": full(0.0, f32),
            "fx2": full(0.0, f32),
            "fy1": full(0.0, f32),
            "fy2": full(0.0, f32),
            "sm_cutoff": full(0.0, f32),
            "prev_gl": full(0.0, f32),
            "prev_gr": full(0.0, f32),
        }

    def _device_wave(self, dev):
        """The wavetable on ``dev``, moved there once."""
        if dev not in self._wave_dev:
            self._wave_dev[dev] = to_torch(self._wave, dev)
        return self._wave_dev[dev]

    def _engine_consts(self, dev):
        """Per-block constants on ``dev``, made once: the sample steps, the
        gain ramp, and the scan's shared (N, 1) columns of ones and
        zeros."""
        if dev not in self._consts:
            N = self._block_size
            steps = torch.arange(N, dtype=torch.float32, device=dev)
            ones = torch.ones((N, 1), dtype=torch.float32, device=dev)
            zeros = torch.zeros((N, 1), dtype=torch.float32, device=dev)
            self._consts[dev] = (steps, steps / N, ones, zeros)
        return self._consts[dev]

    # ---- device kernel ---------------------------------------------------

    def _block_kernel(self, dyn, par, ch, master):
        """Render one block for all voices; returns (dyn', (N, 2) audio).

        ``dyn``: the voices' device state (:meth:`_init_dyn`); ``par``: the
        parameter planes, (P,) tensors by name; ``ch``: the channel fields,
        (16,) tensors; ``master``: the master volume (a float). Tensor ops
        only, with no host sync: the DF1 feedback is one launch of the
        order-2 scan kernel. Runs on ``dyn``'s device.
        """
        N = self._block_size
        sr = float(self._sample_rate)
        dev = dyn["epoch"].device
        wave = self._device_wave(dev)
        min_dur = self._minimum_voice_duration
        f32, f64 = torch.float32, torch.float64
        P = par["epoch"].shape[0]
        steps, ramp, ones, zeros = self._engine_consts(dev)
        where = torch.where

        fresh = par["epoch"] != dyn["epoch"]
        voice_time = where(fresh, 0, dyn["voice_time"])
        released = where(fresh, False, dyn["released"])
        rel_t = where(fresh, 0.0, dyn["rel_t"])
        rel_vol = where(fresh, 0.0, dyn["rel_vol"])
        rel_mod = where(fresh, 0.0, dyn["rel_mod"])
        osc_pos = where(fresh, par["smp_start"], dyn["osc_pos"])
        fx1 = where(fresh, 0.0, dyn["fx1"])
        fx2 = where(fresh, 0.0, dyn["fx2"])
        fy1 = where(fresh, 0.0, dyn["fy1"])
        fy2 = where(fresh, 0.0, dyn["fy2"])
        sm_cutoff = where(fresh, par["cutoff"], dyn["sm_cutoff"])
        prev_gl = where(fresh, 0.0, dyn["prev_gl"])
        prev_gr = where(fresh, 0.0, dyn["prev_gr"])
        active = where(fresh, par["note_gain"] >= NON_AUDIBLE, dyn["active"])

        chan = par["channel"].long()
        ch_hold = ch["ch_hold"][chan]

        # XLA's program divides by a constant as it multiplies by the
        # constant's reciprocal (rounded in the constant's type); so here
        inv_sr = float(np.float32(1.0) / np.float32(sr))

        # Release transition at block start (reference voice.py:217-227).
        t_now = voice_time.to(f32) * inv_sr
        want = (
            active
            & ~released
            & (par["release_req"] <= voice_time)
            & (voice_time >= min_dur)
            & ~ch_hold
        )
        rel_t = where(want, t_now, rel_t)
        rel_vol = where(want, _ctl._vol_env_held(t_now, par), rel_vol)
        rel_mod = where(want, _ctl._mod_env_held(t_now, par), rel_mod)
        released = released | want

        # Per-block control values at end-of-block time (reference
        # convention: envelopes/LFOs advance block_size then evaluate).
        t_end = (voice_time + N).to(f32) * inv_sr
        vol_env = _ctl._vol_env(t_end, par, released, rel_t, rel_vol)
        mod_env = _ctl._mod_env(t_end, par, released, rel_t, rel_mod)
        vib = _ctl._lfo(t_end, par["vib_delay"], par["vib_period"])
        mlf = _ctl._lfo(t_end, par["mod_delay"], par["mod_period"])

        dead_vol = (vol_env <= NON_AUDIBLE) & (released | (t_end >= par["v_dec_start"]))

        # Pitch (reference voice.py:134-147), its products fused into the
        # sums as XLA's CPU program fuses them: the carried float64
        # position follows the pitch's last bit
        pitch = fmaf(fmaf(_ctl._CENT, ch["ch_mod"][chan], par["vib2pitch"]), vib, par["key"])
        pitch = fmaf(par["mod2pitch"], mlf, pitch)
        pitch = fmaf(par["modenv2pitch"], mod_env, pitch) + ch["ch_pitch"][chan]
        pitch_change = fmaf(par["pitch_scale"], pitch - par["root_key"], par["tune"])
        ratio = par["srate_ratio"] * 2.0 ** (pitch_change.to(f64) * (1.0 / 12.0))

        # Oscillator: a (P, N) gather + lerp; the carried position is
        # float64, the grid an int32 base plus a float32 offset.
        loop_mode = par["loop_mode"]
        looping = (loop_mode == int(LoopMode.CONTINUOUS)) | (
            (loop_mode == int(LoopMode.LOOP_UNTIL_NOTE_OFF)) & ~released
        )
        loop_start_i = par["loop_start"].to(torch.int32)
        loop_len_i = torch.clamp_min(par["loop_end"].to(torch.int32) - loop_start_i, 1)
        loop_len_f = loop_len_i.to(f64)
        pos_wrapped = where(
            looping,
            _ctl._mod(osc_pos - par["loop_start"], loop_len_f) + par["loop_start"],
            osc_pos,
        )
        base_int = torch.floor(pos_wrapped).to(torch.int32)
        base_frac = (pos_wrapped - base_int).to(f32)
        offset = base_frac[:, None] + steps[None, :] * ratio.to(f32)[:, None]  # (P, N)
        off_int = torch.floor(offset)
        frac = offset - off_int
        abs_idx = base_int[:, None] + off_int.to(torch.int32)
        # the loop wrap in exact integer arithmetic (the position is
        # pre-wrapped into the loop, so the offset from its start is >= 0)
        wr = torch.remainder(abs_idx - loop_start_i[:, None], loop_len_i[:, None])
        idx_eff = where(looping[:, None], loop_start_i[:, None] + wr, abs_idx)
        W = wave.shape[0]
        i0 = torch.clamp(idx_eff, 0, W - 2)
        i1 = i0 + 1
        # loop upper neighbour wraps to the loop start
        i1 = where(
            looping[:, None] & (i1 >= par["loop_end"].to(torch.int32)[:, None]),
            loop_start_i[:, None],
            i1,
        )
        w0 = wave[i0.long()]
        w1 = wave[i1.long()]
        smp = (1.0 - frac) * w0 + frac * w1
        valid = looping[:, None] | (abs_idx < par["smp_end"].to(torch.int32)[:, None])
        blk = where(valid, smp, 0.0)  # (P, N)
        dead_osc = ~looping & (osc_pos >= par["smp_end"])

        new_pos = pos_wrapped + N * ratio  # float64, (P,)
        new_pos = where(
            looping & (new_pos >= par["loop_end"]),
            _ctl._mod(new_pos - par["loop_start"], loop_len_f) + par["loop_start"],
            new_pos,
        )

        # Filter (reference BiQuadFilter: per-block lowpass coefficients).
        res = par["resonance"]
        cents = par["modlfo2cut"] * mlf + par["modenv2cut"] * mod_env
        dynamic = (par["modlfo2cut"] != 0.0) | (par["modenv2cut"] != 0.0)
        new_cut = 2.0 ** (cents * float(np.float32(1.0) / np.float32(1200.0))) * par["cutoff"]
        sm_cutoff = where(
            dynamic,
            torch.minimum(torch.maximum(new_cut, 0.5 * sm_cutoff), 2.0 * sm_cutoff),
            sm_cutoff,
        )
        cutoff = where(dynamic, sm_cutoff, par["cutoff"])
        flt_on = cutoff < 0.499 * sr
        q = res - _ctl._RPO / (1.0 + 6.0 * (res - 1.0))
        w = _ctl._TWO_PI * cutoff / _ctl._F32(sr)
        cosw = torch.cos(w)
        alpha = torch.sin(w) / (2.0 * torch.clamp_min(q, 1e-6))
        a0 = 1.0 + alpha
        b0 = ((1.0 - cosw) / 2.0) / a0
        b1 = (1.0 - cosw) / a0
        b2 = b0
        a1 = (-2.0 * cosw) / a0
        a2 = (1.0 - alpha) / a0

        # DF1 over the block: the FIR half in tensor ops, the order-2
        # feedback y[n] = fir[n] - a1 y[n-1] - a2 y[n-2] by the scan
        # kernel (one launch), voices along its channels.
        xpad = torch.cat([fx2[:, None], fx1[:, None], blk], dim=1)  # (P, N + 2)
        fir = b0[:, None] * xpad[:, 2:] + b1[:, None] * xpad[:, 1:-1] + b2[:, None] * xpad[:, :-2]
        s1, _s2 = affine_scan_2_kernel(
            (-a1)[None].expand(N, P).contiguous(),
            (-a2)[None].expand(N, P).contiguous(),
            ones, zeros, fir.T.contiguous(), zeros,
            s0=(fy1, fy2), chunk=_scan_chunk(N),
        )
        filtered = s1.T  # (P, N)

        out_blk = where(flt_on[:, None], filtered, blk)
        nfx1 = blk[:, -1]
        nfx2 = blk[:, -2]
        nfy1 = where(flt_on, filtered[:, -1], blk[:, -1])
        nfy2 = where(flt_on, filtered[:, -2], blk[:, -2])

        # Mix gains (reference voice.py:160-205).
        ve = ch["ch_vol_exp"][chan]
        mix_gain = par["note_gain"] * ve * ve * vol_env
        dyn_vol = par["modlfo2vol"] > 0.05
        mix_gain = mix_gain * where(dyn_vol, 10.0 ** (0.05 * par["modlfo2vol"] * mlf), 1.0)
        angle = _ctl._PAN_SCALE * (ch["ch_pan"][chan] + par["inst_pan"] + 50.0)
        gl = where(
            angle <= 0.0,
            mix_gain,
            where(angle >= _ctl._HALF_PI, 0.0, mix_gain * torch.cos(angle)),
        )
        gr = where(
            angle <= 0.0,
            0.0,
            where(angle >= _ctl._HALF_PI, mix_gain, mix_gain * torch.sin(angle)),
        )
        first_block = voice_time == 0
        prev_gl = where(first_block, gl, prev_gl)
        prev_gr = where(first_block, gr, prev_gr)

        # Linear gain ramp within the block (reference _write_block: the
        # ramp/constant choice and the audibility skip are made on
        # master-scaled gains).
        alive = active & ~dead_vol & ~dead_osc
        m = _ctl._F32(master)
        gl_m = m * where(alive, gl, 0.0)
        gr_m = m * where(alive, gr, 0.0)
        pl_m = m * where(alive, prev_gl, 0.0)
        pr_m = m * where(alive, prev_gr, 0.0)

        def ramped(prev, cur):
            audible = torch.maximum(prev, cur) >= NON_AUDIBLE
            const = torch.abs(cur - prev) < 1.0e-3
            g = where(
                const[:, None],
                cur[:, None],
                prev[:, None] + (cur - prev)[:, None] * ramp[None, :],
            )
            return where(audible[:, None], g, 0.0)

        L = (ramped(pl_m, gl_m) * out_blk).sum(0)
        R = (ramped(pr_m, gr_m) * out_blk).sum(0)
        audio = torch.stack([L, R], dim=1)

        new_dyn = {
            "epoch": par["epoch"],
            "active": alive,
            "voice_time": voice_time + N,
            "released": released,
            "rel_t": rel_t,
            "rel_vol": rel_vol,
            "rel_mod": rel_mod,
            "osc_pos": new_pos,
            "fx1": nfx1,
            "fx2": nfx2,
            "fy1": nfy1,
            "fy2": nfy2,
            "sm_cutoff": sm_cutoff,
            "prev_gl": gl,
            "prev_gr": gr,
        }
        return new_dyn, audio

    def _device_params(self):
        """The host parameter and channel mirrors on the device: (par, ch),
        dicts of (P,) and (16,) tensors, uploaded in five packed copies
        (pinned, not blocking the host, on the card)."""
        *planes, _flags = _pack_schedule_np(self._par, self._channel_arrays())
        return _unpacked(*to_torch(tuple(planes), self._device))

    # ---- streaming render (reference API) --------------------------------

    def _render_block_device(self):
        """One block of the live voices: the (N, 2) audio on the device."""
        if self._dyn is None:
            self._dyn = self._init_dyn()
        par, ch = self._device_params()
        self._dyn, audio = self._block_kernel(self._dyn, par, ch, float(self.master_volume))
        self._host_voice_blocks[self._host_active] += 1
        self._invalidate_pri()
        return audio

    def _move_to(self, device) -> None:
        """Run the streaming engine on ``device`` from now on (the voice
        state, if any, moves with it)."""
        self._device = torch.device(device)
        self._wave_dev = {}
        self._consts = {}
        if self._dyn is not None:
            self._dyn = {k: v.to(self._device) for k, v in self._dyn.items()}
        if self._block_cache_dev is not None:
            self._block_cache_dev = self._block_cache_dev.to(self._device)

    def _render_block(self) -> np.ndarray:
        self._block_cache_dev = self._render_block_device()
        return self._block_cache_dev.cpu().numpy()

    def _render_stereo_device(self, count: int) -> torch.Tensor:
        """:meth:`render_stereo` kept on the device: the next ``count``
        samples as a (count, 2) float32 tensor on the synthesizer's device,
        sharing the block read position with :meth:`render`."""
        parts = []
        wrote = 0
        while wrote < count:
            if self._block_read == self._block_size:
                self._block_cache_dev = self._render_block_device()
                self._block_cache = None  # downloaded only if render() reads it
                self._block_read = 0
            rem = min(self._block_size - self._block_read, count - wrote)
            parts.append(self._block_cache_dev[self._block_read:self._block_read + rem])
            self._block_read += rem
            wrote += rem
        if not parts:
            return torch.zeros((0, 2), dtype=torch.float32, device=self._device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def render(self, left, right, offset: int | None = None, count: int | None = None):
        """Fill ``left``/``right`` with the next ``count`` samples."""
        if len(left) != len(right):
            raise MeltysynthError(
                "The output buffers for the left and right must be the same length."
            )
        if offset is None:
            offset = 0
        if count is None:
            count = len(left) - offset
        wrote = 0
        while wrote < count:
            if self._block_read == self._block_size:
                self._block_cache = self._render_block()
                self._block_read = 0
            elif self._block_cache is None:  # a block the device path began
                self._block_cache = self._block_cache_dev.cpu().numpy()
            rem = min(self._block_size - self._block_read, count - wrote)
            seg = self._block_cache[self._block_read : self._block_read + rem]
            left[offset + wrote : offset + wrote + rem] = seg[:, 0]
            right[offset + wrote : offset + wrote + rem] = seg[:, 1]
            self._block_read += rem
            wrote += rem

    def render_stereo(self, count: int) -> np.ndarray:
        """Convenience: render ``count`` samples → (count, 2) float32."""
        left = np.zeros(count, np.float32)
        right = np.zeros(count, np.float32)
        self.render(left, right)
        return np.stack([left, right], axis=1)

    # ---- channel snapshot ------------------------------------------------

    def _channel_arrays(self) -> dict:
        chs = self._channels
        return {
            "ch_mod": np.array([c.modulation for c in chs], np.float32),
            "ch_vol_exp": np.array(
                [c.volume * c.expression for c in chs], np.float32
            ),
            "ch_pan": np.array([c.pan for c in chs], np.float32),
            "ch_pitch": np.array(
                [c.tune + c.pitch_bend for c in chs], np.float32
            ),
            "ch_hold": np.array([c.hold_pedal for c in chs], np.bool_),
        }

    def build_schedule(self, midi_file: MidiFile, seconds: float):
        """Host pass: simulate the event timeline at block granularity,
        snapshotting the (params, channels) arrays whenever they change.

        Returns (par_stack (S,P) fields, ch_stack (S,16) fields,
        snap_idx (n_blocks,), n_blocks).
        """
        n_blocks = int(
            math.ceil(seconds * self._sample_rate / self._block_size)
        )
        gen = self.build_schedule_segments(midi_file, seconds, n_blocks)
        par_stack, ch_stack, snap_idx, nb = next(gen)
        for _ in gen:  # exhaust: applies the final voice-age advance
            pass
        return par_stack, ch_stack, snap_idx, n_blocks

    def build_schedule_segments(self, midi_file: MidiFile, seconds: float,
                                seg_blocks: int):
        """Incremental :meth:`build_schedule`: a generator yielding the
        schedule one ``seg_blocks``-block segment at a time, so a
        streaming renderer can dispatch segment k to the device while
        this host simulation produces segment k+1
        (:func:`pygmu2_tpu_torch.soundfont.offline.render_midi_offline_streamed`).

        Yields (par_stack (S_k, P) fields, ch_stack (S_k, 16) fields,
        snap_idx (nb_k,) LOCAL to the segment's stack, nb_k). Segment
        boundaries cut between blocks only; each segment's first
        snapshot is the simulator state at the segment's first block, so
        concatenated segments describe exactly the timeline the
        monolithic pass does (the host state evolution — including
        voice-allocation decisions — is bit-identical: the same batched
        event calls run in the same order). The synthesizer is mid-
        simulation between yields; don't touch it until exhaustion.
        """
        N = self._block_size
        n_blocks = int(math.ceil(seconds * self._sample_rate / N))
        self.reset()

        # Event-driven simulation: messages execute at the first block
        # whose start time is >= their timestamp (the block loop this
        # replaces processed `times[i] <= t_block` at each block); voice
        # ages advance in jumps between event blocks since the active
        # set only changes at events.
        messages, times = midi_file.messages, midi_file.times
        block_dur = N / self._sample_rate
        normal = [
            (t, m)
            for t, m in zip(times, messages)
            if m.type == MidiMessageType.NORMAL
        ]
        ev_blocks = [int(math.ceil(t / block_dur - 1e-12)) for t, _m in normal]

        prev_b = 0
        i = 0
        for s0 in range(0, n_blocks, seg_blocks):
            s1 = min(s0 + seg_blocks, n_blocks)
            # the segment's first block always snapshots (the simulator
            # state at segment start); events landing on block s0 are
            # folded in by the replace branch below
            snaps_par = [{k: v.copy() for k, v in self._par.items()}]
            snaps_ch = [self._channel_arrays()]
            snap_blocks = [s0]
            while i < len(normal) and ev_blocks[i] < s1:
                b = ev_blocks[i]
                self._host_voice_blocks[self._host_active] += b - prev_b
                self._invalidate_pri()
                prev_b = b
                while i < len(normal) and ev_blocks[i] == b:
                    m = normal[i][1]
                    if m.command == 0x90 and m.data2 > 0:
                        # batch the run of consecutive note-ons at this
                        # block (chord strikes): bitwise-identical to the
                        # sequential calls, one vectorized write per plane
                        run = [(m.channel, m.data1, m.data2)]
                        i += 1
                        while i < len(normal) and ev_blocks[i] == b:
                            m2 = normal[i][1]
                            if m2.command != 0x90 or m2.data2 <= 0:
                                break
                            run.append((m2.channel, m2.data1, m2.data2))
                            i += 1
                        self.note_on_batch(run)
                        continue
                    if m.command == 0x80 or (m.command == 0x90 and m.data2 == 0):
                        offs = [(m.channel, m.data1)]
                        i += 1
                        while i < len(normal) and ev_blocks[i] == b:
                            m2 = normal[i][1]
                            if not (
                                m2.command == 0x80
                                or (m2.command == 0x90 and m2.data2 == 0)
                            ) or not (0 <= m2.channel < self._CHANNEL_COUNT):
                                break
                            offs.append((m2.channel, m2.data1))
                            i += 1
                        self.note_off_batch(offs)
                        continue
                    self.process_midi_message(
                        m.channel, m.command, m.data1, m.data2
                    )
                    i += 1
                if snap_blocks[-1] == b:
                    snaps_par[-1] = {k: v.copy() for k, v in self._par.items()}
                    snaps_ch[-1] = self._channel_arrays()
                else:
                    snaps_par.append({k: v.copy() for k, v in self._par.items()})
                    snaps_ch.append(self._channel_arrays())
                    snap_blocks.append(b)

            snap_idx = (
                np.searchsorted(
                    np.asarray(snap_blocks), np.arange(s0, s1), "right"
                )
                - 1
            ).astype(np.int32)
            par_stack = {
                k: np.stack([s[k] for s in snaps_par]) for k in self._par
            }
            ch_stack = {
                k: np.stack([s[k] for s in snaps_ch]) for k in snaps_ch[0]
            }
            yield par_stack, ch_stack, snap_idx, s1 - s0
        self._host_voice_blocks[self._host_active] += n_blocks - prev_b
        self._invalidate_pri()

    def render_midi_schedule(self, midi_file: MidiFile, seconds: float) -> np.ndarray:
        """Render a MIDI file offline, block after block on the device.

        The host pass (:meth:`build_schedule`) runs first; its stacks go to
        the device once. The device pass is a Python loop over blocks that
        picks each block's snapshot by its host-side index, threads the
        voice state, and writes into one preallocated output: no host
        sync until the one download at the end.
        """
        par_np, ch_np, snap_idx, n_blocks = self.build_schedule(midi_file, seconds)
        N = self._block_size
        *planes, _flags = _pack_schedule_np(par_np, ch_np)
        pf32, pi32, pf64, cf32, chold = to_torch(tuple(planes), self._device)
        master = float(self.master_volume)
        out = torch.empty((n_blocks * N, 2), dtype=torch.float32, device=self._device)
        dyn = self._init_dyn()
        for b, s in enumerate(snap_idx.tolist()):  # s: the block's snapshot
            par, ch = _unpacked(pf32[:, s], pi32[:, s], pf64[:, s], cf32[:, s], chold[s])
            dyn, out[b * N:(b + 1) * N] = self._block_kernel(dyn, par, ch, master)
        total = int(round(seconds * self._sample_rate))
        result = out[:total].cpu().numpy()
        self.reset()
        return result


def _unpacked(pf32, pi32, pf64, cf32, chold):
    """Packed planes (``convert._pack_schedule_np``'s order) -> (par, ch),
    dicts of their rows by field name."""
    par = {**dict(zip(_PAR_F32, pf32)), **dict(zip(_PAR_I32, pi32)),
           **dict(zip(_PAR_F64, pf64))}
    return par, {**dict(zip(_CH_F32, cf32)), "ch_hold": chold}


def _scan_chunk(n: int) -> int:
    """The scan kernel's chunk for a block of n samples: the power of two
    that holds it, at most 1024."""
    return min(1024, 1 << max(1, (n - 1).bit_length()))
