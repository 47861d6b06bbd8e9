"""SF2 file model: RIFF parsing → presets/instruments/regions/samples.

Copy of ``pygmu2_tpu.soundfont.model`` (numpy only, so the PyTorch port
imports no JAX). Rebuild of the reference model layer (reference:
src/pygmu2/meltysynth/model/* and io/binary_reader.py). The SF2 "hydra"
(phdr/pbag/pgen … shdr) parses with numpy structured reads instead of
per-record struct loops; regions keep the standard 61-slot generator
table with SF2 default values, preset generators adding to instrument
generators at note time.

File layout knowledge comes from the SoundFont 2.x specification.
"""

from __future__ import annotations

import enum
import io
import struct
from dataclasses import dataclass

import numpy as np


class MeltysynthError(Exception):
    """Malformed SoundFont / MIDI input."""


class GeneratorType(enum.IntEnum):
    START_ADDRESS_OFFSET = 0
    END_ADDRESS_OFFSET = 1
    START_LOOP_ADDRESS_OFFSET = 2
    END_LOOP_ADDRESS_OFFSET = 3
    START_ADDRESS_COARSE_OFFSET = 4
    MODULATION_LFO_TO_PITCH = 5
    VIBRATO_LFO_TO_PITCH = 6
    MODULATION_ENVELOPE_TO_PITCH = 7
    INITIAL_FILTER_CUTOFF_FREQUENCY = 8
    INITIAL_FILTER_Q = 9
    MODULATION_LFO_TO_FILTER_CUTOFF_FREQUENCY = 10
    MODULATION_ENVELOPE_TO_FILTER_CUTOFF_FREQUENCY = 11
    END_ADDRESS_COARSE_OFFSET = 12
    MODULATION_LFO_TO_VOLUME = 13
    UNUSED_1 = 14
    CHORUS_EFFECTS_SEND = 15
    REVERB_EFFECTS_SEND = 16
    PAN = 17
    UNUSED_2 = 18
    UNUSED_3 = 19
    UNUSED_4 = 20
    DELAY_MODULATION_LFO = 21
    FREQUENCY_MODULATION_LFO = 22
    DELAY_VIBRATO_LFO = 23
    FREQUENCY_VIBRATO_LFO = 24
    DELAY_MODULATION_ENVELOPE = 25
    ATTACK_MODULATION_ENVELOPE = 26
    HOLD_MODULATION_ENVELOPE = 27
    DECAY_MODULATION_ENVELOPE = 28
    SUSTAIN_MODULATION_ENVELOPE = 29
    RELEASE_MODULATION_ENVELOPE = 30
    KEY_NUMBER_TO_MODULATION_ENVELOPE_HOLD = 31
    KEY_NUMBER_TO_MODULATION_ENVELOPE_DECAY = 32
    DELAY_VOLUME_ENVELOPE = 33
    ATTACK_VOLUME_ENVELOPE = 34
    HOLD_VOLUME_ENVELOPE = 35
    DECAY_VOLUME_ENVELOPE = 36
    SUSTAIN_VOLUME_ENVELOPE = 37
    RELEASE_VOLUME_ENVELOPE = 38
    KEY_NUMBER_TO_VOLUME_ENVELOPE_HOLD = 39
    KEY_NUMBER_TO_VOLUME_ENVELOPE_DECAY = 40
    INSTRUMENT = 41
    RESERVED_1 = 42
    KEY_RANGE = 43
    VELOCITY_RANGE = 44
    START_LOOP_ADDRESS_COARSE_OFFSET = 45
    KEY_NUMBER = 46
    VELOCITY = 47
    INITIAL_ATTENUATION = 48
    RESERVED_2 = 49
    END_LOOP_ADDRESS_COARSE_OFFSET = 50
    COARSE_TUNE = 51
    FINE_TUNE = 52
    SAMPLE_ID = 53
    SAMPLE_MODES = 54
    RESERVED_3 = 55
    SCALE_TUNING = 56
    EXCLUSIVE_CLASS = 57
    OVERRIDING_ROOT_KEY = 58
    UNUSED_5 = 59
    UNUSED_END = 60


class SampleType(enum.IntEnum):
    NONE = 0
    MONO = 1
    RIGHT = 2
    LEFT = 4
    LINKED = 8
    ROM_MONO = 0x8001
    ROM_RIGHT = 0x8002
    ROM_LEFT = 0x8004
    ROM_LINKED = 0x8008


class LoopMode(enum.IntEnum):
    NO_LOOP = 0
    CONTINUOUS = 1
    LOOP_UNTIL_NOTE_OFF = 3


@dataclass(frozen=True)
class SoundFontVersion:
    major: int
    minor: int


@dataclass(frozen=True)
class Generator:
    generator_type: int
    value: int


N_GENERATORS = 61


def _default_instrument_gs() -> np.ndarray:
    """SF2 spec defaults for an instrument zone's generator table."""
    gs = np.zeros(N_GENERATORS, dtype=np.int32)
    gs[GeneratorType.INITIAL_FILTER_CUTOFF_FREQUENCY] = 13500
    for g in (
        GeneratorType.DELAY_MODULATION_LFO,
        GeneratorType.DELAY_VIBRATO_LFO,
        GeneratorType.DELAY_MODULATION_ENVELOPE,
        GeneratorType.ATTACK_MODULATION_ENVELOPE,
        GeneratorType.HOLD_MODULATION_ENVELOPE,
        GeneratorType.DECAY_MODULATION_ENVELOPE,
        GeneratorType.RELEASE_MODULATION_ENVELOPE,
        GeneratorType.DELAY_VOLUME_ENVELOPE,
        GeneratorType.ATTACK_VOLUME_ENVELOPE,
        GeneratorType.HOLD_VOLUME_ENVELOPE,
        GeneratorType.DECAY_VOLUME_ENVELOPE,
        GeneratorType.RELEASE_VOLUME_ENVELOPE,
    ):
        gs[g] = -12000
    gs[GeneratorType.KEY_RANGE] = 0x7F00
    gs[GeneratorType.VELOCITY_RANGE] = 0x7F00
    gs[GeneratorType.KEY_NUMBER] = -1
    gs[GeneratorType.VELOCITY] = -1
    gs[GeneratorType.SCALE_TUNING] = 100
    gs[GeneratorType.OVERRIDING_ROOT_KEY] = -1
    return gs


def _default_preset_gs() -> np.ndarray:
    gs = np.zeros(N_GENERATORS, dtype=np.int32)
    gs[GeneratorType.KEY_RANGE] = 0x7F00
    gs[GeneratorType.VELOCITY_RANGE] = 0x7F00
    return gs


# ---- RIFF helpers -------------------------------------------------------


def _read_cc(f) -> str:
    raw = f.read(4)
    if len(raw) < 4:
        raise MeltysynthError("Unexpected end of file.")
    return raw.decode("ascii", errors="replace")


def _read_u32(f) -> int:
    return struct.unpack("<I", f.read(4))[0]


def _fixed_str(raw: bytes) -> str:
    return raw.split(b"\x00", 1)[0].decode("ascii", errors="replace").strip()


class SampleHeader:
    """One shdr record (46 bytes)."""

    def __init__(self, rec):
        self._name = _fixed_str(bytes(rec["name"]))
        self._start = int(rec["start"])
        self._end = int(rec["end"])
        self._start_loop = int(rec["start_loop"])
        self._end_loop = int(rec["end_loop"])
        self._sample_rate = int(rec["rate"])
        self._original_pitch = int(rec["orig_pitch"])
        self._pitch_correction = int(rec["correction"])
        self._link = int(rec["link"])
        try:
            self._sample_type = SampleType(int(rec["stype"]))
        except ValueError:
            self._sample_type = SampleType.NONE

    name = property(lambda s: s._name)
    start = property(lambda s: s._start)
    end = property(lambda s: s._end)
    start_loop = property(lambda s: s._start_loop)
    end_loop = property(lambda s: s._end_loop)
    sample_rate = property(lambda s: s._sample_rate)
    original_pitch = property(lambda s: s._original_pitch)
    pitch_correction = property(lambda s: s._pitch_correction)
    link = property(lambda s: s._link)
    sample_type = property(lambda s: s._sample_type)

    def __repr__(self) -> str:
        return f"SampleHeader(name='{self._name}')"


class _Zone:
    __slots__ = ("generators",)

    def __init__(self, generators):
        self.generators = generators


class _RegionBase:
    """Accessors shared by preset and instrument regions (over ``_gs``)."""

    _gs: np.ndarray

    def contains(self, key: int, velocity: int) -> bool:
        return (
            self.key_range_start <= key <= self.key_range_end
            and self.velocity_range_start <= velocity <= self.velocity_range_end
        )

    @property
    def key_range_start(self) -> int:
        return int(self._gs[GeneratorType.KEY_RANGE]) & 0xFF

    @property
    def key_range_end(self) -> int:
        return (int(self._gs[GeneratorType.KEY_RANGE]) >> 8) & 0xFF

    @property
    def velocity_range_start(self) -> int:
        return int(self._gs[GeneratorType.VELOCITY_RANGE]) & 0xFF

    @property
    def velocity_range_end(self) -> int:
        return (int(self._gs[GeneratorType.VELOCITY_RANGE]) >> 8) & 0xFF


class InstrumentRegion(_RegionBase):
    """Instrument zone: generator table + its sample header."""

    def __init__(self, instrument, global_zone, local_zone, samples):
        self._instrument_ref = instrument
        gs = _default_instrument_gs().copy()
        for gen in global_zone.generators:
            if 0 <= gen.generator_type < N_GENERATORS:
                gs[gen.generator_type] = gen.value
        for gen in local_zone.generators:
            if 0 <= gen.generator_type < N_GENERATORS:
                gs[gen.generator_type] = gen.value
        self._gs = gs
        sample_id = int(gs[GeneratorType.SAMPLE_ID])
        if not (0 <= sample_id < len(samples)):
            raise MeltysynthError(
                f"The instrument '{instrument.name}' contains an invalid "
                f"sample ID '{sample_id}'."
            )
        self._sample = samples[sample_id]

    @staticmethod
    def _create(instrument, zones, samples):
        # A leading zone without a terminal SAMPLE_ID generator is global.
        if (
            len(zones[0].generators) == 0
            or zones[0].generators[-1].generator_type != GeneratorType.SAMPLE_ID
        ):
            global_zone = zones[0]
            return [
                InstrumentRegion(instrument, global_zone, z, samples)
                for z in zones[1:]
            ]
        empty = _Zone([])
        return [InstrumentRegion(instrument, empty, z, samples) for z in zones]

    @property
    def sample(self) -> SampleHeader:
        return self._sample

    def _offset(self, fine: GeneratorType, coarse: GeneratorType) -> int:
        return 32768 * int(self._gs[coarse]) + int(self._gs[fine])

    @property
    def sample_start(self) -> int:
        return self._sample.start + self.start_address_offset

    @property
    def sample_end(self) -> int:
        return self._sample.end + self.end_address_offset

    @property
    def sample_start_loop(self) -> int:
        return self._sample.start_loop + self.start_loop_address_offset

    @property
    def sample_end_loop(self) -> int:
        return self._sample.end_loop + self.end_loop_address_offset

    @property
    def start_address_offset(self) -> int:
        return self._offset(
            GeneratorType.START_ADDRESS_OFFSET,
            GeneratorType.START_ADDRESS_COARSE_OFFSET,
        )

    @property
    def end_address_offset(self) -> int:
        return self._offset(
            GeneratorType.END_ADDRESS_OFFSET,
            GeneratorType.END_ADDRESS_COARSE_OFFSET,
        )

    @property
    def start_loop_address_offset(self) -> int:
        return self._offset(
            GeneratorType.START_LOOP_ADDRESS_OFFSET,
            GeneratorType.START_LOOP_ADDRESS_COARSE_OFFSET,
        )

    @property
    def end_loop_address_offset(self) -> int:
        return self._offset(
            GeneratorType.END_LOOP_ADDRESS_OFFSET,
            GeneratorType.END_LOOP_ADDRESS_COARSE_OFFSET,
        )

    @property
    def initial_attenuation(self) -> float:
        return 0.1 * int(self._gs[GeneratorType.INITIAL_ATTENUATION])

    @property
    def coarse_tune(self) -> int:
        return int(self._gs[GeneratorType.COARSE_TUNE])

    @property
    def fine_tune(self) -> int:
        return int(self._gs[GeneratorType.FINE_TUNE]) + self._sample.pitch_correction

    @property
    def sample_modes(self) -> LoopMode:
        raw = int(self._gs[GeneratorType.SAMPLE_MODES])
        return LoopMode(raw) if raw != 2 else LoopMode.NO_LOOP

    @property
    def scale_tuning(self) -> int:
        return int(self._gs[GeneratorType.SCALE_TUNING])

    @property
    def exclusive_class(self) -> int:
        return int(self._gs[GeneratorType.EXCLUSIVE_CLASS])

    @property
    def root_key(self) -> int:
        override = int(self._gs[GeneratorType.OVERRIDING_ROOT_KEY])
        return override if override != -1 else self._sample.original_pitch

    def __repr__(self) -> str:
        return f"InstrumentRegion(sample='{self._sample.name}')"


class Instrument:
    def __init__(self, name: str, regions):
        self._name = name
        self._regions = regions

    @property
    def name(self) -> str:
        return self._name

    @property
    def regions(self):
        return self._regions

    def __repr__(self) -> str:
        return f"Instrument(name='{self._name}')"


class PresetRegion(_RegionBase):
    """Preset zone: additive generator table + its instrument."""

    def __init__(self, preset, global_zone, local_zone, instruments):
        self._preset_ref = preset
        gs = _default_preset_gs().copy()
        for gen in global_zone.generators:
            if 0 <= gen.generator_type < N_GENERATORS:
                gs[gen.generator_type] = gen.value
        for gen in local_zone.generators:
            if 0 <= gen.generator_type < N_GENERATORS:
                gs[gen.generator_type] = gen.value
        self._gs = gs
        inst_id = int(gs[GeneratorType.INSTRUMENT])
        if not (0 <= inst_id < len(instruments)):
            raise MeltysynthError(
                f"The preset '{preset.name}' contains an invalid instrument "
                f"ID '{inst_id}'."
            )
        self._instrument = instruments[inst_id]

    @staticmethod
    def _create(preset, zones, instruments):
        if (
            len(zones[0].generators) == 0
            or zones[0].generators[-1].generator_type != GeneratorType.INSTRUMENT
        ):
            global_zone = zones[0]
            return [
                PresetRegion(preset, global_zone, z, instruments)
                for z in zones[1:]
            ]
        empty = _Zone([])
        return [PresetRegion(preset, empty, z, instruments) for z in zones]

    @property
    def instrument(self) -> Instrument:
        return self._instrument

    def __repr__(self) -> str:
        return f"PresetRegion(instrument='{self._instrument.name}')"


class Preset:
    def __init__(self, name: str, patch: int, bank: int, regions):
        self._name = name
        self._patch_number = patch
        self._bank_number = bank
        self._regions = regions

    @property
    def name(self) -> str:
        return self._name

    @property
    def patch_number(self) -> int:
        return self._patch_number

    @property
    def bank_number(self) -> int:
        return self._bank_number

    @property
    def regions(self):
        return self._regions

    def __repr__(self) -> str:
        return f"Preset(name='{self._name}', bank={self._bank_number}, patch={self._patch_number})"


class SoundFontInfo:
    """INFO list contents (version, names, comments…)."""

    def __init__(self):
        self.version = SoundFontVersion(2, 0)
        self.target_sound_engine = ""
        self.bank_name = ""
        self.rom_name = ""
        self.rom_version = SoundFontVersion(0, 0)
        self.creation_date = ""
        self.author = ""
        self.target_product = ""
        self.copyright = ""
        self.comments = ""
        self.tools = ""

    @classmethod
    def _parse(cls, body: bytes) -> "SoundFontInfo":
        info = cls()
        f = io.BytesIO(body)
        while f.tell() < len(body):
            sub_id = _read_cc(f)
            size = _read_u32(f)
            payload = f.read(size)
            if size % 2 == 1:
                f.read(1)
            if sub_id == "ifil" and size >= 4:
                major, minor = struct.unpack("<HH", payload[:4])
                info.version = SoundFontVersion(major, minor)
            elif sub_id == "iver" and size >= 4:
                major, minor = struct.unpack("<HH", payload[:4])
                info.rom_version = SoundFontVersion(major, minor)
            else:
                text = _fixed_str(payload)
                attr = {
                    "isng": "target_sound_engine",
                    "INAM": "bank_name",
                    "irom": "rom_name",
                    "ICRD": "creation_date",
                    "IENG": "author",
                    "IPRD": "target_product",
                    "ICOP": "copyright",
                    "ICMT": "comments",
                    "ISFT": "tools",
                }.get(sub_id)
                if attr:
                    setattr(info, attr, text)
        return info


_SHDR_DTYPE = np.dtype(
    [
        ("name", "S20"),
        ("start", "<u4"),
        ("end", "<u4"),
        ("start_loop", "<u4"),
        ("end_loop", "<u4"),
        ("rate", "<u4"),
        ("orig_pitch", "u1"),
        ("correction", "i1"),
        ("link", "<u2"),
        ("stype", "<u2"),
    ]
)

_PHDR_DTYPE = np.dtype(
    [
        ("name", "S20"),
        ("patch", "<u2"),
        ("bank", "<u2"),
        ("bag", "<u2"),
        ("library", "<u4"),
        ("genre", "<u4"),
        ("morphology", "<u4"),
    ]
)

_INST_DTYPE = np.dtype([("name", "S20"), ("bag", "<u2")])
_BAG_DTYPE = np.dtype([("gen", "<u2"), ("mod", "<u2")])
_GEN_DTYPE = np.dtype([("oper", "<u2"), ("amount", "<i2")])


def _zones_from(bags: np.ndarray, gens: np.ndarray, lo: int, hi: int):
    """Build the zone list for records [lo, hi) of a bag table."""
    zones = []
    for b in range(lo, hi):
        g0 = int(bags["gen"][b])
        g1 = int(bags["gen"][b + 1])
        zones.append(
            _Zone(
                [
                    Generator(int(gens["oper"][g]), int(gens["amount"][g]))
                    for g in range(g0, g1)
                ]
            )
        )
    return zones


class SoundFont:
    """Parsed SF2: presets, instruments, sample headers, wave data."""

    def __init__(self, source):
        if isinstance(source, (str, bytes)) and not isinstance(source, bytes):
            with open(source, "rb") as f:
                data = f.read()
        elif isinstance(source, bytes):
            data = source
        else:
            data = source.read()
        self._parse(data)

    @classmethod
    def from_file(cls, path) -> "SoundFont":
        return cls(str(path))

    def _parse(self, data: bytes) -> None:
        f = io.BytesIO(data)
        if _read_cc(f) != "RIFF":
            raise MeltysynthError("The RIFF chunk was not found.")
        _read_u32(f)
        if _read_cc(f) != "sfbk":
            raise MeltysynthError("The type of the RIFF chunk must be 'sfbk'.")

        chunks: dict[str, bytes] = {}
        info_body = None
        pdta_body = None
        smpl = None
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            size = _read_u32(f)
            body = f.read(size)
            if size % 2 == 1:
                f.read(1)
            if head != b"LIST":
                continue
            list_type = body[:4].decode("ascii", errors="replace")
            payload = body[4:]
            if list_type == "INFO":
                info_body = payload
            elif list_type == "sdta":
                g = io.BytesIO(payload)
                while g.tell() < len(payload):
                    sub = _read_cc(g)
                    sub_size = _read_u32(g)
                    sub_body = g.read(sub_size)
                    if sub_size % 2 == 1:
                        g.read(1)
                    if sub == "smpl":
                        smpl = sub_body
            elif list_type == "pdta":
                pdta_body = payload

        if smpl is None:
            raise MeltysynthError("No valid sample data was found.")
        if pdta_body is None:
            raise MeltysynthError("The pdta LIST chunk was not found.")

        self._info = (
            SoundFontInfo._parse(info_body) if info_body else SoundFontInfo()
        )
        self._bits_per_sample = 16
        # int16 → float, /32768 (reference convention), float64 like the
        # reference's wave_data (the engine re-casts for the device).
        self._wave_data = (
            np.frombuffer(smpl, dtype="<i2").astype(np.float64) / 32768.0
        )

        g = io.BytesIO(pdta_body)
        while g.tell() < len(pdta_body):
            sub = _read_cc(g)
            sub_size = _read_u32(g)
            sub_body = g.read(sub_size)
            if sub_size % 2 == 1:
                g.read(1)
            chunks[sub] = sub_body

        for required in ("phdr", "pbag", "pgen", "inst", "ibag", "igen", "shdr"):
            if required not in chunks:
                raise MeltysynthError(f"The '{required}' sub-chunk was not found.")

        shdr = np.frombuffer(chunks["shdr"], dtype=_SHDR_DTYPE)
        self._sample_headers = [SampleHeader(rec) for rec in shdr[:-1]]

        ibag = np.frombuffer(chunks["ibag"], dtype=_BAG_DTYPE)
        igen = np.frombuffer(chunks["igen"], dtype=_GEN_DTYPE)
        inst = np.frombuffer(chunks["inst"], dtype=_INST_DTYPE)
        self._instruments = []
        for i in range(len(inst) - 1):
            zones = _zones_from(
                ibag, igen, int(inst["bag"][i]), int(inst["bag"][i + 1])
            )
            if not zones:
                raise MeltysynthError(
                    f"The instrument '{_fixed_str(bytes(inst['name'][i]))}' has no zone."
                )
            instrument = Instrument(_fixed_str(bytes(inst["name"][i])), [])
            instrument._regions = InstrumentRegion._create(
                instrument, zones, self._sample_headers
            )
            self._instruments.append(instrument)

        pbag = np.frombuffer(chunks["pbag"], dtype=_BAG_DTYPE)
        pgen = np.frombuffer(chunks["pgen"], dtype=_GEN_DTYPE)
        phdr = np.frombuffer(chunks["phdr"], dtype=_PHDR_DTYPE)
        self._presets = []
        for i in range(len(phdr) - 1):
            zones = _zones_from(
                pbag, pgen, int(phdr["bag"][i]), int(phdr["bag"][i + 1])
            )
            if not zones:
                raise MeltysynthError(
                    f"The preset '{_fixed_str(bytes(phdr['name'][i]))}' has no zone."
                )
            preset = Preset(
                _fixed_str(bytes(phdr["name"][i])),
                int(phdr["patch"][i]),
                int(phdr["bank"][i]),
                [],
            )
            preset._regions = PresetRegion._create(
                preset, zones, self._instruments
            )
            self._presets.append(preset)

    @property
    def info(self) -> SoundFontInfo:
        return self._info

    @property
    def bits_per_sample(self) -> int:
        return self._bits_per_sample

    @property
    def wave_data(self) -> np.ndarray:
        return self._wave_data

    @property
    def sample_headers(self):
        return self._sample_headers

    @property
    def presets(self):
        return self._presets

    @property
    def instruments(self):
        return self._instruments

    def __repr__(self) -> str:
        return (
            f"SoundFont(presets={len(self._presets)}, "
            f"instruments={len(self._instruments)}, "
            f"samples={len(self._sample_headers)})"
        )
