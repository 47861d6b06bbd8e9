"""PyTorch port: temperaments and unit conversions against the JAX
package's, on the CPU.

Both are numpy on the host in both packages (the port keeps a copy), so
every value must be equal bit for bit. Each package keeps its own global
temperament and reference frequency: setting one leaves the other as it
was.
"""

import numpy as np
import pytest

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.utils import temperament as jtemp
from pygmu2_tpu_torch.utils import temperament as ttemp

PITCHES = np.concatenate([np.arange(0, 128, dtype=np.float64), [60.25, 61.5, 69.0, 70.77, -3.2]])
RATIOS = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 5.0 / 4.0, 0.123, 7.7])


def _quarter_tone(pg):
    """A 24-division temperament from user callables."""
    et = pg.EqualTemperament(24)
    return pg.CustomTemperament(et.pitch_to_freq, et.freq_to_pitch, et.interval_to_ratio,
                                et.ratio_to_interval, name="quarter tones")


def _temperaments(pg):
    return {
        "equal12": pg.EqualTemperament(12),
        "equal19": pg.EqualTemperament(19),
        "just": pg.JustIntonation(),
        "just_a": pg.JustIntonation([1.0, 9 / 8, 5 / 4, 4 / 3, 3 / 2, 5 / 3, 15 / 8],
                                    reference_pitch=57.0),
        "pythagorean": pg.PythagoreanTuning(),
        "custom": _quarter_tone(pg),
    }


@pytest.fixture(autouse=True)
def _reset_globals():
    for pg in (jpg, tpg):
        pg.set_temperament(pg.EqualTemperament(12))
        pg.set_concert_pitch()
    yield
    for pg in (jpg, tpg):
        pg.set_temperament(pg.EqualTemperament(12))
        pg.set_concert_pitch()


@pytest.mark.parametrize("name", ["equal12", "equal19", "just", "just_a", "pythagorean",
                                  "custom"])
def test_temperament_bit_for_bit(name):
    j, t = _temperaments(jpg)[name], _temperaments(tpg)[name]
    assert j.name() == t.name() and repr(j) == repr(t)
    for ref in ((69.0, 440.0), (60.0, 261.0), (57.0, 415.0)):
        f_j = j.pitch_to_freq(PITCHES, *ref)
        np.testing.assert_array_equal(t.pitch_to_freq(PITCHES, *ref), f_j)
        np.testing.assert_array_equal(t.freq_to_pitch(f_j, *ref), j.freq_to_pitch(f_j, *ref))
    np.testing.assert_array_equal(t.interval_to_ratio(PITCHES - 60), j.interval_to_ratio(PITCHES - 60))
    np.testing.assert_array_equal(t.ratio_to_interval(RATIOS), j.ratio_to_interval(RATIOS))


@pytest.mark.parametrize("temperament", [None, "just", "pythagorean"])
def test_conversions_bit_for_bit(temperament):
    kw = {} if temperament is None else {"temperament": _temperaments(jpg)[temperament]}
    tkw = {} if temperament is None else {"temperament": _temperaments(tpg)[temperament]}
    freqs = jpg.pitch_to_freq(PITCHES, **kw)
    np.testing.assert_array_equal(tpg.pitch_to_freq(PITCHES, **tkw), freqs)
    np.testing.assert_array_equal(tpg.freq_to_pitch(freqs, **tkw), jpg.freq_to_pitch(freqs, **kw))
    np.testing.assert_array_equal(tpg.pitch_to_freq(PITCHES, reference_pitch=60.0,
                                                    reference_freq=256.0, **tkw),
                                  jpg.pitch_to_freq(PITCHES, reference_pitch=60.0,
                                                    reference_freq=256.0, **kw))
    semis = np.linspace(-24, 24, 97)
    np.testing.assert_array_equal(tpg.semitones_to_ratio(semis, **tkw),
                                  jpg.semitones_to_ratio(semis, **kw))
    np.testing.assert_array_equal(tpg.ratio_to_semitones(RATIOS, **tkw),
                                  jpg.ratio_to_semitones(RATIOS, **kw))


def test_unit_conversions_bit_for_bit():
    db = np.linspace(-120, 24, 145)
    np.testing.assert_array_equal(tpg.db_to_ratio(db), jpg.db_to_ratio(db))
    np.testing.assert_array_equal(tpg.ratio_to_db(RATIOS), jpg.ratio_to_db(RATIOS))
    n = np.array([0, 1, 441, 44100, 2646000])
    for sr in (44100, 48000, 22050.0):
        np.testing.assert_array_equal(tpg.samples_to_seconds(n, sr), jpg.samples_to_seconds(n, sr))
        secs = np.array([0.0, 0.001, 0.5, 60.0, 1.2345])
        np.testing.assert_array_equal(tpg.seconds_to_samples(secs, sr),
                                      jpg.seconds_to_samples(secs, sr))


def test_global_state_is_separate_per_package():
    assert ttemp is not jtemp
    tpg.set_temperament(tpg.JustIntonation())
    tpg.set_verdi_tuning()
    assert isinstance(tpg.get_temperament(), tpg.JustIntonation)
    assert isinstance(jpg.get_temperament(), jpg.EqualTemperament)
    assert tpg.get_reference_frequency() == (432.0, 69.0)
    assert jpg.get_reference_frequency() == (440.0, 69.0)
    np.testing.assert_array_equal(jpg.pitch_to_freq(69.0), 440.0)
    jpg.set_baroque_pitch()
    assert tpg.get_reference_frequency() == (432.0, 69.0)
    assert jpg.get_reference_frequency() == (415.0, 69.0)
    # the port's pitch_to_freq follows the port's globals, bit for bit with
    # the JAX package set the same way
    jpg.set_temperament(jpg.JustIntonation())
    jpg.set_verdi_tuning()
    np.testing.assert_array_equal(tpg.pitch_to_freq(PITCHES), jpg.pitch_to_freq(PITCHES))
    tpg.set_reference_frequency(442.0, 57.0)
    assert tpg.get_reference_frequency() == (442.0, 57.0)
    with pytest.raises(ValueError):
        tpg.set_reference_frequency(0.0)
    tpg.set_concert_pitch()
    assert tpg.get_reference_frequency() == (440.0, 69.0)
