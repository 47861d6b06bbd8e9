"""The effects-chain workloads of the PE-graph render.

Both builders take a package namespace ``pg`` — ``pygmu2_tpu_torch`` or
the JAX package ``pygmu2_tpu`` — so the same graph can be built from
either and the two renders compared. Both set the sample rate to 44.1 kHz;
``render_to_array`` renders them in its default blocks of 16384 samples.

- :func:`build_chain`: the mono path a sound designer takes (the repo's
  examples 06, 10 and 15 in one graph) — six plucked open strings, gated,
  through an auto-wah (an envelope follower, slew-limited, sets a
  band-pass centre), a compressor, and a reverse pitch echo mixed back
  in. Per block it runs the string kernel six times, the envelope
  follower twice (the wah and the compressor's RMS detector), the slew
  limiter and the echo once, all at C = 1.
- :func:`build_fx_bank`: 128 channels of detuned saws (numpy, ``seed``),
  gated, through an unlinked compressor and the same echo mix, so the
  envelope and echo kernels run at the 128-lane width of their TPU
  originals.
"""

from __future__ import annotations

from pygmu2_tpu_torch.patch_workload import SR, detuned_saws

STRINGS = (82.41, 110.0, 146.83, 196.0, 246.94, 329.63)  # guitar open strings, Hz
ECHO_BLOCK_S = 0.3  # the reverse echo's block: it replays from the second on


def _echo_mix(pg, dry, feedback=0.6):
    """``dry`` compressed, with a reverse pitch echo (ECHO_BLOCK_S blocks, a fifth
    up, feedback 0.6 or the PE ``feedback``, 0.5 s of buffer) mixed in at
    0.7."""
    comp = pg.CachePE(dry)
    echo = pg.ReversePitchEchoPE(comp, ECHO_BLOCK_S, 1.5, feedback, max_delay_seconds=0.5)
    return pg.MixPE(comp, pg.GainPE(echo, 0.7))


def build_chain(pg, seconds: float, depth=2500.0, feedback=0.6, detection=None):
    """The mono effects chain, cropped to ``seconds`` at 44.1 kHz. ``depth``
    (Hz per unit of envelope) and ``feedback`` may be PEs (the training
    path binds them to ParamPEs); ``detection``, the compressor's detector
    (the default: RMS)."""
    pg.set_sample_rate(SR)
    strings = pg.MixPE(*(pg.KarplusStrongPE(f, rho=0.9995, seed=i) for i, f in enumerate(STRINGS)))
    src = pg.CachePE(pg.GainPE(strings, pg.PeriodicGate(2.0, 0.45)))
    env = pg.EnvelopePE(src, attack=0.005, release=0.08)
    centre = pg.SlewLimiterPE(
        pg.MixPE(pg.ConstantPE(300.0), pg.GainPE(env, depth)), 40000.0, 8000.0
    )
    wah = pg.BiquadPE(src, centre, 6.0, mode=pg.BiquadMode.BANDPASS)
    out = _echo_mix(pg, _compressor(pg, wah, detection), feedback)
    return pg.CropPE(out, 0, int(round(seconds * SR)))


def _compressor(pg, src, detection, **kw):
    extra = {} if detection is None else {"detection": detection}
    return pg.CompressorPE(src, threshold=-18.0, ratio=6.0, **kw, **extra)


def build_fx_bank(pg, seconds: float, seed: int = 0, drive=None, feedback=0.6,
                  channels: int = 128, detection=None):
    """The effects bank (128 channels), cropped to ``seconds`` at 44.1 kHz.
    ``drive`` (a gain before the compressor, none by default) and
    ``feedback`` may be PEs (the training path binds them to ParamPEs);
    ``detection``, the compressor's detector (the default: RMS)."""
    pg.set_sample_rate(SR)
    n = int(round(seconds * SR))
    saws = pg.GainPE(pg.ArrayPE(detuned_saws(n, seed, channels=channels)),
                     pg.PeriodicGate(3.0, 0.3))
    if drive is not None:
        saws = pg.GainPE(saws, drive)
    comp = _compressor(pg, saws, detection, stereo_link=False)
    return pg.CropPE(_echo_mix(pg, comp, feedback), 0, n)
