"""The filter-bank workload of the PE-graph render.

:func:`build_filter_bank` takes a package namespace ``pg`` —
``pygmu2_tpu_torch`` or the JAX package ``pygmu2_tpu`` — so the same graph
can be built from either and the two renders compared. It sets the sample
rate to 44.1 kHz; ``render_to_array`` renders it in its default blocks of
16384 samples.

A 128-voice filtered pad, or a 128-band filter bank: the bank's 128
detuned saws (numpy, ``seed``) through a swept resonant low-pass
``BiquadPE`` (1500 ± 1200 Hz at 0.25 Hz, Q 4) and a swept band-pass
``SVFilterPE`` (800 ± 500 Hz at 0.4 Hz, Q 2), at half gain. Each filter
runs the order-2 affine scan over (T, 128) once per block: the chunked
kernel of TPU kernel ``affine_scan_2_pallas``, twice per block.
"""

from __future__ import annotations

from pygmu2_tpu_torch.patch_workload import SR, _swept, detuned_saws


def build_filter_bank(pg, seconds: float, seed: int = 0):
    """The 128-channel filter bank, cropped to ``seconds`` at 44.1 kHz."""
    pg.set_sample_rate(SR)
    n = int(round(seconds * SR))
    saws = pg.ArrayPE(detuned_saws(n, seed))
    low = pg.BiquadPE(saws, _swept(pg, 1500.0, 0.25, 1200.0), 4.0, mode=pg.BiquadMode.LOWPASS)
    band = pg.SVFilterPE(low, _swept(pg, 800.0, 0.4, 500.0), 2.0, mode=pg.BiquadMode.BANDPASS)
    return pg.CropPE(pg.GainPE(band, 0.5), 0, n)
