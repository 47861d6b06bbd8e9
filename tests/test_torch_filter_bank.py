"""PyTorch port, the filters on wide batches: BiquadPE and SVFilterPE at 8
channels and the 128-channel filter bank (``filter_workload``) against the
JAX package, which takes its TPU route there (``affine_scan_2_pallas`` in
interpret mode under ``FORCE_KERNEL_INTERPRET``); the port takes the same
route, the chunked scan's plain version on the CPU.

Tolerances: 1e-5 for a PE against its JAX PE and for block invariance,
1e-4 (the repo's render bound) for the bank and a JAX checkpoint resumed
in the port.
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu.ops import diffable, linrec_pallas
from pygmu2_tpu_torch import filter_workload
from pygmu2_tpu_torch.core import engine as tengine
from pygmu2_tpu_torch.patch_workload import detuned_saws

torch.set_num_threads(1)

T = 8192
BIQUAD_MODES = ("LOWPASS", "HIGHPASS", "BANDPASS", "NOTCH", "ALLPASS", "PEAKING", "LOWSHELF",
                "HIGHSHELF")
SVF_MODES = ("LOWPASS", "HIGHPASS", "BANDPASS", "NOTCH", "PEAKING", "LOWSHELF", "HIGHSHELF")


@pytest.fixture(autouse=True)
def _kernel_route(monkeypatch):
    """The JAX package on its TPU route; the port at 44.1 kHz."""
    monkeypatch.setattr(diffable, "FORCE_KERNEL_INTERPRET", True)
    tpg.set_sample_rate(44100)


# the filters' frequency: 1200 +- 900 Hz at 3 Hz, the same array in both
# packages
SWEEP = (1200.0 + 900.0 * np.sin(2 * np.pi * 3.0 * np.arange(T) / 44100)).astype(np.float32)


def _filter(pg, kind, mode, source):
    """An 8-channel filter on a swept frequency (Q 3, +4 dB where the mode
    takes a gain)."""
    freq = pg.ArrayPE(SWEEP.copy())
    cls = pg.BiquadPE if kind == "biquad" else pg.SVFilterPE
    return pg.CropPE(cls(pg.ArrayPE(source), freq, 3.0, mode=getattr(pg.BiquadMode, mode),
                         gain_db=4.0), 0, T)


@pytest.mark.parametrize("kind,mode", [("biquad", m) for m in BIQUAD_MODES]
                         + [("svf", m) for m in SVF_MODES])
def test_filter_pe_matches_jax(kind, mode):
    source = detuned_saws(T, seed=1, channels=8)
    jpg.set_sample_rate(44100)
    want = np.asarray(jengine.render_scan(_filter(jpg, kind, mode, source), 0, T, T))
    got = tpg.render_to_array(_filter(tpg, kind, mode, source), block=T, device="cpu")
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,mode", [("biquad", "BANDPASS"), ("svf", "LOWPASS")])
def test_filter_pe_block_invariance(kind, mode):
    source = detuned_saws(T, seed=2, channels=8)
    whole = tpg.render_to_array(_filter(tpg, kind, mode, source), block=T, device="cpu")
    halves = tpg.render_to_array(_filter(tpg, kind, mode, source), block=T // 2, device="cpu")
    np.testing.assert_allclose(halves, whole, rtol=0, atol=1e-5)


BANK_SECONDS = 0.4
BANK_BLOCK = 8192


@pytest.fixture(scope="module")
def jax_bank():
    """The JAX render of the bank in two calls with the checkpoint taken
    between them, and the number of JAX scans that took the Pallas kernel
    while the program was traced: (render, snapshot, kernel calls)."""
    calls = []
    orig = linrec_pallas.affine_scan_2_pallas

    def spy(*a, **k):
        calls.append(tuple(a[4].shape))
        return orig(*a, **k)

    total = int(round(BANK_SECONDS * filter_workload.SR))
    saved = diffable.FORCE_KERNEL_INTERPRET
    diffable.FORCE_KERNEL_INTERPRET = True
    linrec_pallas.affine_scan_2_pallas = spy
    try:
        graph = filter_workload.build_filter_bank(jpg, BANK_SECONDS)
        first = np.asarray(jengine.render_scan(graph, 0, BANK_BLOCK, BANK_BLOCK))
        snap = jengine.checkpoint_state(graph)
        rest = np.asarray(jengine.render_scan(graph, BANK_BLOCK, total - BANK_BLOCK,
                                              BANK_BLOCK))
    finally:
        linrec_pallas.affine_scan_2_pallas = orig
        diffable.FORCE_KERNEL_INTERPRET = saved
    return np.concatenate([first, rest]), snap, calls


def test_jax_bank_takes_pallas_kernel(jax_bank):
    _want, _snap, calls = jax_bank
    # both filters, traced once per program at the bank's block shape
    assert calls and all(shape == (BANK_BLOCK, 128) for shape in calls)
    assert len(calls) % 2 == 0


def test_filter_bank_matches_jax(jax_bank):
    want, _snap, _calls = jax_bank
    got = tpg.render_to_array(filter_workload.build_filter_bank(tpg, BANK_SECONDS),
                              block=BANK_BLOCK, device="cpu")
    assert got.shape == want.shape == (want.shape[0], 128)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_jax_checkpoint_resumes_in_port(jax_bank):
    want, snap, _calls = jax_bank
    graph = filter_workload.build_filter_bank(tpg, BANK_SECONDS)
    tpg.restore_state(graph, snap)
    rest = tengine.render_scan(graph, BANK_BLOCK, want.shape[0] - BANK_BLOCK, BANK_BLOCK,
                               device="cpu")
    np.testing.assert_allclose(rest.numpy(), want[BANK_BLOCK:], rtol=0, atol=1e-4)
