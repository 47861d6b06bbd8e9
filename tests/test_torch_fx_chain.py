"""PyTorch port, the effects chain end to end: ``fx_workload``'s chain and
bank against the JAX render, and a JAX checkpoint resumed in the port.

The port renders with ``device="cpu"`` (the kernels' plain versions); the
JAX package renders on the CPU backend. Tolerance: 1e-4, the repo's
render bound, for the renders and the checkpoint crossing.

Both renders run past the echo's first 0.3 s block and are compared whole.
The chain's auto-wah is a resonant band-pass (Q = 6 on a moving centre)
that amplifies any rounding difference, so the port's BiquadPE computes
what XLA's CPU program computes, rounding for rounding: its coefficients
(``ops/xla_math``, tests/test_torch_linrec_kernel.py) and its segmented
scan and FIR line, where XLA's backend fuses a product whose one use is a
sum into a multiply-add. ``a·b + c·d`` becomes ``fma(a, b, c·d)`` in the
Kogge-Stone passes, the stitch and the apply, except in the first pass's
row of the negated coefficients ``-a1``, ``-a2``: LLVM rewrites
``(-a1)·p + (-a2)·q`` as ``(-a2)·q - a1·p`` and fuses ``(-a2)·q``. The FIR
line is ``fma(b2, x2, fma(b0, x0, b1·x1))``. Fed the JAX render's strings
and centre, the two packages' band-passes are then equal bit for bit; the
chain stays within 1e-4 of the JAX render over the whole 0.4 s, the rest
coming from the strings and centre upstream (float32 roundings in other
ops), raised by the band-pass and the compressor's makeup gain.
``python tests/test_torch_fx_chain.py`` prints these numbers.
"""

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu_torch import fx_workload, patch_workload
from pygmu2_tpu_torch.core import engine as tengine

torch.set_num_threads(1)

BLOCK = 1024
# Both renders run past the echo's first 0.3 s block, so its replayed and
# fed-back block is compared; the checkpoint is taken after that block's
# swap, so it carries a full block buffer across the packages.
HALF = 14 * BLOCK
# the chain's 0.4 s ends in a part block; the bank's 18 blocks are whole
# (its RMS detector pads a part block's edge, so a render's last block
# length must be the same in both packages' renders)
SECONDS = {"chain": 0.4, "bank": 18 * BLOCK / fx_workload.SR}
# the stretches held to the JAX render, in seconds (see above)
WINDOWS = {"chain": [(0.0, SECONDS["chain"])], "bank": [(0.0, SECONDS["bank"])]}


@pytest.fixture(autouse=True)
def _port_sample_rate():
    tpg.set_sample_rate(44100)


def _build(pg, which):
    if which == "chain":
        return fx_workload.build_chain(pg, SECONDS[which])
    return fx_workload.build_fx_bank(pg, SECONDS[which], seed=0)


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _layout(tree):
    if isinstance(tree, (dict, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: _layout(v) for k, v in items}
    return np.asarray(tree).shape, np.asarray(tree).dtype


def _jax_render(which):
    """The JAX render of one workload in two calls, with the checkpoint
    taken between them (the blocks of ``render_to_array``): (which, full
    render, snapshot at HALF)."""
    total = int(round(SECONDS[which] * fx_workload.SR))
    graph = _build(jpg, which)
    first = np.asarray(jengine.render_scan(graph, 0, HALF, BLOCK))
    snap = jengine.checkpoint_state(graph)
    rest = np.asarray(jengine.render_scan(graph, HALF, total - HALF, BLOCK))
    return which, np.concatenate([first, rest]), snap


@pytest.fixture(scope="module", params=["chain", "bank"])
def workload(request):
    return _jax_render(request.param)


def test_workload_matches_jax(workload):
    which, want, snap = workload
    graph = _build(tpg, which)
    got = np.asarray(tpg.render_to_array(graph, block=BLOCK, device="cpu"))
    channels = 1 if which == "chain" else patch_workload.BANK_CHANNELS
    assert got.shape == want.shape == (want.shape[0], channels)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.05
    for a, b in WINDOWS[which]:
        span = slice(int(round(a * fx_workload.SR)), int(round(b * fx_workload.SR)))
        _close(got[span], want[span], 1e-4)
    # the port's snapshot has the JAX package's layout, leaf for leaf
    assert _layout(tpg.checkpoint_state(graph)) == _layout(snap)


def test_jax_checkpoint_resumes_in_port(workload):
    which, want, snap = workload
    graph = _build(tpg, which)
    tpg.restore_state(graph, snap)
    rest = tengine.render_scan(graph, HALF, want.shape[0] - HALF, BLOCK, device="cpu")
    _close(rest.numpy(), want[HALF:], 1e-4)


def test_chain_echo_fires_within_a_second():
    """The chain's echo (0.3 s blocks) replays the first block after 0.3 s,
    inside the stretch of the chain compared above (port only)."""
    graph = fx_workload.build_chain(tpg, 0.4)
    echo = next(pe for pe in _walk(graph) if isinstance(pe, tpg.ReversePitchEchoPE))
    wet = np.asarray(tpg.render_to_array(tpg.CropPE(echo, 0, 17640), block=4096,
                                         device="cpu"))
    first_block = int(0.3 * fx_workload.SR)
    assert not wet[:first_block].any() and np.abs(wet[first_block:]).max() > 1e-3


def _walk(pe):
    yield pe
    for child in pe.inputs():
        yield from _walk(child)


if __name__ == "__main__":
    # ``python tests/test_torch_fx_chain.py`` prints the observed maxima:
    # the checks record their errors instead of asserting
    import jax

    jax.config.update("jax_platforms", "cpu")
    jpg.set_sample_rate(44100)
    errors = []

    def _close(got, want, atol):  # noqa: F811
        errors.append(float(np.abs(got - want).max()))

    def bandpass_errors():
        """The wah's band-pass alone: the JAX render's strings and centre
        through both packages' BiquadPE, each against a float64 recursion
        of the RBJ constant-peak band-pass at the float32 ``2*pi*f/sr``."""
        graph = _build(jpg, "chain")
        bq = next(pe for pe in _walk(graph) if type(pe).__name__ == "BiquadPE")
        total = int(round(SECONDS["chain"] * fx_workload.SR))
        src, centre = (np.asarray(jengine.render_scan(jpg.CropPE(pe, 0, total), 0, total,
                                                      BLOCK))
                       for pe in bq.inputs()[:2])
        out = {}
        for name, pg in (("JAX", jpg), ("port", tpg)):
            pe = pg.CropPE(pg.BiquadPE(pg.ArrayPE(src), pg.ArrayPE(centre.copy()), 6.0,
                                       mode=pg.BiquadMode.BANDPASS), 0, total)
            out[name] = (np.asarray(jengine.render_scan(pe, 0, total, BLOCK)) if pg is jpg
                         else tpg.render_to_array(pe, block=BLOCK, device="cpu"))[:, 0]
        w0 = (np.float32(2 * np.pi) * centre[:, 0] / np.float32(fx_workload.SR)).astype(
            np.float64)
        alpha = np.sin(w0) / 12.0
        b0, a1, a2 = alpha / (1 + alpha), -2 * np.cos(w0) / (1 + alpha), (1 - alpha) / (
            1 + alpha)
        x = np.concatenate([[0.0, 0.0], src[:, 0].astype(np.float64)])
        y = np.zeros(total + 2)
        for n in range(total):
            y[n + 2] = b0[n] * (x[n + 2] - x[n]) - a1[n] * y[n + 1] - a2[n] * y[n]
        for name, v in out.items():
            e = np.abs(v - y[2:])
            print(f"  band-pass alone, {name} vs float64: {e.max():.3g} at sample {e.argmax()}")
        print(f"  band-pass alone, JAX vs port: {np.abs(out['JAX'] - out['port']).max():.3g}")

    for which in ("chain", "bank"):
        data = _jax_render(which)
        errors.clear()
        test_workload_matches_jax(data)
        windows = list(errors)
        test_jax_checkpoint_resumes_in_port(data)
        print(f"{which}: vs JAX over {WINDOWS[which]} s "
              f"{', '.join(f'{e:.3g}' for e in windows)} (peak {np.abs(data[1]).max():.3g}), "
              f"JAX checkpoint resumed in the port {errors[-1]:.3g}")
        if which == "chain":
            got = tpg.render_to_array(_build(tpg, which), block=BLOCK, device="cpu")
            e = np.abs(got - data[1])[:, 0]
            print(f"  whole 0.4 s: {e.max():.3g} at sample {e.argmax()}")
            bandpass_errors()
