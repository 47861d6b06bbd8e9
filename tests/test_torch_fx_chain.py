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
and centre, the two packages' band-passes are then equal bit for bit. The
slew limiter's input ``MixPE(ConstantPE(300), GainPE(env, 2500))`` is one
fused multiply-add in XLA's program, and the port's MixPE mirrors that
contraction: the centre input equals the JAX render's bit for bit. The six
strings take the JAX PE's blocked order (``ops/ks.ks_blocked_ref``: its
allpass as XLA's GEMV sums it) and the follower's update is one fused
multiply-add, so the strings, the follower and the slew limiter equal the
JAX PEs bit for bit, and the chain stays within 2e-8 of the JAX render over
the whole 0.4 s (3.73e-9: the compressor and the echo downstream).
``python tests/test_torch_fx_chain.py`` prints these numbers.
"""

import functools

import numpy as np
import pytest
import torch

import pygmu2_tpu as jpg
import pygmu2_tpu_torch as tpg
from pygmu2_tpu.core import engine as jengine
from pygmu2_tpu_torch import fx_workload, patch_workload
from pygmu2_tpu_torch.core import engine as tengine
from pygmu2_tpu_torch.ops import xla_math

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
# each render's bound beside the repo's 1e-4: about five times its observed
# maximum (chain 3.73e-9, bank 1.79e-7)
TIGHT = {"chain": 2e-8, "bank": 1e-6}


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


@functools.cache
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
        _close(got[span], want[span], TIGHT[which])
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


# ---- where the chain's residual comes from: each PE upstream of the wah
# fed the JAX render's own input to that PE ----

def _render_jax(pe):
    total = int(round(SECONDS["chain"] * fx_workload.SR))
    return np.asarray(jengine.render_scan(jpg.CropPE(pe, 0, total), 0, total, BLOCK))


def _render_port(pe):
    total = int(round(SECONDS["chain"] * fx_workload.SR))
    return np.asarray(tpg.render_to_array(tpg.CropPE(pe, 0, total), block=BLOCK, device="cpu"))


def _upstream():
    """The JAX render's intermediates of the wah's control path over the
    chain's 0.4 s: the gated strings (``src``), the follower's envelope and
    the slew limiter's input ``300 + 2500 * env`` (a MixPE of a ConstantPE
    and a GainPE)."""
    jpg.set_sample_rate(fx_workload.SR)
    tpg.set_sample_rate(fx_workload.SR)
    strings = jpg.MixPE(*(jpg.KarplusStrongPE(f, rho=0.9995, seed=i)
                          for i, f in enumerate(fx_workload.STRINGS)))
    src = jpg.GainPE(strings, jpg.PeriodicGate(2.0, 0.45))
    env = jpg.EnvelopePE(src, attack=0.005, release=0.08)
    centre_in = jpg.MixPE(jpg.ConstantPE(300.0), jpg.GainPE(env, 2500.0))
    return {name: _render_jax(pe)
            for name, pe in (("src", src), ("env", env), ("centre_in", centre_in))}


@pytest.fixture(scope="module")
def upstream():
    return _upstream()


# per PE: (the JAX PE, the port's, both built from the JAX input), and the
# largest difference held (the observed maxima in the comments)
def _string(i):
    f = fx_workload.STRINGS[i]
    return lambda pg, up: pg.KarplusStrongPE(f, rho=0.9995, seed=i)


UPSTREAM = {
    # bit for bit (before the blocked order was mirrored: <= 7.64e-7)
    **{f"string {f} Hz": (_string(i), 0.0)
       for i, f in enumerate(fx_workload.STRINGS)},
    # bit for bit (before the update was one fused multiply-add: 1.49e-8)
    "EnvelopePE": (lambda pg, up: pg.EnvelopePE(pg.ArrayPE(up["src"].copy()), attack=0.005,
                                                release=0.08), 0.0),
    # bit for bit
    "SlewLimiterPE": (lambda pg, up: pg.SlewLimiterPE(pg.ArrayPE(up["centre_in"].copy()),
                                                      40000.0, 8000.0), 0.0),
}


@pytest.mark.parametrize("name", list(UPSTREAM))
def test_upstream_pe_matches_jax_on_jax_input(upstream, name):
    build, atol = UPSTREAM[name]
    want, got = _render_jax(build(jpg, upstream)), _render_port(build(tpg, upstream))
    assert np.abs(want).max() > 1e-3
    _close(got, want, atol)


def test_strings_and_follower_equal_jax_pes(upstream):
    """On the port's own inputs (not the JAX render's), the six strings'
    sum gated and the follower's envelope equal the JAX render's bit for
    bit: nothing upstream of the wah differs any more."""
    pg = tpg
    strings = pg.MixPE(*(pg.KarplusStrongPE(f, rho=0.9995, seed=i)
                         for i, f in enumerate(fx_workload.STRINGS)))
    src = pg.GainPE(strings, pg.PeriodicGate(2.0, 0.45))
    np.testing.assert_array_equal(_render_port(src), upstream["src"])
    env = pg.EnvelopePE(src, attack=0.005, release=0.08)
    np.testing.assert_array_equal(_render_port(env), upstream["env"])


def test_centre_input_is_one_fused_multiply_add(upstream):
    """XLA contracts the GainPE's product into the MixPE's sum: the JAX
    centre input is ``fmaf(env, 2500, 300)``, rounded once; the port's
    MixPE mirrors the contraction (tests/test_torch_mix_contraction.py), so
    on the JAX envelope its centre input equals the JAX render's bit for
    bit."""
    env = torch.from_numpy(upstream["env"].copy())
    fused = xla_math.fmaf(env, 2500.0, 300.0).numpy()
    np.testing.assert_array_equal(fused, upstream["centre_in"])
    got = _render_port(tpg.MixPE(tpg.ConstantPE(300.0),
                                 tpg.GainPE(tpg.ArrayPE(upstream["env"].copy()), 2500.0)))
    np.testing.assert_array_equal(got, upstream["centre_in"])


def test_chain_on_jax_envelope_matches_jax(upstream):
    """The port's chain with the follower's envelope taken from the JAX
    render, the centre input formed by the port's MixPE and GainPE (equal to
    the JAX centre input bit for bit, above), stays within 1e-5 of the JAX
    render over the whole 0.4 s (observed 3.73e-9; 8.03e-5 with the product
    and the sum rounded apart). With its own envelope the chain differed by
    9.63e-5 until the strings' blocked order and the follower's fused
    multiply-add were mirrored; it now holds 3.73e-9 too."""
    want = _jax_render("chain")[1]
    pg = tpg
    centre_in = pg.MixPE(pg.ConstantPE(300.0),
                         pg.GainPE(pg.ArrayPE(upstream["env"].copy()), 2500.0))
    got = np.asarray(tpg.render_to_array(_chain_on_centre_input(centre_in), block=BLOCK,
                                         device="cpu"))
    _close(got, want, 1e-5)


def test_chain_on_jax_centre_input_matches_jax(upstream):
    """The port's chain with the slew limiter fed the JAX centre input stays
    within 1e-5 of the JAX render over the whole 0.4 s (observed 3.73e-9 at
    sample 16931; 4.30e-6 before the strings and the follower were
    mirrored; with its own centre input before the MixPE mirrored the
    contraction, 8.03e-5 at sample 5135)."""
    want = _jax_render("chain")[1]
    got = np.asarray(tpg.render_to_array(_chain_on_centre_input(upstream["centre_in"]),
                                         block=BLOCK, device="cpu"))
    _close(got, want, 1e-5)


def _chain_on_centre_input(centre_in):
    """``fx_workload.build_chain(tpg, 0.4)`` with the slew limiter's input
    replaced by ``centre_in`` (samples, or a PE)."""
    pg = tpg
    strings = pg.MixPE(*(pg.KarplusStrongPE(f, rho=0.9995, seed=i)
                         for i, f in enumerate(fx_workload.STRINGS)))
    src = pg.CachePE(pg.GainPE(strings, pg.PeriodicGate(2.0, 0.45)))
    if not isinstance(centre_in, pg.ProcessingElement):
        centre_in = pg.ArrayPE(centre_in.copy())
    centre = pg.SlewLimiterPE(centre_in, 40000.0, 8000.0)
    wah = pg.BiquadPE(src, centre, 6.0, mode=pg.BiquadMode.BANDPASS)
    out = fx_workload._echo_mix(pg, pg.CompressorPE(wah, threshold=-18.0, ratio=6.0))
    return pg.CropPE(out, 0, int(round(SECONDS["chain"] * fx_workload.SR)))


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
            up = _upstream()
            for name, (build, _atol) in UPSTREAM.items():
                want, got = _render_jax(build(jpg, up)), _render_port(build(tpg, up))
                e = np.abs(got - want)[:, 0]
                print(f"  {name} on the JAX input: {e.max():.3g} at sample {e.argmax()}")
            got = tpg.render_to_array(_chain_on_centre_input(up["centre_in"]), block=BLOCK,
                                      device="cpu")
            e = np.abs(got - data[1])[:, 0]
            print(f"  whole 0.4 s on the JAX centre input: {e.max():.3g} at sample {e.argmax()}")
