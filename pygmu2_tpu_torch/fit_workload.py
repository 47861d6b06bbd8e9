"""The training path: patch parameters fitted by gradient descent.

The builders take a package namespace ``pg`` — ``pygmu2_tpu_torch`` or the
JAX package ``pygmu2_tpu`` — so the same graph can be built from either
and the two renders (and their gradients) compared. Each sets the sample
rate to 44.1 kHz. Their ``ParamPE`` values are the parameters: a render
through ``engine.render_functional`` with bindings that require grad is
differentiable with respect to them.

- :func:`build_probe`: the JAX package's gradient probe
  (``bench.py:_grad_probe``): a band-limited saw through a LadderPE whose
  cutoff is ``ParamPE("cutoff")`` and a CombPE whose feedback is
  ``ParamPE("fb")``, cropped to ``PROBE_N`` samples (rendered in blocks of
  ``PROBE_BLOCK``).
- :func:`build_fit_patch`: ``patch_workload.build_patch`` with the ladder
  sweep's centre bound to ``ParamPE("cutoff")`` and the comb's feedback to
  ``ParamPE("fb")``.
- :func:`build_fit_bank`: ``filter_workload.build_filter_bank`` with the
  BiquadPE's and the SVFilterPE's sweep centres bound to
  ``ParamPE("low_hz")`` and ``ParamPE("band_hz")``.
- :func:`build_fit_chain`: ``fx_workload.build_chain`` with the wah's
  sweep depth bound to ``ParamPE("depth")`` and the echo's feedback to
  ``ParamPE("fb")``: the follower's, the slew limiter's and the echo's
  backward.
- :func:`build_fit_fx_bank`: ``fx_workload.build_fx_bank`` with a gain
  ``ParamPE("drive")`` before its compressor and the echo's feedback bound
  to ``ParamPE("fb")``: the follower's and the echo's backward at 128
  channels.
  Both fit their compressor with the peak detector. The RMS detector's
  gradient is NaN wherever its input falls silent, in the JAX package as
  in the port: its mean is a difference of two prefix sums over the block,
  which cancels to exactly 0 there, and the square root's derivative at 0
  is infinite.
- :func:`build_sweep`: ``examples/gradient_fit_eg.py``'s patch, its
  cutoff ``ParamPE("cutoff")`` (the example's candidate sweep).
- :func:`build_adsr_probe`: a gated ADSR whose gate is scaled by
  ``ParamPE("g")``: the ADSR's backward (the gate enters only through
  compares, so the gradient is exactly zero, as the JAX package's).
- :func:`fit`: the loop of ``examples/gradient_fit_eg.py`` on
  ``torch.optim.Adam`` (optax's Adam there): a mean squared error against a
  target render, frequencies fitted as their logarithms.
- The string fit (:func:`render_string`, :func:`fit_string`): no PE hands
  the Karplus-Strong string an input that requires grad, in either
  package (KarplusStrongPE's ``rho`` is a float, its excitation seeded
  noise), so its gradient is reached by calling ``ops/ks.ks_scan`` block
  by block as KarplusStrongPE does, and fitting the excitation (L,) and a
  scalar ``rho`` to a target rendered from hidden ones: the string's
  backward in both of its orders, its state's cotangents crossing the
  blocks.

Under ``torch.func.vmap`` over the bindings (``vmap(lambda b:
render_functional(graph, 0, n, block, b))``) each builder's render is a
batch of candidates, the counterpart of ``jax.vmap`` over the JAX
package's ``render_functional`` (``examples/gradient_fit_eg.py``'s cutoff
sweep).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygmu2_tpu_torch import fx_workload
from pygmu2_tpu_torch.patch_workload import SR, _swept, detuned_saws, patch_envelopes

PROBE_N, PROBE_BLOCK = 4096, 1024
# parameters fitted in log space (well scaled: a frequency's steps are ratios)
LOG_PARAMS = ("cutoff", "low_hz", "band_hz", "depth")


def _swept_around(pg, centre, hz: float, depth: float):
    """``centre + depth * sin(2π hz t)`` as a PE, ``centre`` a PE."""
    return pg.MixPE(centre, pg.SinePE(hz, amplitude=depth))


def build_probe(pg, n: int = PROBE_N):
    """The gradient probe's graph, cropped to ``n`` samples."""
    pg.set_sample_rate(SR)
    osc = pg.BlitSawPE(frequency=110.0, amplitude=0.8)
    lad = pg.LadderPE(osc, pg.ParamPE("cutoff", default=1500.0), 0.45)
    return pg.CropPE(pg.CombPE(lad, 220.0, feedback=pg.ParamPE("fb", default=0.6)), 0, n)


def build_fit_patch(pg, seconds: float):
    """The mono patch of ``patch_workload.build_patch`` with its ladder's
    sweep centre ``ParamPE("cutoff")`` (default 1500 Hz) and its comb's
    feedback ``ParamPE("fb")`` (default 0.6), cropped to ``seconds``."""
    pg.set_sample_rate(SR)
    gated, triggered = patch_envelopes(pg)
    cutoff = _swept_around(pg, pg.ParamPE("cutoff", default=1500.0), 0.25, 1200.0)
    lead = pg.LadderPE(pg.BlitSawPE(110.0, amplitude=0.8), cutoff, 0.45)
    lead = pg.GainPE(lead, gated)
    pluck = pg.GainPE(pg.BlitSawPE(220.0), triggered)
    comb = pg.CombPE(pg.MixPE(lead, pluck), _swept(pg, 220.0, 0.5, 20.0),
                     feedback=pg.ParamPE("fb", default=0.6))
    return pg.CropPE(comb, 0, int(round(seconds * SR)))


def build_fit_bank(pg, seconds: float, seed: int = 0):
    """The 128-channel filter bank of ``filter_workload.build_filter_bank``
    with its BiquadPE's sweep centre ``ParamPE("low_hz")`` (default 1500
    Hz) and its SVFilterPE's ``ParamPE("band_hz")`` (default 800 Hz),
    cropped to ``seconds``."""
    pg.set_sample_rate(SR)
    n = int(round(seconds * SR))
    saws = pg.ArrayPE(detuned_saws(n, seed))
    low = pg.BiquadPE(saws, _swept_around(pg, pg.ParamPE("low_hz", default=1500.0), 0.25, 1200.0),
                      4.0, mode=pg.BiquadMode.LOWPASS)
    band = pg.SVFilterPE(low, _swept_around(pg, pg.ParamPE("band_hz", default=800.0), 0.4, 500.0),
                         2.0, mode=pg.BiquadMode.BANDPASS)
    return pg.CropPE(pg.GainPE(band, 0.5), 0, n)


def build_fit_chain(pg, seconds: float):
    """The mono effects chain of ``fx_workload.build_chain`` with the wah's
    sweep depth ``ParamPE("depth")`` (default 2500 Hz) and the echo's
    feedback ``ParamPE("fb")`` (default 0.6), its compressor's detector the
    peak one, cropped to ``seconds``."""
    pg.set_sample_rate(SR)
    return fx_workload.build_chain(pg, seconds, depth=pg.ParamPE("depth", default=2500.0),
                                   feedback=pg.ParamPE("fb", default=0.6),
                                   detection=pg.DetectionMode.PEAK)


def build_fit_fx_bank(pg, seconds: float, seed: int = 0, channels: int = 128):
    """The effects bank of ``fx_workload.build_fx_bank`` with a gain
    ``ParamPE("drive")`` (default 1.0) before its compressor and the echo's
    feedback ``ParamPE("fb")`` (default 0.6), its compressor's detector the
    peak one, cropped to ``seconds``."""
    pg.set_sample_rate(SR)
    return fx_workload.build_fx_bank(pg, seconds, seed, drive=pg.ParamPE("drive", default=1.0),
                                     feedback=pg.ParamPE("fb", default=0.6),
                                     channels=channels, detection=pg.DetectionMode.PEAK)


def build_sweep(pg, n: int = PROBE_N):
    """``examples/gradient_fit_eg.py``'s patch: a 110 Hz band-limited saw
    through a low-pass BiquadPE whose cutoff is ``ParamPE("cutoff")``
    (default 1500 Hz), then a GainPE of ``ParamPE("gain")`` (default 0.42),
    cropped to ``n`` samples: its candidate sweep vmaps the cutoff."""
    pg.set_sample_rate(SR)
    osc = pg.BlitSawPE(frequency=110.0)
    filt = pg.BiquadPE(osc, pg.ParamPE("cutoff", default=1500.0), 0.707,
                       mode=pg.BiquadMode.LOWPASS)
    return pg.CropPE(pg.GainPE(filt, pg.ParamPE("gain", default=0.42)), 0, n)


def build_adsr_probe(pg, n: int = PROBE_N):
    """A 220 Hz sine under a gated ADSR whose gate, a 20 Hz square gate, is
    scaled by ``ParamPE("g")`` (default 1.0), cropped to ``n`` samples."""
    pg.set_sample_rate(SR)
    gate = pg.GainPE(pg.PeriodicGate(20.0, 0.5), pg.ParamPE("g", default=1.0))
    env = pg.AdsrGatedPE(gate, attack_time=0.005, decay_time=0.01, sustain_level=0.6,
                         release_time=0.01)
    return pg.CropPE(pg.GainPE(pg.SinePE(220.0), env), 0, n)


def bindings_of(params: dict) -> dict:
    """The render's bindings from the fitted parameters (log-space ones
    exponentiated: the gradient chains through the exp)."""
    return {k: v.exp() if k in LOG_PARAMS else v for k, v in params.items()}


def fit(graph, target, theta: dict, steps: int, lr: float, *, block: int, device="cuda",
        on_step=None):
    """Fit ``graph``'s ParamPE values to ``target`` by Adam on the mean
    squared error of ``engine.render_functional``.

    ``target``: the (n, C) render to match (a tensor or array); ``theta``:
    name -> starting value (floats). Frequencies in :data:`LOG_PARAMS` are
    fitted as their logarithms, the rest as they are. ``on_step(step,
    loss, values)``, if given, is called after each step with the step's
    loss (a 0-d tensor on ``device``, before the update) and the
    parameters' values after it. Returns (the losses as floats, the
    fitted values).
    """
    from pygmu2_tpu_torch.core import engine

    device = torch.device(device)
    target = torch.as_tensor(target, dtype=torch.float32).to(device)
    params = {k: torch.tensor(math.log(v) if k in LOG_PARAMS else float(v),
                              dtype=torch.float32, device=device, requires_grad=True)
              for k, v in theta.items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    losses = []
    for step in range(steps):
        opt.zero_grad()
        out = engine.render_functional(graph, 0, target.shape[0], block, bindings_of(params),
                                       device=device)
        loss = torch.mean((out - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if on_step is not None:
            with torch.no_grad():
                values = {k: v.detach().clone() for k, v in bindings_of(params).items()}
            on_step(step, losses[-1], values)
    with torch.no_grad():
        fitted = {k: float(v) for k, v in bindings_of(params).items()}
    return [float(v) for v in losses], fitted


# the string fit: the effects chain's low string (fx_workload.STRINGS[0]),
# whose first block starts STRING_HEAD samples before t = 0
STRING_HZ = fx_workload.STRINGS[0]
STRING_HEAD = 64
STRING_START = {"seed": 0, "rho": 0.999}
STRING_HIDDEN = {"seed": 1, "rho": 0.996}


def string_shape(hz: float = STRING_HZ, sr: int = SR) -> tuple[int, float]:
    """(L, allpass_c) of a string at ``hz``, as KarplusStrongPE forms them."""
    delay = sr / hz
    L = max(2, int(math.floor(delay)))
    frac = min(1.0, max(0.0, delay - L))
    return L, (1.0 - frac) / (1.0 + frac)


def string_excitation(L: int, seed: int, amplitude: float = 1.0) -> np.ndarray:
    """KarplusStrongPE's excitation: seeded noise scaled to ``amplitude``."""
    noise = np.random.default_rng(seed).standard_normal(L).astype(np.float32)
    return noise * (amplitude / (np.max(np.abs(noise)) + 1e-9))


def render_string(excitation, rho, n: int, block: int, *, allpass_c: float,
                  head: int = STRING_HEAD):
    """The string's first ``n`` samples from ``excitation`` (L,) and the
    scalar ``rho``, rendered as KarplusStrongPE renders them from a start
    ``head`` samples before t = 0: blocks of ``block`` samples through
    ``ops/ks.ks_scan``, the first with its pre-t0 rows inactive (the
    per-sample order), the rest all active (the blocked order at L >= 16),
    the string, its read position and the allpass state carried from block
    to block. Differentiable in both arguments."""
    from pygmu2_tpu_torch.ops import ks

    L, dev = excitation.shape[0], excitation.device
    buf, r = excitation, torch.zeros((), dtype=torch.int32, device=dev)
    ai = ao = torch.zeros((), dtype=torch.float32, device=dev)
    outs = []
    for b0 in range(-head, n, block):
        T = min(block, n - b0)
        t = torch.arange(b0, b0 + T, device=dev)
        y, buf, r, ai, ao = ks.ks_scan(rho.expand(T), t >= 0, buf, r, ai, ao, L=L,
                                       allpass_c=allpass_c, all_active=b0 >= 0)
        outs.append(y)
    return torch.cat(outs)[head:]


def fit_string(target, excitation, rho: float, steps: int, lr: float, *, block: int,
               allpass_c: float, head: int = STRING_HEAD, device="cuda", on_step=None):
    """Fit a string's excitation and ``rho`` to ``target`` (n,) by Adam on
    the mean squared error of :func:`render_string`, ``rho`` as
    ``log(1 - rho)`` (a decay's steps are ratios). ``on_step(step, loss,
    rho)`` as :func:`fit`'s. Returns (the losses as floats, the fitted
    rho, the fitted excitation as a numpy array)."""
    device = torch.device(device)
    target = torch.as_tensor(target, dtype=torch.float32).to(device)
    exc = torch.as_tensor(excitation, dtype=torch.float32).to(device).requires_grad_()
    theta = torch.tensor(math.log(1.0 - rho), dtype=torch.float32, device=device,
                         requires_grad=True)
    opt = torch.optim.Adam([exc, theta], lr=lr)
    losses = []
    for step in range(steps):
        opt.zero_grad()
        out = render_string(exc, 1.0 - theta.exp(), target.shape[0], block,
                            allpass_c=allpass_c, head=head)
        loss = torch.mean((out - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if on_step is not None:
            with torch.no_grad():
                on_step(step, losses[-1], 1.0 - theta.exp())
    with torch.no_grad():
        return ([float(v) for v in losses], float(1.0 - theta.exp()),
                exc.detach().cpu().numpy())
