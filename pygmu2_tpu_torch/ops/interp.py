"""Fractional-index gather + interpolation primitive.

Counterpart of ``pygmu2_tpu.ops.interp`` (reference:
src/pygmu2/interpolated_lookup.py:33-144), used by DelayPE (fractional or
modulated delay), WavetablePE and TimeWarpPE. Callers pull a window of
the source and this gathers into it; out-of-window indices give zeros
(``oob_zero``) or clamp to the edge rows.

The JAX package fetches the stencil through ``ops/table.py``'s one-hot
lookup, a workaround for the TPU's slow gathers; on the CPU that lookup
is a plain gather, and so is it here. The arithmetic is that of XLA's CPU
program of the JAX PEs, read from its object code: LLVM contracts a
product whose one use is a sum into one fused multiply-add
(``ops/xla_math.fmaf``):

- linear: ``fma(frac, y1 - y0, y0)``;
- Catmull-Rom: ``3 (y0 - y1) + y2`` and the three Horner steps fuse; the
  products by 2, 4 and 0.5 are exact, and ``5 y0`` is rounded (the
  difference it feeds fuses the other, exact, product).
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch.ops.xla_math import fmaf, mod


def _lerp(y0, y1, f):
    return fmaf(f, y1 - y0, y0)


def _catmull_rom(ym1, y0, y1, y2, f):
    a = fmaf(y0 - y1, 3.0, y2) - ym1
    b = (4.0 * y1 + (2.0 * ym1 - 5.0 * y0)) - y2
    c = fmaf(f, a, b)
    e = fmaf(f, c, y1 - ym1)
    return fmaf(f * 0.5, e, y0)


def _index(i, W: int, wrap: bool):
    """Row indices clamped to (or wrapped into) [0, W)."""
    return torch.remainder(i, W) if wrap else i.clamp(0, W - 1)


def _interp(window, i0, frac, mode: str, wrap: bool):
    """Interpolate ``window`` (W, C) at rows ``i0 + frac``: i0 (T, 1) or
    (T, C) integer rows, the stencil's rows clamped to (or wrapped into)
    the window. For a position inside the window (every one the callers
    keep) this is the JAX package's stencil of shifted copies."""
    W, C = window.shape

    def row(k):
        return torch.gather(window, 0, _index(i0 + k, W, wrap).expand(-1, C))

    if mode == "linear":
        return _lerp(row(0), row(1), frac)
    if mode == "cubic":
        return _catmull_rom(row(-1), row(0), row(1), row(2), frac)
    raise ValueError(f"unknown interpolation mode: {mode}")


def interp_window(window, pos, mode: str = "linear", oob_zero: bool = True):
    """Interpolate ``window`` at fractional row positions ``pos``.

    Args:
        window: (W, C) source samples (row i is "index i").
        pos: (T,) or (T, C) float32 fractional row indices into the window.
        mode: "linear" or "cubic" (Catmull-Rom).
        oob_zero: zero samples whose position lies outside [0, W-1]. When
            False, out-of-range positions clamp to the edge rows (the
            interpolant is evaluated at the clamped position, so the
            edge value holds exactly).
    Returns:
        (T, C) interpolated samples.
    """
    W = window.shape[0]
    pos = pos.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[:, None]  # one index stream over every channel
    # clamp mode evaluates at the clamped position; zero mode masks the
    # output, so the stencil only needs to be in range
    pos_eval = pos if oob_zero else pos.clamp(0.0, W - 1.0)
    i0 = torch.floor(pos_eval)
    out = _interp(window, i0.long(), pos_eval - i0, mode, wrap=False)
    if oob_zero:
        # the linear validity range in both modes, so edge samples survive
        # cubic lookups (the stencil clamps)
        valid = (pos >= 0.0) & (pos <= W - 1.0)
        out = torch.where(valid, out, 0.0)
    return out


def wrap_interp(table, phase, mode: str = "linear"):
    """Periodic-table lookup: ``phase`` in table rows, wrapped modulo W.

    Used by wavetable oscillators. phase: (T,) or (T, C) fractional rows.
    """
    W = table.shape[0]
    phase = phase.to(torch.float32)
    if phase.dim() == 1:
        phase = phase[:, None]
    p = mod(phase, float(W))
    i0 = torch.floor(p)
    frac = (p - i0).to(table.dtype)
    i0 = i0.long()
    if phase.shape[1] == 1:
        # the JAX package clamps one index stream's base row (p rounds up
        # to W when the phase is a tiny negative number) before wrapping
        i0 = i0.clamp(0, W - 1)
    return _interp(table, i0, frac, mode, wrap=True)
