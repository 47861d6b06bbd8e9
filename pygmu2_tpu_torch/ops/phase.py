"""Blocked phase accumulation: wide bases, narrow prefix sums.

Counterpart of ``pygmu2_tpu.ops.phase``, same arithmetic:

- local float32 cumsums within 1024-row tiles (phase accumulated
  over <= 1024 samples stays small, so its float32 error is ~1e-6 in
  phase units);
- a float64 cumsum over the <= T/1024 tile totals (the drift-free part);
- the base is wrapped to the modulus in float64 BEFORE the float32 cast,
  so the cast costs relative-of-modulus (~4e-7), not relative-of-total.

For phase consumers whose output slope in phase units is O(1) (sin,
piecewise-linear waveforms); the Dirichlet BLIT keeps a full float64
accumulation instead (see ops/trig.py).

Every prefix sum here is :func:`prefix_sum`, the blocked scan XLA runs
for ``jnp.cumsum`` on the CPU, reproduced bitwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pygmu2_tpu_torch.core import prec


_PREFIX_BASE = 16


def prefix_sum(x, dim: int = 0):
    """Inclusive prefix sum along ``dim`` in blocks of 16.

    Sequential within each block of 16; the block totals are scanned the
    same way, recursively, and added back. This is XLA's CPU rewrite of
    the JAX package's ``jnp.cumsum``, reproduced bitwise on either device,
    and its rounding depth is O(16 log16 T) instead of a sequential
    cumsum's O(T). It matters where phase error is amplified: near an
    integer phase the BLIT's fold (ops/trig.py) turns a 4e-13 phase error
    of a sequential float64 cumsum over 16384 samples into ~1e-4 of output.
    """
    x = x.movedim(dim, 0)
    n = x.shape[0]
    nb = -(-n // _PREFIX_BASE)
    pad = x.new_zeros((nb * _PREFIX_BASE - n, *x.shape[1:]))
    loc = torch.cat([x, pad]).reshape(nb, _PREFIX_BASE, *x.shape[1:])
    for i in range(1, _PREFIX_BASE):
        loc[:, i] += loc[:, i - 1]
    if nb > 1:
        loc[1:] += prefix_sum(loc[:-1, -1])[:, None]
    return loc.reshape(nb * _PREFIX_BASE, *x.shape[1:])[:n].movedim(0, dim)


_PHASE_BLOCK = 1024  # rows of the float32 local prefix sums


def wrapped_phase_accum(acc, inc, modulus: float):
    """(phase32, final_wide): phase[t] = mod(acc + prefix(inc)[t], modulus),
    the prefix including inc[t] (the phase AFTER the step).

    Args:
        acc: scalar wide carried phase entering the window.
        inc: (T,) wide per-sample increments.
        modulus: wrap period (1.0 for normalized phase, 2*pi for radians).

    Returns:
        phase32: (T,) float32 wrapped phase in [0, modulus).
        final_wide: scalar wide acc + sum(inc) (not wrapped).
    """
    (T,) = inc.shape
    Tp = -(-T // _PHASE_BLOCK) * _PHASE_BLOCK
    xb = F.pad(inc, (0, Tp - T)).reshape(Tp // _PHASE_BLOCK, _PHASE_BLOCK)
    loc = prefix_sum(xb.to(torch.float32), dim=1)  # (B, block) f32
    totals = xb.sum(dim=1)  # (B,) wide — exact block sums
    base = prefix_sum(totals)  # (B,) wide, inclusive
    final = acc + base[-1]
    base_excl = torch.cat([torch.zeros((1,), dtype=prec.WIDE, device=inc.device), base[:-1]])
    # Wrap the wide part per block, THEN cast: the f32 value is small.
    base32 = torch.remainder(acc + base_excl, modulus).to(torch.float32)
    phase = base32[:, None] + loc
    phase = torch.remainder(phase, modulus).reshape(Tp)[:T]
    return phase, final
