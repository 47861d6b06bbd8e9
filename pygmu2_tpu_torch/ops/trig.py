"""Wide-phase, narrow-transcendental trig for band-limited oscillators.

Counterpart of ``pygmu2_tpu.ops.trig``. The Dirichlet BLIT kernel
sin(mπφ)/sin(πφ) amplifies phase error by its slope (~m² in φ units), so
a plain float32 phase is not accurate enough at ~100 harmonics. The range
reduction runs wide (float64): the argument of sin(πx) is folded to its
nearest integer, the small residual is cast to float32 (keeping relative
precision), and one float32 sin runs on an argument ≤ π/2.
"""

from __future__ import annotations

import math

import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.ops import xla_math


def sinpi_folded(x):
    """sin(π·x) evaluated float32 with ~1e-7 RELATIVE error, from wide ``x``.

    Folds ``x`` to its nearest integer (half to even, as ``jnp.round``),
    casts the residual r = x − round(x) (|r| ≤ ½) to float32, and returns
    (−1)^round(x) · sin(π·r).
    """
    k = torch.round(x)
    r = (x - k).to(prec.AUDIO)
    # (−1)^k without integer conversion: k mod 2 ∈ {0, 1} exactly.
    sign = (1.0 - 2.0 * torch.remainder(k, 2.0)).to(prec.AUDIO)
    return sign * xla_math.sincosf(math.pi * r)[0]  # glibc's sinf, as XLA's jnp.sin


def dirichlet_blit(phase, m, P):
    """AC-coupled Dirichlet BLIT: sin(mπφ)/(P·sin(πφ)) − 1/P, float32 output.

    ``phase``: wide phase in periods. ``m``: odd harmonic count (wide,
    elementwise). ``P``: period in samples (wide). All shapes broadcast.
    At exact integer phase the kernel's limit is m (m odd).
    """
    den = sinpi_folded(phase)
    num = sinpi_folded(m * phase)
    m32 = m.to(prec.AUDIO)
    P32 = P.to(prec.AUDIO)
    near_zero = den.abs() < 1e-12
    safe = torch.where(near_zero, 1.0, den)
    d = torch.where(near_zero, m32, num / safe)
    return (d - 1.0) / P32
