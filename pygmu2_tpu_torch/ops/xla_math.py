"""Float32 sine, cosine and fused multiply-add as XLA computes them on the CPU.

The JAX package's reference renders run on XLA's CPU backend. There
``jnp.sin`` and ``jnp.cos`` call the C library's ``sinf`` and ``cosf``
(glibc's, which are not correctly rounded: they differ from the float32
rounding of the exact sine on ~1 % of arguments), and LLVM contracts a
float32 product whose one use is an addition into one fused multiply-add.
A resonant filter moves with a one-ulp change of its poles, so the port
computes BiquadPE's coefficients with these functions, op for op.

- :func:`sincosf`: glibc 2.36's ``sinf`` and ``cosf``
  (``sysdeps/ieee754/flt-32/s_sinf.c``, ``s_cosf.c``, ``sincosf.h``) for
  |x| < 120, evaluated in float64 tensor ops: the quadrant reduction
  ``x - n·π/2`` (one rounding, as the library's fused multiply-add: both
  products are exact with π/2 split in two) and the degree-8 cosine or
  degree-7 sine polynomial of ``__sincosf_table``, rounded to float32.
  Beyond 120 (the library's slow reduction) they return the float32
  rounding of the float64 sine and cosine.
- :func:`fmaf`: ``round_f32(a·b + c)`` with one rounding, in float64
  tensor ops: the float32 product is exact in float64, and the float64 sum
  is corrected where its own rounding put it on a float32 midpoint.
- :func:`mod`: ``jnp.mod``, exact (``torch.remainder`` rounds).
- :func:`sqrtf`: the correctly rounded float32 square root XLA emits
  (``vsqrtss``); torch's CPU float32 ``sqrt`` is a vectorized
  approximation one ulp off on ~0.6 % of arguments.
"""

from __future__ import annotations

import struct

import torch

# __sincosf_table of glibc 2.36: 2/π·2^24, π/2, and the polynomials'
# coefficients (c0..c4 cosine, s1..s3 sine); the second table negates the
# cosine's for quadrants 2 and 3
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p+0")
# π/2 as hi + lo with a 26-bit hi: n·hi and n·lo are exact for n < 2^27
_HPI_HI = struct.unpack("<d", struct.pack("<Q", struct.unpack("<Q", struct.pack("<d", _HPI))[0]
                                          & ~((1 << 27) - 1)))[0]
_HPI_LO = _HPI - _HPI_HI
_C = (
    float.fromhex("-0x1.ffffffd0c621cp-2"),
    float.fromhex("0x1.55553e1068f19p-5"),
    float.fromhex("-0x1.6c087e89a359dp-10"),
    float.fromhex("0x1.99343027bf8c3p-16"),
)
_S = (
    float.fromhex("-0x1.555545995a603p-3"),
    float.fromhex("0x1.1107605230bc4p-7"),
    float.fromhex("-0x1.994eb3774cf24p-13"),
)
_TINY_TOP = 0x398  # abstop12(2^-12)
_BIG_TOP = 0x42F  # abstop12(120)


def _wide(v):
    return v.double() if isinstance(v, torch.Tensor) else v


def fmaf(a, b, c):
    """Float32 ``a·b + c`` with one rounding (XLA's contracted multiply-add,
    CUDA's ``__fmaf_rn``). Each argument is a float32 tensor or a Python
    float holding a float32 value; at least one of ``a``, ``b`` a tensor."""
    p = _wide(a) * _wide(b)  # exact: 48 significant bits
    c = _wide(c)
    s = p + c
    # s is p + c rounded to float64; err, the part it lost, is exact (TwoSum)
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    # rounding s to float32 again goes wrong only where s landed on a float32
    # midpoint (its low 29 mantissa bits 1000...0) that p + c is not on: step
    # s one float64 ulp towards p + c there
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    # err * inf is +-inf where err is not 0 (the only places it is used)
    s = torch.where(mid & (err != 0), torch.nextafter(s, err * torch.inf), s)
    return s.float()


def mod(a, b):
    """``a mod b`` with the divisor's sign, exact as ``jnp.mod``: the
    remainder of ``fmod`` (exact), moved by b where its sign differs
    (``torch.remainder`` computes ``a - b * floor(a / b)``, which rounds)."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def sqrtf(x):
    """Correctly rounded float32 square root of a float32 tensor: the
    float64 root rounded once to float32 (exact: 53 >= 2·24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def sincosf(y):
    """Float32 (sine, cosine) of a float32 tensor, as glibc's ``sinf`` and
    ``cosf``: one quadrant reduction, both polynomials, each result picked
    by the quadrant's parity (below π/4 the reduction is exact, n = 0)."""
    y = y.to(torch.float32)
    x = y.double()
    top = (y.abs().view(torch.int32) >> 20) & 0x7FF
    n = (torch.trunc(x * _HPI_INV).to(torch.int64) + 0x800000) >> 24
    nd = n.double()
    r = (x - nd * _HPI_HI) - nd * _HPI_LO
    q = n & 3
    xs = torch.where((q == 1) | (q == 2), -r, r)  # r * sign[n & 3]
    x2 = r * r
    # sinf_poly's two branches of xs: the sine polynomial and the cosine
    # polynomial, the latter negated in quadrants 2 and 3 (table [1])
    x3 = xs * x2
    sin_p = (xs + x3 * _S[0]) + (x3 * x2) * (_S[1] + x2 * _S[2])
    x4 = x2 * x2
    cos_p = ((1.0 + x2 * _C[0]) + x4 * _C[1]) + (x4 * x2) * (_C[2] + x2 * _C[3])
    cos_p = torch.where((n & 2) != 0, -cos_p, cos_p)
    odd = (n & 1) == 1
    sin_w, cos_w = torch.where(odd, cos_p, sin_p), torch.where(odd, sin_p, cos_p)
    big = top >= _BIG_TOP  # the library's slow reduction: float64 sin and cos
    sin_w = torch.where(big, torch.sin(x), sin_w).float()
    cos_w = torch.where(big, torch.cos(x), cos_w).float()
    tiny = top < _TINY_TOP
    return torch.where(tiny, y, sin_w), torch.where(tiny, torch.ones_like(y), cos_w)
