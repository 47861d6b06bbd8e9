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
- :func:`powf`: glibc 2.36's ``powf`` (``sysdeps/ieee754/flt-32/e_powf.c``,
  which XLA's CPU program calls for ``x ** y``): ``log2(x)`` from a
  16-entry table and a degree-5 polynomial, times ``y``, then ``2^t``
  from a 32-entry table and a degree-3 polynomial, all in float64, rounded
  once to float32; for positive normal ``x`` and finite ``y``.
- :func:`expf`: XLA's own float32 ``exp`` (a Cephes-style range
  reduction and degree-5 polynomial it inlines into the fusion, each
  product that feeds a sum contracted into a fused multiply-add, the
  result flushed to zero below the normal range); torch's and the C
  library's differ from it on ~10 % of arguments.

Each is differentiable with the gradient of the function it rounds
(``a·b + c``, ``exp``, ``x ** y``, ``sin``/``cos``, ``sqrt``): the bit
corrections (the midpoint step, table lookups, bit views) carry none.
"""

from __future__ import annotations

import functools
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
_TINY = 2.0 ** -12  # the least float32 of abstop12 0x398
_BIG = 120.0  # the least float32 of abstop12 0x42F


def _wide(v):
    return v.double() if isinstance(v, torch.Tensor) else v


def fmaf(a, b, c):
    """Float32 ``a·b + c`` with one rounding (XLA's contracted multiply-add,
    CUDA's ``__fmaf_rn``). Each argument is a float32 tensor or a Python
    float holding a float32 value; at least one of ``a``, ``b`` a tensor."""
    p = _wide(a) * _wide(b)  # exact: 48 significant bits
    c = _wide(c)
    s = p + c  # the gradient of a·b + c flows through these two ops only
    with torch.no_grad():
        # s is p + c rounded to float64; err, the part it lost, is exact (TwoSum)
        bp = s - p
        err = (p - (s - bp)) + (c - bp)
        # rounding s to float32 again goes wrong only where s landed on a
        # float32 midpoint (its low 29 mantissa bits 1000...0) that p + c is
        # not on: step s one float64 ulp towards p + c there (the step is
        # exact, and s + step is the neighbour itself)
        # (the bits from frexp's significand, exact in int64: torch.func.vmap
        # has no rule for a dtype view)
        low = (torch.frexp(s.abs()).mantissa * 2.0 ** 53).to(torch.int64) & 0x1FFFFFFF
        fix = (low == 0x10000000) & (err != 0) & torch.isfinite(s)
        step = torch.nextafter(s, torch.full_like(s, torch.inf).copysign(err)) - s
    return torch.where(fix, s + step, s).float()


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
    # abstop12(y) >= abstop12(120) is |y| >= 120 and abstop12(y) <
    # abstop12(2^-12) is |y| < 2^-12: compares, not a dtype view (which
    # torch.func.vmap cannot batch)
    big, tiny = y.abs() >= _BIG, y.abs() < _TINY
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
    # big: the library's slow reduction, float64 sin and cos
    sin_w = torch.where(big, torch.sin(x), sin_w).float()
    cos_w = torch.where(big, torch.cos(x), cos_w).float()
    return torch.where(tiny, y, sin_w), torch.where(tiny, torch.ones_like(y), cos_w)


# XLA's inlined float32 exp: input clamp, log2(e), ln 2 split in two and
# the polynomial's coefficients, as they stand in its CPU program
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E = 1.4426950216293335
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592, 0.5)
_FLT_MIN = 1.1754943508222875e-38


class _Exp(torch.autograd.Function):
    """:func:`expf`'s bits forward; the gradient of ``exp``, ``g·exp(x)``,
    backward (from the forward's result, as JAX differentiates ``exp``)."""

    @staticmethod
    def forward(ctx, x):
        y = _expf(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def expf(x):
    """Float32 ``exp`` of a float32 tensor, as XLA's CPU program computes
    it: ``n = floor(x log2 e + 1/2)``, ``r = x - n ln 2`` in two fused
    steps, ``1 + r + r^2 p(r)``, scaled by ``2^n``; subnormal results are
    flushed to zero, as the CPU's flush-to-zero mode does there.
    Differentiable: its gradient is ``exp``'s."""
    return _Exp.apply(x.to(torch.float32))


def _expf(x):
    x = x.clamp(_EXP_LO, _EXP_HI)
    n = torch.floor(fmaf(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fmaf(n, -_LN2_HI, x)
    r = fmaf(n, -_LN2_LO, r)
    p = fmaf(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = fmaf(p, r, c)
    y = 1.0 + fmaf(p, r * r, r)
    y = y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(y.abs() < _FLT_MIN, torch.zeros_like(y), y)


# glibc's __powf_log2_data (invc, logc) and polynomial, and __exp2f_data's
# table, shift and polynomial, as glibc 2.36 ships them
_POWF_LOG2 = (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"),
)
_POWF_A = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_EXP2F_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540,
)
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")  # rounds to a multiple of 1/32
_EXP2F_C = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))


@functools.lru_cache(maxsize=None)
def _powf_tables(device):
    """(invc, logc, exp2 table) on ``device``, copied there once."""
    invc = torch.tensor([float.fromhex(a) for a, _ in _POWF_LOG2], dtype=torch.float64)
    logc = torch.tensor([float.fromhex(b) for _, b in _POWF_LOG2], dtype=torch.float64)
    tab = torch.tensor([t - (1 << 64) if t >= 1 << 63 else t for t in _EXP2F_TAB],
                       dtype=torch.int64)
    return invc.to(device), logc.to(device), tab.to(device)


class _Pow(torch.autograd.Function):
    """:func:`powf`'s bits forward; the gradient of ``x ** y`` backward, as
    JAX differentiates ``pow``: ``y·x^(y-1)`` and ``log(x)·x^y``."""

    @staticmethod
    def forward(ctx, x, y):
        out = _powf(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, out = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = (g * (y * torch.pow(x, y - 1.0))).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            gy = (g * (torch.log(x) * out)).sum_to_size(y.shape)
        return gx, gy


def powf(x, y):
    """Float32 ``x ** y`` as glibc's ``powf`` computes it, for float32
    tensors of positive normal ``x`` and finite ``y`` (``y == 0`` gives 1).
    Its float64 steps are the library's; where the library fuses a
    product into a sum, the float64 result differs by at most an ulp of a
    double, which the final rounding to float32 absorbs. Differentiable:
    its gradient is ``x ** y``'s."""
    return _Pow.apply(x.to(torch.float32), y.to(torch.float32))


def _powf(x, y):
    invc_t, logc_t, tab = _powf_tables(x.device)
    # log2(x): x = 2^k z, z near the table's c, log2(z) = log2(c) + log1p(z/c - 1)/ln 2
    ix = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    tmp = (ix - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    z = ((ix - top) & 0xFFFFFFFF).to(torch.int32).view(torch.float32).double()
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) >> 23  # signed shift
    r = z * invc_t[i] - 1.0
    y0 = logc_t[i] + k.double()
    a = _POWF_A
    r2 = r * r
    p0 = a[0] * r + a[1]
    p1 = a[2] * r + a[3]
    q = p1 * r2 + (a[4] * r + y0)
    logx = p0 * (r2 * r2) + q
    # 2^(y log2 x): k/32 + r, 2^(k/32) from the table, 2^r a polynomial
    xd = y.double() * logx
    kd = xd + _EXP2F_SHIFT
    ki = kd.view(torch.int64)
    r = xd - (kd - _EXP2F_SHIFT)
    s = (tab[ki & 31] + (ki << 47)).view(torch.float64)
    c = _EXP2F_C
    w = (c[0] * r + c[1]) * (r * r) + (c[2] * r + 1.0)
    out = (w * s).float()
    return torch.where(y == 0, torch.ones_like(out), out)
