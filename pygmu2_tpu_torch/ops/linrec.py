"""Linear recurrence over time, in plain PyTorch.

Counterparts of ``pygmu2_tpu.ops.linrec.affine_scan_1``,
``affine_scan_2``, ``affine_scan_2_auto``, ``affine_scan_2_seg``,
``affine_scan_nd``, ``biquad_filter``, ``one_pole_smooth`` and
``clamp_accum_scan`` (a saturating accumulator). A
(possibly time-varying) affine recurrence

    s[t] = A[t] @ s[t-1] + u[t]

is a composition of affine maps, and composition

    (A2, u2) ∘ (A1, u1) = (A2 @ A1, A2 @ u1 + u2)

is associative, so the prefix states are an inclusive scan. This module
scans by log-step doubling over the time axis (Hillis-Steele): ceil(log2 T)
passes, each a handful of elementwise ops over the whole (T, ...) block;
the filters' order-2 scan bounds the doubling to segments of 512 samples,
or, on a wide batch, takes the chunked kernel of
:mod:`pygmu2_tpu_torch.ops.linrec_kernel`.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch.ops.linrec_kernel import affine_scan_2_kernel
from pygmu2_tpu_torch.ops.xla_math import fmaf

# affine_scan_2_seg's pass over the stacked planes (m11, m12, m21, m22, v1,
# v2): row r is m[a]·p[b] + m[c]·p[d] for (a, b, c, d) = _PASS_ROWS[r], p
# the planes shifted (p11, p12, p21, p22, q1, q2); rows 4 and 5 add v
_PASS_ROWS = ((0, 0, 1, 2), (0, 1, 1, 3), (2, 0, 3, 2), (2, 1, 3, 3), (0, 4, 1, 5),
              (2, 4, 3, 5))

# affine_scan_2_auto's kernel route: 2-D batches of KERNEL_MIN_C..KERNEL_MAX_C
# channels and at least KERNEL_MIN_T samples, in chunks of KERNEL_CHUNK
KERNEL_MIN_T = 4096
KERNEL_MIN_C, KERNEL_MAX_C = 4, 128
KERNEL_CHUNK = 1024


def affine_scan_1(a, u, s0):
    """First-order affine recurrence ``s[t] = a[t]*s[t-1] + u[t]``.

    Counterpart of ``pygmu2_tpu.ops.linrec.affine_scan_1``. ``a`` and
    ``u`` are (T, ...) (broadcastable), ``s0`` the (...) state before
    step 0 or None. Returns the (T, ...) states after each step.
    """
    a, u = (x.clone() for x in torch.broadcast_tensors(a, u))
    if s0 is not None:
        u[0] += a[0] * s0
    T = u.shape[0]
    s = 1
    while s < T:
        # row t composes with row t - s (the earlier map)
        u[s:] = a[s:] * u[:-s] + u[s:]
        a[s:] = a[s:] * a[:-s]
        s *= 2
    return u


def affine_scan_2(a11, a12, a21, a22, u1, u2, s0=None):
    """Order-2 affine recurrence in structure-of-arrays form.

        s[t] = [[a11[t], a12[t]], [a21[t], a22[t]]] @ s[t-1] + [u1[t], u2[t]]

    All components are (T, ...) tensors (broadcastable). ``s0`` is an
    optional pair (s1, s2) of (...) tensors: the state before step 0.
    Returns (s1, s2): the two state components after each step, (T, ...).
    """
    a11, a12, a21, a22, u1, u2 = (
        x.clone() for x in torch.broadcast_tensors(a11, a12, a21, a22, u1, u2)
    )
    if s0 is not None:
        s01, s02 = s0
        u1[0] += a11[0] * s01 + a12[0] * s02
        u2[0] += a21[0] * s01 + a22[0] * s02
    T = u1.shape[0]
    s = 1
    while s < T:
        # row t composes with row t - s: left = earlier map, right = later
        la11, la12, la21, la22, lu1, lu2 = (
            x[:-s] for x in (a11, a12, a21, a22, u1, u2)
        )
        ra11, ra12, ra21, ra22, ru1, ru2 = (
            x[s:] for x in (a11, a12, a21, a22, u1, u2)
        )
        new = (
            ra11 * la11 + ra12 * la21,
            ra11 * la12 + ra12 * la22,
            ra21 * la11 + ra22 * la21,
            ra21 * la12 + ra22 * la22,
            ra11 * lu1 + ra12 * lu2 + ru1,
            ra21 * lu1 + ra22 * lu2 + ru2,
        )
        for dst, val in zip((a11, a12, a21, a22, u1, u2), new):
            dst[s:] = val
        s *= 2
    return u1, u2


def affine_scan_2_auto(a11, a12, a21, a22, u1, u2, s0=None, *, xla_fma: bool = False):
    """:func:`affine_scan_2` routed by shape, as
    ``pygmu2_tpu.ops.linrec.affine_scan_2_auto`` routes on the TPU.

    A 2-D batch of 4 to 128 channels and at least 4096 samples takes the
    chunked scan of :func:`~pygmu2_tpu_torch.ops.linrec_kernel.affine_scan_2_kernel`
    at chunk 1024 (the kernel on the card, its plain version on the CPU);
    any other 2-D batch the segmented scan, anything else the flat one.
    The route depends on the shapes only, so the CPU and the card take the
    same op order. ``xla_fma`` goes to the segmented scan.
    """
    if u1.dim() == 2:
        T, C = u1.shape
        if T >= KERNEL_MIN_T and KERNEL_MIN_C <= C <= KERNEL_MAX_C:
            return affine_scan_2_kernel(a11, a12, a21, a22, u1, u2, s0, chunk=KERNEL_CHUNK)
        return affine_scan_2_seg(a11, a12, a21, a22, u1, u2, s0=s0, xla_fma=xla_fma)
    return affine_scan_2(a11, a12, a21, a22, u1, u2, s0=s0)


def affine_scan_2_seg(a11, a12, a21, a22, u1, u2, s0=None, *, seg: int = 512,
                      xla_fma: bool = False):
    """Order-2 affine scan over (T, C), segmented for accuracy.

    Counterpart of ``pygmu2_tpu.ops.linrec.affine_scan_2_seg``, op for op:
    composing many near-unit 2x2 maps in float32 loses the output (a
    resonant biquad's poles at radius ~0.997), so every map product is
    bounded to ``seg`` steps:

    1. (T, C) -> (L, seg, C) segments, each scanned by an explicit
       Kogge-Stone doubling (a shift of the earlier rows, identity-padded);
    2. the segments' final maps are stitched by a length-L loop that
       carries the state value (no long map products form);
    3. each segment's prefix maps are applied to the state entering it.

    ``s0`` is an optional pair of (C,) states before step 0. Returns the
    two (T, C) state components after each step.

    ``xla_fma`` rounds as XLA's CPU program of ``biquad_filter`` does (its
    optimised HLO and LLVM IR): the backend fuses a product whose one use
    is a sum into a multiply-add, so each ``a·b + c·d`` is
    ``fma(a, b, c·d)`` in the passes, the stitch and the apply, except the
    first pass's row of ``a11``, ``a12``: those enter as the negations
    ``-a1``, ``-a2``, which LLVM folds into a subtraction,
    ``m12·p - a1·q``, fusing the other product. Without it every product
    and sum is rounded alone.
    """
    def fma2(a, b, c, d):  # a·b + c·d
        return fmaf(a, b, c * d) if xla_fma else a * b + c * d

    a11, a12, a21, a22, u1, u2 = torch.broadcast_tensors(a11, a12, a21, a22, u1, u2)
    T, C = u1.shape
    seg = min(seg, max(T, 1))
    L = -(-T // seg)
    pad = L * seg - T

    def prep(x, fill):
        if pad:
            x = torch.cat([x, x.new_full((pad, C), fill)])
        return x.reshape(L, seg, C)

    # The six planes stacked, (6, L, seg, C): m11, m12, m21, m22, v1, v2,
    # so that a pass is a handful of batched ops (on the card each op is a
    # launch the host enqueues). Identity-map padding keeps the tail
    # segment's stitch exact.
    m = torch.stack([prep(a11, 1.0), prep(a12, 0.0), prep(a21, 0.0), prep(a22, 1.0),
                     prep(u1, 0.0), prep(u2, 0.0)])
    ident = u1.new_zeros((6, L, 1, C))  # the shift's fill: the identity map
    ident[0] = 1.0
    ident[3] = 1.0
    s = 1
    while s < seg:
        p = torch.cat([ident.expand(6, L, s, C), m[:, :, :-s]], dim=2)  # p11 .. q2
        rows = _PASS_ROWS
        if s == 1 and xla_fma:  # the row of the negated coefficients
            rows = [row[2:] + row[:2] if i in (0, 1, 4) else row for i, row in enumerate(rows)]
        a, b, c, d = (torch.stack([src[row[k]] for row in rows])
                      for k, src in enumerate((m, p, m, p)))
        r = fma2(a, b, c, d)
        r[4:] += m[4:]
        m = r
        s *= 2

    # the stitch: the state entering each segment, from the segments' final
    # maps; both components from the same (x1, x2)
    fin = m[:, :, -1]  # (6, L, C)
    fa, fc = torch.stack([fin[0], fin[2]]), torch.stack([fin[1], fin[3]])
    zero = u1.new_zeros((C,))
    x = u1.new_zeros((2, C)) if s0 is None else torch.stack([zero + s0[0], zero + s0[1]])
    ins = []
    for i in range(L):
        ins.append(x)
        x = fma2(fa[:, i], x[:1], fc[:, i], x[1:]) + fin[4:, i]
    xin = torch.stack(ins, dim=1)[:, :, None]  # (2, L, 1, C)
    # each segment's prefix maps applied to its entering state
    out = fma2(torch.stack([m[0], m[2]]), xin[:1], torch.stack([m[1], m[3]]), xin[1:]) + m[4:]
    out = out.reshape(2, L * seg, C)[:, :T]
    return out[0], out[1]


def biquad_filter(x, b0, b1, b2, a1, a2, zi=None):
    """Direct-form-I biquad over (T, C), parallel in time.

    Counterpart of ``pygmu2_tpu.ops.linrec.biquad_filter``:

        y[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2]

    The FIR half is elementwise; the feedback half is the order-2 affine
    recurrence A[n] = [[-a1, -a2], [1, 0]], u[n] = [fir[n], 0], by
    :func:`affine_scan_2_auto` (the chunked kernel for 4 to 128 channels
    of at least 4096 samples, else the segmented scan). The coefficients are
    scalars or (T,) tensors; ``zi`` is the carried state
    ``{"x": (2, C) [x[-1], x[-2]], "y": (2, C) [y[-1], y[-2]]}`` or None
    for zeros. Returns (y (T, C), the state after the last sample).
    """
    T, C = x.shape

    def tv(c):
        c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
        return c.reshape(1, 1) if c.dim() == 0 else c.reshape(T, -1)

    b0, b1, b2, a1, a2 = tv(b0), tv(b1), tv(b2), tv(a1), tv(a2)
    if zi is None:
        x_tail = y_tail = x.new_zeros((2, C))
    else:
        x_tail, y_tail = zi["x"].to(x.dtype), zi["y"].to(x.dtype)

    xp = torch.cat([x_tail.flip(0), x])  # rows: x[-2], x[-1], x...
    # as XLA's CPU program fuses it (see affine_scan_2_seg's xla_fma)
    fir = fmaf(b2, xp[:-2], fmaf(b0, xp[2:], b1 * xp[1:-1]))
    # planes shared by the channels stay (T, 1) columns: the kernel reads
    # them once per sample, and its backward writes their cotangents as
    # columns
    zeros = x.new_zeros((T, 1))
    y, _ = affine_scan_2_auto(
        (-a1).expand(T, 1), (-a2).expand(T, 1), x.new_ones((T, 1)), zeros,
        fir, zeros, s0=(y_tail[0], y_tail[1]), xla_fma=True,
    )
    zf = {
        "x": torch.stack([x[-1], x[-2] if T >= 2 else x_tail[0]]),
        "y": torch.stack([y[-1], y[-2] if T >= 2 else y_tail[0]]),
    }
    return y, zf


def _associative_scan(combine, elems):
    """Inclusive scan over dim 0 of a tuple of tensors, in the tree of
    ``jax.lax.associative_scan`` (pairs reduced, the odd prefix scanned
    recursively, the even elements combined from it, interleaved), so a
    combine with rounding gives XLA's bits."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):
        x = ev.new_empty((n, *ev.shape[1:]))
        x[0::2] = ev
        x[1::2] = od
        out.append(x)
    return tuple(out)


def clamp_accum_scan(d, lo, hi, s0):
    """Saturating accumulator ``y[t] = clamp(y[t-1] + d[t], lo, hi)``,
    exactly, as an associative scan.

    Counterpart of ``pygmu2_tpu.ops.linrec.clamp_accum_scan``. The step map
    ``f(y) = clamp(y + s, L, H)`` is closed under composition:

        clamp(clamp(y + s1, L1, H1) + s2, L2, H2)
          = clamp(y + s1 + s2, clamp(L1 + s2, L2, H2),
                               clamp(H1 + s2, L2, H2))

    so the triples ``(s, L, H)`` scan associatively; the scan takes
    ``jax.lax.associative_scan``'s tree, so its sums round as the JAX
    package's do.

    Args:
        d: (T, ...) per-step increments.
        lo / hi: scalar clamp bounds.
        s0: (...) state before step 0.

    Returns:
        y: (T, ...) states after each step.
    """

    def combine(left, right):
        s1, l1, h1 = left
        s2, l2, h2 = right
        return (s1 + s2,
                torch.minimum(torch.maximum(l1 + s2, l2), h2),
                torch.minimum(torch.maximum(h1 + s2, l2), h2))

    S, L, H = _associative_scan(combine, (d, torch.full_like(d, lo), torch.full_like(d, hi)))
    return torch.minimum(torch.maximum(s0 + S, L), H)


def affine_scan_nd(A, u, s0):
    """D-dimensional affine recurrence ``s[t] = A[t] @ s[t-1] + u[t]``.

    Counterpart of ``pygmu2_tpu.ops.linrec.affine_scan_nd``, in the tree
    of ``jax.lax.associative_scan``.

    Args:
        A: (T, ..., D, D) per-step transition matrices.
        u: (T, ..., D) per-step inputs.
        s0: (..., D) initial state, or None for zeros.

    Returns:
        s: (T, ..., D) states after each step.

    D == 2 scans six (T, ...) component planes elementwise, as the JAX
    package does.
    """
    u = u.clone()
    if s0 is not None:
        if A.shape[-1] == 2:
            a = A[0]
            u[0] += torch.stack(
                [
                    a[..., 0, 0] * s0[..., 0] + a[..., 0, 1] * s0[..., 1],
                    a[..., 1, 0] * s0[..., 0] + a[..., 1, 1] * s0[..., 1],
                ],
                dim=-1,
            )
        else:
            u[0] += torch.einsum("...ij,...j->...i", A[0], s0)

    if A.shape[-1] == 2:
        comp = (A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1], u[..., 0], u[..., 1])

        def combine2(left, right):
            a1, b1, c1, d1, p1, q1 = left
            a2, b2, c2, d2, p2, q2 = right
            return (
                a2 * a1 + b2 * c1,
                a2 * b1 + b2 * d1,
                c2 * a1 + d2 * c1,
                c2 * b1 + d2 * d1,
                a2 * p1 + b2 * q1 + p2,
                c2 * p1 + d2 * q1 + q2,
            )

        out = _associative_scan(combine2, comp)
        return torch.stack([out[4], out[5]], dim=-1)

    def combine(left, right):
        A1, u1 = left
        A2, u2 = right
        return (
            torch.einsum("...ij,...jk->...ik", A2, A1),
            torch.einsum("...ij,...j->...i", A2, u1) + u2,
        )

    _, s = _associative_scan(combine, (A, u))
    return s


def one_pole_smooth(x, coef, s0=None):
    """Exponential smoother ``y[t] = y[t-1] + coef[t]·(x[t] − y[t-1])``.

    Counterpart of ``pygmu2_tpu.ops.linrec.one_pole_smooth``; coef may be
    per-sample (time-varying). Returns (y, y_final).
    """
    coef = torch.as_tensor(coef, dtype=x.dtype, device=x.device).expand(x.shape)
    a = 1.0 - coef
    u = coef * x
    y = affine_scan_1(a, u, s0)
    return y, y[-1]
