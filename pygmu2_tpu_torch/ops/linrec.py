"""Linear recurrence over time, in plain PyTorch.

Counterparts of ``pygmu2_tpu.ops.linrec.affine_scan_1`` and
``affine_scan_2``. A (possibly time-varying) affine recurrence

    s[t] = A[t] @ s[t-1] + u[t]

is a composition of affine maps, and composition

    (A2, u2) ∘ (A1, u1) = (A2 @ A1, A2 @ u1 + u2)

is associative, so the prefix states are an inclusive scan. This module
scans by log-step doubling over the time axis (Hillis-Steele): ceil(log2 T)
passes, each a handful of elementwise ops over the whole (T, ...) block.
"""

from __future__ import annotations

import torch


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
