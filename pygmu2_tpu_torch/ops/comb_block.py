"""The feedback comb at a constant delay, in the JAX package's block order.

Counterpart of ``pygmu2_tpu.ops.comb_block``: with a constant integer
delay ``d`` the recurrence ``y[n] = x[n] + fb[n] * y[n - d]`` reads only
the block of ``d`` samples before, so the comb is a recurrence over
(d, C) blocks, ``y_k = x_k + fb_k * y_{k-1}``. XLA's CPU program of the
JAX function contracts that multiply-add into one rounding; so does this
one (``ops/xla_math.fmaf``), where the sequential comb and its kernel
round the product and the sum apart.

Plain torch, for API parity and as a second oracle for the comb kernel:
the port's CombPE takes the kernel (``ops/comb.comb_scan``) for every
frequency.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch.ops import xla_math


def comb_const_delay(x, fb, buf, pos, *, d: int, L: int):
    """x: (T, C) f32; fb: (T,) f32; buf: (L, C) ring of past outputs; pos:
    () int32 write head. Constant integer delay ``d`` (1 <= d < L).
    Returns (y (T, C), buf', pos'); the smoothed frequency's state is the
    caller's (a bitwise constant on this path)."""
    T, C = x.shape
    if not 1 <= d < L:
        raise ValueError(f"need 1 <= d < L, got d={d} L={L}")
    dev = x.device
    nb = -(-T // d)
    Tp = nb * d
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)

    # the last d outputs, oldest first: the samples y[-d..-1] the first
    # block reads
    idx0 = torch.remainder(pos - d + torch.arange(d, dtype=torch.int32, device=dev), L)
    w = buf[idx0.long()]
    xb = torch.cat([x, x.new_zeros((Tp - T, C))]).reshape(nb, d, C)
    fbb = torch.cat([fb, fb.new_zeros(Tp - T)]).reshape(nb, d, 1)
    blocks = []
    for xk, fbk in zip(xb, fbb):
        w = xla_math.fmaf(fbk, w, xk)  # x + fb * delayed, contracted as XLA's program
        blocks.append(w)
    y = torch.stack(blocks).reshape(Tp, C)[:T]

    pos2 = torch.remainder(pos + T, L).to(torch.int32)
    if T >= L:
        # every slot was written; y[T - L]'s slot is (pos + T - L) mod L == pos2
        buf2 = torch.roll(y[T - L:], int(pos2), dims=0)
    else:
        idxw = torch.remainder(pos + torch.arange(T, dtype=torch.int32, device=dev), L)
        buf2 = buf.clone()
        buf2[idxw.long()] = y
    return y, buf2, pos2
