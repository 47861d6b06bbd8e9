"""The reverse echo at a static block length and unity pitch, in the JAX
package's block-period order.

Counterpart of ``pygmu2_tpu.ops.reverse_echo_block``: while block k is
written only the completed block k - 1 plays back, so with a static
integer block length ``Lb`` (a fixed point of the length's smoother) and a
pitch ratio whose pitch stage is bypassed (the near-unity select passes
x through), the recurrence runs over block periods: each period's wet
output is a windowed, possibly reversed gather from the previous period's
written block, and the written block is ``x + wet * fb``, its multiply-add
contracted into one rounding as XLA's CPU program contracts it (the
sequential echo and its kernel round the two apart). A start inside a block
(``w_idx != 0``) aligns the input to the block grid with a roll; the
first period's rows written before the call come from the carried buffer.

Plain torch, for API parity and as a second oracle for the echo kernel:
the port's ReversePitchEchoPE takes the kernel (``ops/reverse_echo``) in
every case. The Hann window is glibc's ``cosf``
(``ops/xla_math.sincosf``), as XLA's CPU program computes it; the port's
sequential plain echo takes ``torch.cos`` there, which the card kernel's
``cosf`` equals on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygmu2_tpu_torch.ops import xla_math


def _i32(v, dev):
    return torch.as_tensor(v, device=dev).to(torch.int32)


def _fmod_floor(a, b):
    """``jnp.mod`` of floats: C's exact ``fmod``, moved into b's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def reverse_echo_aligned(x, fb, buf_a, buf_b, pitch_buf, cur_is_a, p_wpos, p_rpos, w_idx,
                         prev_block, reverse, *, Lb: int, plen: int, ratio: float,
                         alternate: bool):
    """x: (T, C) f32; fb: (T,) f32; buf_a / buf_b: (cap, C) block buffers;
    pitch_buf: (plen, C). The scalars are the echo's state (as in
    ``ops/reverse_echo.MISC_FIELDS``). ``Lb`` is the static block length
    (the smoothed length and the current block). Requires smoothed == Lb,
    cur_block == Lb, w_idx == r_idx in [0, Lb), prev_block in {0, Lb}.

    Returns (wet (T, C), buf_a', buf_b', pitch_buf', cur_is_a', p_wpos',
    p_rpos', w_idx', prev_block', reverse'); r_idx' == w_idx', and the
    smoothed length and current block are unchanged."""
    T, C = x.shape
    dev = x.device
    nseg = -(-(T + Lb) // Lb)  # covers off + T for any off < Lb
    Tp = nseg * Lb
    cur_is_a, p_wpos, w_idx, prev_block, reverse = (
        _i32(v, dev) for v in (cur_is_a, p_wpos, w_idx, prev_block, reverse))
    p_rpos = torch.as_tensor(p_rpos, dtype=torch.float32, device=dev)
    off = int(w_idx)

    xf = x.to(torch.float32)
    xp = torch.roll(torch.cat([xf, xf.new_zeros((Tp - T, C))]), off, dims=0)
    fbp = torch.roll(torch.cat([fb.to(torch.float32), fb.new_zeros(Tp - T)]), off)
    xb, fbb = xp.reshape(nseg, Lb, C), fbp.reshape(nseg, Lb, 1)

    rows = torch.arange(Lb, dtype=torch.int32, device=dev)
    a_first = cur_is_a == 1
    cur_rows = torch.where(a_first, buf_a[:Lb], buf_b[:Lb])
    other_rows = torch.where(a_first, buf_b[:Lb], buf_a[:Lb])
    # rows below seg_start were written before this call (period 0 only)
    seg_start = [off] + [0] * (nseg - 1)
    two_pi = torch.full((), 2.0 * math.pi, dtype=torch.float32, device=dev)

    # XLA's program of the JAX function runs the periods two to a loop
    # trip: a trip's second period knows its previous count is Lb and
    # folds 2π (r / (Lb - 1)) into r times one float32 constant
    folded = torch.full((), float(np.float32(2.0 * math.pi) * (np.float32(1.0)
                                                                / np.float32(Lb - 1))),
                        dtype=torch.float32, device=dev)
    rows32 = rows.to(torch.float32)
    prev_rows, prev_cnt, rev = other_rows, prev_block, reverse
    wets, written = [], []
    for k, (xk, fbk, start_k) in enumerate(zip(xb, fbb, seg_start)):
        # per sample, the sequential echo's step
        idx = torch.where(rev == 1, prev_cnt - 1 - rows, rows)
        playing = (prev_cnt > 0) & (rows < prev_cnt) & (idx >= 0) & (idx < prev_cnt)
        if k % 2:
            arg = rows32 * folded
        else:
            wpos = torch.where(prev_cnt > 1, rows32 / torch.clamp(prev_cnt - 1, min=1).float(),
                               torch.zeros((), dtype=torch.float32, device=dev))
            arg = two_pi * wpos
        window = 0.5 - 0.5 * xla_math.sincosf(arg)[1]
        wet_raw = prev_rows[idx.clamp(0, Lb - 1).long()]
        wet = torch.where(playing[:, None], wet_raw * window[:, None],
                          torch.zeros((), dtype=torch.float32, device=dev))
        # the pitch stage passes x through; XLA contracts the multiply-add
        write_val = xla_math.fmaf(wet, fbk, xk)
        wv = torch.where((rows < start_k)[:, None], cur_rows, write_val)
        wets.append(wet)
        written.append(wv)
        prev_rows, prev_cnt = wv, _i32(Lb, dev)
        rev = (1 - rev) if alternate else _i32(1, dev)
    y = torch.stack(wets).reshape(Tp, C)[off:off + T]
    wvb = torch.stack(written)

    # ---- the state after the call ----
    total = off + T
    nblocks = total // Lb  # block swaps during the call
    w_f = total - nblocks * Lb

    def seg(k):
        return wvb[min(max(k, 0), nseg - 1)]

    # the current buffer: rows below w_f from the partial block, the rest
    # what the sequential echo left there (the block written two swaps
    # ago, or the contents before the call when fewer swaps happened)
    twoago = seg(nblocks - 2) if nblocks >= 2 else (other_rows if nblocks == 1 else cur_rows)
    curbuf_rows = torch.where((rows < w_f)[:, None], seg(nblocks), twoago)
    prevbuf_rows = seg(nblocks - 1) if nblocks >= 1 else other_rows

    cur_is_a2 = 1 - cur_is_a if nblocks % 2 == 1 else cur_is_a
    a2 = cur_is_a2 == 1
    buf_a2, buf_b2 = buf_a.clone(), buf_b.clone()
    buf_a2[:Lb] = torch.where(a2, curbuf_rows, prevbuf_rows).to(buf_a.dtype)
    buf_b2[:Lb] = torch.where(a2, prevbuf_rows, curbuf_rows).to(buf_b.dtype)

    prev2 = _i32(Lb, dev) if nblocks >= 1 else prev_block
    if alternate:
        rev2 = 1 - reverse if nblocks % 2 == 1 else reverse
    else:
        rev2 = _i32(1, dev) if nblocks >= 1 else reverse

    # the pitch line: no output reads it on this path, but it stays right
    # for a checkpoint; p_rpos is the closed form of the iterated float32
    # add, as the JAX function's
    p_wpos2 = torch.remainder(p_wpos + T, plen).to(torch.int32)
    t32 = torch.full((), float(T), dtype=torch.float32, device=dev)
    r32 = torch.full((), ratio, dtype=torch.float32, device=dev)
    p_rpos2 = _fmod_floor(p_rpos + t32 * r32,
                          torch.full((), float(plen), dtype=torch.float32, device=dev))
    if T >= plen:
        pitch_buf2 = torch.roll(xf[T - plen:], int(p_wpos2), dims=0).to(pitch_buf.dtype)
    else:
        idxw = torch.remainder(p_wpos + torch.arange(T, dtype=torch.int32, device=dev), plen)
        pitch_buf2 = pitch_buf.clone()
        pitch_buf2[idxw.long()] = xf.to(pitch_buf.dtype)

    return (y, buf_a2, buf_b2, pitch_buf2, cur_is_a2.to(torch.int32), p_wpos2,
            p_rpos2, _i32(w_f, dev), prev2.to(torch.int32), rev2.to(torch.int32))
