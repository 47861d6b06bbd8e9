"""The reverse pitch echo's per-sample recurrence over three rings.

Counterpart of ``pygmu2_tpu.ops.reverse_echo_pallas``: one function,
``reverse_echo_scan``, takes the (T, C) input, the (T,) per-sample
controls (block length in seconds, pitch ratio, feedback, alternate
direction), the two (cap, C) block buffers, the (plen, C) pitch line and
the (9,) scalar state in :data:`MISC_FIELDS` order, and returns the wet
output and the four state pieces after the last sample.

Each sample: the block length is smoothed and rounded; the input goes
through a two-head pitch shifter into the current block buffer, with the
previous block replayed reversed (or alternating) under a Hann window and
fed back; the buffers swap when the current block is full.

- ``reverse_echo_scan`` is the wrapper. For CUDA tensors it launches the
  hand-written kernel in ``csrc/reverse_echo_scan.cu`` (two launches: a
  serial control pass shared by the channels, then an audio pass parallel
  within each block period), which updates the two block buffers in
  place, and counts the call in ``reverse_echo_scan.launches``; for CPU
  tensors it runs the plain version.
- ``reverse_echo_scan_ref`` is the plain PyTorch version with the JAX
  package's ``reverse_echo_scan_ref`` op order, float32: a pass over the
  samples that runs the control machine (it reads only the controls) in
  float32 scalars on the host, then a per-sample loop over the (C,) rows
  on the tensors' device, the Hann window by ``torch.cos`` there.
- ``reverse_echo_scan_periods`` computes the same in the kernel's order,
  in torch ops: the control table, then period by period a gather from
  the pitch line and the input and a write of the current block (tests
  hold it to ``reverse_echo_scan_ref`` bit for bit).
- ``reverse_echo_scan_bwd`` is the backward: the cotangents of x, the
  pitch ratio, the feedback, the two block buffers, the pitch line and the
  misc row (its read position and smoothed length; the rest are integers).
  For CUDA tensors it launches ``csrc/reverse_echo_scan_bwd.cu`` (counted
  in ``reverse_echo_scan_bwd.launches``) on the forward launch's control
  results: on the card ``reverse_echo_scan``'s launch, when it goes
  through the autograd Function, also returns its table, period bounds
  and period count, and the Function keeps them as residuals (an
  untracked launch keeps none). ``reverse_echo_scan_bwd_ref`` is its
  plain version: the periods in reverse, each in torch ops;
  ``reverse_echo_scan_bwd_periods`` the same in the kernel's order and
  roundings (tests and ``chip_smoke.py``: its fused multiply-adds, its
  channel sums in channel order, the pitch line's cotangent gathered row
  by row in the order of ``echo_readers``), equal to the kernel bit for
  bit on the same control results (``echo_control_ref`` makes them in
  torch ops).
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable
from pygmu2_tpu_torch.ops.xla_math import fmaf

MISC_FIELDS = (
    "cur_is_a", "p_wpos", "p_rpos", "w_idx", "r_idx", "smoothed",
    "cur_block", "prev_block", "reverse",
)
_TWO_PI = 2.0 * 3.14159265358979323846


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _control(blk, ratio, alt, misc, *, sr, plen, cap, min_block, max_block,
             smooth_alpha):
    """The control machine over T samples, in float32 on the host.

    Returns (per-sample steps, misc after the last sample). A step holds
    the pitch line's write slot and read taps with their float32 weights,
    the pass-through flag, the window position, the replay row (None when
    not playing), the write row, which buffer is current and the sign of
    the crossfade's slope in the read position (the backward's). The weights
    and the misc row's read position and smoothed length are 0-d tensors
    in the graph of ``ratio`` and ``misc`` (the pitch ratio moves the read
    heads continuously); the block length and the alternation enter only
    through roundings and compares, as host values."""
    sr32, alpha = _f32(sr), _f32(smooth_alpha)
    inv_plen, fplen, half, inv_half = (
        _f32(1.0 / plen), _f32(plen), _f32(plen / 2.0), _f32(1.0 / (plen / 2.0))
    )
    fmin, fmax, one, tol = _f32(min_block), _f32(max_block), _f32(1.0), _f32(1e-4)

    def wrap(p):
        return p - torch.floor(p * inv_plen) * fplen

    def tap(p):
        i = min(max(int(torch.floor(p)), 0), plen - 1)
        frac = p - _f32(i)
        return i, (i + 1) % plen, one - frac, frac

    m = misc.to("cpu", torch.float32)
    cur_is_a, p_wpos, w_idx, r_idx = int(m[0]), int(m[1]), int(m[3]), int(m[4])
    cur_block, prev_block, reverse = int(m[6]), int(m[7]), int(m[8])
    p_rpos, smoothed = m[2].clone(), m[5].clone()
    steps = []
    for b, rt32, al in zip(blk.tolist(), ratio.to("cpu", torch.float32), alt.tolist()):
        tt = _f32(b) * sr32
        if torch.isnan(tt):
            tt = fmin
        target = torch.round(torch.clamp(tt, fmin, fmax))
        smoothed = smoothed + (target - smoothed) * alpha
        if w_idx == 0:
            cur_block = int(torch.clamp(torch.round(smoothed), fmin, fmax))

        wslot = p_wpos
        p_wpos = (p_wpos + 1) % plen
        pos = wrap(p_rpos)
        taps = tap(pos) + tap(wrap(pos + half))
        dist = p_rpos - _f32(p_wpos)
        sgn = 1.0 if dist >= 0 else -1.0  # d dist / d p_rpos
        dist = torch.where(dist >= 0, dist, -dist)  # |d|, with JAX's gradient (1) at d = 0
        if dist > half:
            dist = fplen - dist
            sgn = -sgn
        f = dist * inv_half
        near_unity = bool(torch.abs(rt32 - one) < tol)
        p_rpos = wrap(p_rpos + rt32)

        idx = prev_block - 1 - r_idx if reverse == 1 else r_idx
        playing = prev_block > 0 and r_idx < prev_block and 0 <= idx < prev_block
        wpos = _f32(r_idx) / _f32(max(prev_block - 1, 1)) if prev_block > 1 else _f32(0.0)
        steps.append((
            wslot, taps, f, one - f, near_unity, float(wpos),
            min(max(idx, 0), cap - 1) if playing else None,
            min(w_idx, cap - 1), cur_is_a == 1, sgn,
        ))

        w_idx += 1
        r_idx += 1
        if w_idx >= cur_block:
            cur_is_a = 1 - cur_is_a
            prev_block = cur_block
            reverse = 1 - reverse if al >= 0.5 else 1
            w_idx = r_idx = 0
    misc_out = torch.stack([_f32(cur_is_a), _f32(p_wpos), p_rpos, _f32(w_idx), _f32(r_idx),
                            smoothed, _f32(cur_block), _f32(prev_block), _f32(reverse)])
    return steps, misc_out


def reverse_echo_scan_ref(x, blk, ratio, fb, alt, buf_a, buf_b, pitch_buf, misc,
                          *, sr, plen, cap, min_block, max_block, smooth_alpha):
    """Plain PyTorch version of :func:`reverse_echo_scan` (same arguments
    and result). Python loops over samples: keep T small."""
    dev = x.device
    steps, misc_out = _control(
        blk, ratio, alt, misc, sr=sr, plen=plen, cap=cap, min_block=min_block,
        max_block=max_block, smooth_alpha=smooth_alpha,
    )
    wpos = torch.tensor([s[5] for s in steps], dtype=torch.float32, device=dev)
    half_cos = 0.5 * torch.cos(torch.full((), _TWO_PI, dtype=torch.float32, device=dev) * wpos)
    window = 0.5 - half_cos
    x = x.to(torch.float32)
    fb = fb.to(torch.float32)
    functional = diffable.transformed(x, ratio, fb, buf_a, buf_b, pitch_buf)  # torch.func
    put = lambda buf, i, v: diffable.put_row(buf, i, v, functional)  # noqa: E731
    rings, pb = [buf_a.clone(), buf_b.clone()], pitch_buf.clone()
    y = torch.zeros_like(x)
    for t, (wslot, taps, f, omf, near_unity, _w, rrow, wrow, write_a, _s) in enumerate(steps):
        i0, i1, w0, w1, i2, i3, w2, w3 = taps
        xi = x[t]
        pb = put(pb, wslot, xi)
        if near_unity:
            pitched = xi
        else:
            r = torch.stack([pb[i0], pb[i1], pb[i2], pb[i3]])  # a copy: pb changes in place
            s1 = w0 * r[0] + w1 * r[1]
            s2 = w2 * r[2] + w3 * r[3]
            pitched = f * s1 + omf * s2
        cur = 0 if write_a else 1
        if rrow is None:
            rings[cur] = put(rings[cur], wrow, pitched)
        else:
            wet = rings[1 - cur][rrow].clone() * window[t]
            y = put(y, t, wet)
            rings[cur] = put(rings[cur], wrow, pitched + wet * fb[t])
    return y, rings[0], rings[1], pb, misc_out.to(dev)


def reverse_echo_scan_periods(x, blk, ratio, fb, alt, buf_a, buf_b, pitch_buf, misc,
                              *, sr, plen, cap, min_block, max_block, smooth_alpha):
    """:func:`reverse_echo_scan_ref` in the order of the kernel's two passes
    (same arguments and result), for the tests.

    The control table comes from :func:`_control`. A period is a run of
    samples between two swaps: it writes only the current block and reads
    only the previous one, which the period before it completed, so its
    samples are independent and are computed together. The pitch line
    holds only input samples: at time t slot i holds
    ``x[t - ((wslot_t - i) mod plen)]``, or the line handed in when that
    index is negative, so each tap is a gather from ``[pitch_buf ; x]``."""
    dev = x.device
    steps, misc_out = _control(
        blk, ratio, alt, misc, sr=sr, plen=plen, cap=cap, min_block=min_block,
        max_block=max_block, smooth_alpha=smooth_alpha,
    )
    T, C = x.shape
    x = x.to(torch.float32)
    fb = fb.to(torch.float32)
    ba, bb = buf_a.clone(), buf_b.clone()
    y = torch.zeros_like(x)
    f32 = dict(dtype=torch.float32, device=dev)
    wslot = torch.tensor([s[0] for s in steps], device=dev)
    taps = torch.tensor([[s[1][k] for k in (0, 1, 4, 5)] for s in steps], device=dev)
    wts = torch.tensor([[float(s[1][k]) for k in (2, 3, 6, 7)] for s in steps], **f32)
    f, omf = (torch.tensor([float(s[k]) for s in steps], **f32) for k in (2, 3))
    near_unity = torch.tensor([s[4] for s in steps], device=dev)
    wpos = torch.tensor([s[5] for s in steps], **f32)
    window = 0.5 - 0.5 * torch.cos(torch.full((), _TWO_PI, **f32) * wpos)
    rrow = torch.tensor([-1 if s[6] is None else s[6] for s in steps], device=dev)
    wrow = torch.tensor([s[7] for s in steps], device=dev)
    write_a = [s[8] for s in steps]
    line = torch.cat([pitch_buf.to(torch.float32), x])  # slot i, then x[t] at plen + t

    def slot(t, ws, i):
        """Rows of ``line`` that hold slot i at time t (write slot ws)."""
        src = t - (ws - i) % plen
        return torch.where(src >= 0, plen + src, i)

    starts = [0] + [t for t in range(1, T) if write_a[t] != write_a[t - 1]] + [T]
    for a, b in zip(starts[:-1], starts[1:]):
        t = torch.arange(a, b, device=dev)
        ws = wslot[a:b]
        p = [line[slot(t, ws, taps[a:b, k])] for k in range(4)]
        w = [wts[a:b, k, None] for k in range(4)]
        s1 = w[0] * p[0] + w[1] * p[1]
        s2 = w[2] * p[2] + w[3] * p[3]
        pitched = torch.where(near_unity[a:b, None], x[a:b],
                              f[a:b, None] * s1 + omf[a:b, None] * s2)
        cur, prev = (ba, bb) if write_a[a] else (bb, ba)
        play = rrow[a:b] >= 0
        wet = prev[rrow[a:b].clamp(min=0)] * window[a:b, None]
        y[a:b] = torch.where(play[:, None], wet, y[a:b])
        cur[wrow[a:b]] = torch.where(play[:, None], pitched + wet * fb[a:b, None], pitched)
    last = torch.full((plen,), T - 1, device=dev)
    pb = line[slot(last, wslot[-1], torch.arange(plen, device=dev))]
    return y, ba, bb, pb, misc_out.detach().to(dev)


def _table(steps, dev):
    """The control steps as per-sample tensors on ``dev`` (the kernel's
    table): write slot, the four taps (T, 4) and their weights, f, 1 - f,
    the pass-through flag, the Hann window, the replay row (-1: not
    playing), the write row, which buffer is current, the slope's sign,
    and the periods' bounds."""
    f32 = dict(dtype=torch.float32, device=dev)
    wpos = torch.tensor([s[5] for s in steps], **f32)
    write_a = [s[8] for s in steps]
    T = len(steps)
    return dict(
        wslot=torch.tensor([s[0] for s in steps], device=dev),
        taps=torch.tensor([[s[1][k] for k in (0, 1, 4, 5)] for s in steps], device=dev),
        wts=torch.tensor([[float(s[1][k]) for k in (2, 3, 6, 7)] for s in steps], **f32),
        f=torch.tensor([float(s[2]) for s in steps], **f32),
        omf=torch.tensor([float(s[3]) for s in steps], **f32),
        near_unity=torch.tensor([s[4] for s in steps], device=dev),
        window=0.5 - 0.5 * torch.cos(torch.full((), _TWO_PI, **f32) * wpos),
        rrow=torch.tensor([-1 if s[6] is None else s[6] for s in steps], device=dev),
        wrow=torch.tensor([s[7] for s in steps], device=dev),
        write_a=write_a,
        sgn=torch.tensor([s[9] for s in steps], **f32),
        starts=[0] + [t for t in range(1, T) if write_a[t] != write_a[t - 1]] + [T],
    )


# the forward's table row (csrc/reverse_echo_control.cuh, struct Tab), 16
# 32-bit words: taps i0..i3, weights 1 - frac, frac, 1 - frac2, frac2, the
# crossfade f and 1 - f, the window, the slope's sign (float32 bits), the
# replay row (-1: none), the write row, the write slot, the flags
NEAR_UNITY, CUR_IS_A = 1, 2  # the flags' bits


def echo_control_ref(blk, ratio, alt, misc, *, sr, plen, cap, min_block, max_block,
                     smooth_alpha):
    """The forward launch's control results in torch ops, as the kernel
    returns them for the backward: (tab (T, 16) int32 in the kernel's
    layout, bounds (T + 1,) int32: the periods' starts and T in its first
    n + 1 entries, n_periods (1,) int32 holding n), on ``ratio``'s
    device. The window is ``torch.cos``'s (the kernel's ``cosf`` may
    differ in its last bit)."""
    dev = ratio.device
    with torch.no_grad():
        steps, _ = _control(blk, ratio, alt, misc, sr=sr, plen=plen, cap=cap,
                            min_block=min_block, max_block=max_block, smooth_alpha=smooth_alpha)
    tb = _table(steps, dev)
    T = len(steps)
    flags = (tb["near_unity"].to(torch.int32) * NEAR_UNITY
             + torch.tensor(tb["write_a"], device=dev).to(torch.int32) * CUR_IS_A)
    words = torch.stack([tb["f"], tb["omf"], tb["window"], tb["sgn"]], 1)
    tab = torch.cat([tb["taps"].to(torch.int32), tb["wts"].view(torch.int32),
                     words.view(torch.int32),
                     torch.stack([tb["rrow"], tb["wrow"], tb["wslot"]], 1).to(torch.int32),
                     flags[:, None]], 1).contiguous()
    starts = tb["starts"]
    bounds = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    bounds[:len(starts)] = torch.tensor(starts, dtype=torch.int32, device=dev)
    n_periods = torch.tensor([len(starts) - 1], dtype=torch.int32, device=dev)
    return tab, bounds, n_periods


def _decode(tab):
    """The table's columns: taps (T, 4) int64, wts (T, 4) f32, f, 1 - f,
    window, sign (T,) f32, rows (T, 4) int64 (replay, write, slot, flags)."""
    words = tab.view(torch.float32)
    return (tab[:, 0:4].long(), words[:, 4:8], words[:, 8], words[:, 9], words[:, 10],
            words[:, 11], tab[:, 12:16].long())


def echo_readers(tab, bounds, n_periods, plen):
    """The pitch line's readers in the backward kernel's gather order.

    A reader is a pass-through (kind 0: sample t near unity pitch reads
    x_t) or a tap (kind 1 + i: tap i of sample t reads the input of time
    t - ((wslot_t - i_t) mod plen), or below 0 the line handed in). Each
    line row, by the input time s it holds (s + plen from 0 to T + plen),
    takes its readers in the order the plain version adds them: periods
    last first, in a period the pass-throughs, then tap 0, 1, 2 and 3,
    each in time order. Returns (row (N,), t (N,), kind (N,)) sorted by
    row and then by that order, and each row's first position and count
    (T + plen,)."""
    dev = tab.device
    T = tab.shape[0]
    taps, *_, rows = _decode(tab)
    n = int(n_periods.reshape(-1)[0])
    starts = bounds[:n + 1].long()
    t = torch.arange(T, device=dev)
    p = torch.searchsorted(starts[1:], t, right=True)  # each sample's period
    a, b = starts[p], starts[p + 1]
    near = (rows[:, 3] & NEAR_UNITY) != 0
    src = [t] + [t - torch.remainder(rows[:, 2] - taps[:, i], plen) for i in range(4)]
    keep = [near] + [~near] * 4
    order = [5 * (T - b) + kind * (b - a) + (t - a) for kind in range(5)]
    key = torch.cat([s_ + plen for s_ in src])
    kind = torch.arange(5, device=dev).repeat_interleave(T)
    sel = torch.cat(keep)
    key, tt, kind, e = key[sel], t.repeat(5)[sel], kind[sel], torch.cat(order)[sel]
    perm = torch.argsort(key * (5 * T) + e)
    key, tt, kind = key[perm], tt[perm], kind[perm]
    count = torch.bincount(key, minlength=T + plen)
    first = torch.cumsum(count, 0) - count
    return key, tt, kind, first, count


def echo_gather(gcs, tab, bounds, n_periods, gpb):
    """The pitch line's cotangent (plen + T, C) from each sample's gc
    (T, C), in the kernel's order: a row's final cotangent (gpb, where the
    row is in the line after the call) added to 0 first, then its readers'
    in ``echo_readers``'s order, a pass-through's gc, a tap's
    (gc f) w or (gc (1 - f)) w."""
    T, C = gcs.shape
    plen = gpb.shape[0]
    dev = gcs.device
    taps, wts, f, omf, *_, rows = _decode(tab)
    key, tt, kind, first, count = echo_readers(tab, bounds, n_periods, plen)
    mix = torch.where(kind <= 2, f[tt], omf[tt])
    w = wts[tt, (kind - 1).clamp(min=0)]
    v = torch.where((kind == 0)[:, None], gcs[tt], (gcs[tt] * mix[:, None]) * w[:, None])
    src = torch.arange(T + plen, device=dev) - plen
    slot = torch.remainder(src + int(rows[0, 2]), plen)
    g = torch.zeros((T + plen, C), dtype=torch.float32, device=dev)
    final = src >= T - plen
    g[final] = g[final] + gpb.to(torch.float32)[slot[final]]
    rank = torch.arange(key.numel(), device=dev) - first[key]
    for r in range(int(count.max()) if key.numel() else 0):
        at = rank == r  # at most one reader a row
        g[key[at]] = g[key[at]] + v[at]
    gline = torch.empty_like(g)
    gline[torch.where(src >= 0, plen + src, slot)] = g
    return gline


def _slot(t, ws, i, plen):
    """Rows of ``[pitch_buf ; x]`` that hold pitch-line slot i at time t
    (write slot ws)."""
    src = t - (ws - i) % plen
    return torch.where(src >= 0, plen + src, i)


def _ratio_and_misc(gp, gmisc, T, smooth_alpha):
    """The ratio's and the misc row's cotangents from p_rpos's per sample
    (gp, (T,)): p_rpos after sample t is the entering one plus the ratios
    up to t, so the ratio's is a reverse cumulative sum; the smoothed
    length passes (1 - alpha) a sample to the entering one."""
    g_rpos = gmisc[2].to(torch.float32)
    after = torch.flip(torch.cumsum(torch.flip(gp, (0,)), 0), (0,))  # sum over s >= t
    gratio = torch.cat([after[1:], after.new_zeros(1)]) + g_rpos
    gm = torch.zeros(len(MISC_FIELDS), dtype=torch.float32, device=gp.device)
    gm[2] = after[0] + g_rpos
    gm[5] = gmisc[5].to(torch.float32) * float((1.0 - smooth_alpha) ** T)
    return gratio, gm


# csrc/reverse_echo_scan_bwd.cu's echo_ratio: rows of 1024 samples, 32
# warps of 32 lanes
_RATIO_ROW, _WARP = 1024, 32


def _suffix_sums(v):
    """Each warp's suffix sums along the last axis (32 lanes), as the
    kernel's shuffles add them: v[l] += v[l + d], d = 1, 2, 4, 8, 16."""
    for d in (1, 2, 4, 8, 16):
        nv = v.clone()
        nv[..., :-d] = v[..., :-d] + v[..., d:]
        v = nv
    return v


def _ratio_and_misc_rows(gp, gmisc, T, smooth_alpha):
    """:func:`_ratio_and_misc` in the order of the kernel's echo_ratio (the
    same result, rounded as the kernel's): the sums over s >= t row by row
    from the end (rows of 1024 samples, zeros before t = 0), each row's
    warps' suffix sums, the warps' totals' suffix sums, and each sample's
    sum its warp's plus (the carry from the later rows plus the later
    warps' totals)."""
    dev = gp.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    carry = zero
    after = torch.empty(T, dtype=torch.float32, device=dev)
    for r_end in range(T, 0, -_RATIO_ROW):
        t = r_end - _RATIO_ROW + torch.arange(_RATIO_ROW, device=dev)
        v = torch.where(t >= 0, gp[t.clamp(min=0)], zero).view(_WARP, _WARP)
        u = _suffix_sums(v)
        tv = _suffix_sums(u[:, 0])
        off = torch.cat([carry + tv[1:], carry.reshape(1)])
        row = (u + off[:, None]).flatten()
        after[t[t >= 0]] = row[t >= 0]
        carry = carry + tv[0]
    g_rpos = gmisc[2].to(torch.float32)
    gratio = torch.cat([after[1:] + g_rpos, (zero + g_rpos).reshape(1)])
    gm = torch.zeros(len(MISC_FIELDS), dtype=torch.float32, device=dev)
    gm[2] = after[0] + g_rpos
    gm[5] = gmisc[5].to(torch.float32) * float((1.0 - smooth_alpha) ** T)
    return gratio, gm


def reverse_echo_scan_bwd(x, blk, ratio, fb, alt, pitch_buf, misc, y, gy, gbuf_a, gbuf_b,
                          gpb, gmisc, residuals=None, *, sr, plen, cap, min_block, max_block,
                          smooth_alpha):
    """The cotangents of :func:`reverse_echo_scan`'s inputs: given its
    arguments but the two block buffers (which the forward overwrote), its
    output ``y``, the cotangents of y (T, C), buf_a', buf_b' (cap, C),
    pitch_buf' (plen, C) and misc' (9,), and the forward launch's control
    results ``residuals``, (tab, bounds, n_periods) as ``_launch`` returns
    them (the kernel needs them; the plain version does not read them),
    returns (gx (T, C), gratio (T,), gfb (T,), gbuf_a, gbuf_b (cap, C),
    gpitch_buf (plen, C), gmisc (9,)). The block length and the
    alternation get none (roundings and compares). CPU tensors take the
    plain version; CUDA tensors launch the kernel (one count in
    ``reverse_echo_scan_bwd.launches`` per call, which is two copies and
    six launches: the readers' index, the period walk, the gather, two
    channel sums, the ratio's sum) or raise."""
    kw = dict(sr=sr, plen=plen, cap=cap, min_block=min_block, max_block=max_block,
              smooth_alpha=smooth_alpha)
    args = (x, blk, ratio, fb, alt, pitch_buf, misc, y, gy, gbuf_a, gbuf_b, gpb, gmisc)
    if x.device.type == "cpu":
        return reverse_echo_scan_bwd_ref(*args, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if residuals is None:
        raise ValueError("reverse_echo_scan_bwd on the card needs the control results of the "
                         "forward launch")
    return _launch_bwd(*args, *residuals, **kw)


reverse_echo_scan_bwd.launches = 0


def reverse_echo_scan_bwd_ref(x, blk, ratio, fb, alt, pitch_buf, misc, y, gy, gbuf_a, gbuf_b,
                              gpb, gmisc, residuals=None, *, sr, plen, cap, min_block,
                              max_block, smooth_alpha):
    """Plain PyTorch version of :func:`reverse_echo_scan_bwd` (the
    residuals are not read): the control table, the pitch line's final
    cotangent, then the periods in reverse, each period's samples together
    (a period writes distinct rows of one buffer and reads distinct rows of
    the other): the written rows' cotangents taken (and cleared), the
    replayed rows' added, the taps' added to the line ``[pitch_buf ; x]``."""
    dev = x.device
    with torch.no_grad():
        steps, _ = _control(blk, ratio, alt, misc, sr=sr, plen=plen, cap=cap,
                            min_block=min_block, max_block=max_block,
                            smooth_alpha=smooth_alpha)
    tb = _table(steps, dev)
    T, C = x.shape
    inv_half = float(torch.tensor(1.0 / (plen / 2.0), dtype=torch.float32))
    x, y, gy, fb = (v.to(torch.float32) for v in (x, y, gy, fb))
    lam_a, lam_b = gbuf_a.to(torch.float32).clone(), gbuf_b.to(torch.float32).clone()
    line = torch.cat([pitch_buf.to(torch.float32), x])
    gline = torch.zeros_like(line)
    last = torch.full((plen,), T - 1, device=dev)
    gline[_slot(last, tb["wslot"][-1], torch.arange(plen, device=dev), plen)] += gpb
    gfb = torch.zeros(T, dtype=torch.float32, device=dev)
    gp = torch.zeros(T, dtype=torch.float32, device=dev)
    starts = tb["starts"]
    for a, b in reversed(list(zip(starts[:-1], starts[1:]))):
        t = torch.arange(a, b, device=dev)
        cur, prev = (lam_a, lam_b) if tb["write_a"][a] else (lam_b, lam_a)
        wrow, rrow = tb["wrow"][a:b], tb["rrow"][a:b]
        gc = cur[wrow].clone()
        cur[wrow] = 0.0
        play = rrow >= 0
        gwet = gy[a:b] + gc * fb[a:b, None]
        prev.index_add_(0, rrow[play], (gwet * tb["window"][a:b, None])[play])
        gfb[a:b] = torch.where(play, (gc * y[a:b]).sum(1), 0.0)
        nu = tb["near_unity"][a:b]
        gline.index_add_(0, plen + t[nu], gc[nu])
        pitched = ~nu
        ws = tb["wslot"][a:b]
        rows = [_slot(t, ws, tb["taps"][a:b, k], plen) for k in range(4)]
        p = [line[r] for r in rows]
        w = [tb["wts"][a:b, k, None] for k in range(4)]
        gs1, gs2 = gc * tb["f"][a:b, None], gc * tb["omf"][a:b, None]
        for r, gk in zip(rows, (gs1 * w[0], gs1 * w[1], gs2 * w[2], gs2 * w[3])):
            gline.index_add_(0, r[pitched], gk[pitched])
        s1 = w[0] * p[0] + w[1] * p[1]
        s2 = w[2] * p[2] + w[3] * p[3]
        gpos = (gs1 * (p[1] - p[0]) + gs2 * (p[3] - p[2])
                + gc * (s1 - s2) * inv_half * tb["sgn"][a:b, None])
        gp[a:b] = torch.where(pitched, gpos.sum(1), 0.0)
    gratio, gm = _ratio_and_misc(gp, gmisc, T, smooth_alpha)
    return gline[plen:], gratio, gfb, lam_a, lam_b, gline[:plen], gm


def reverse_echo_scan_bwd_periods(x, blk, ratio, fb, alt, pitch_buf, misc, y, gy, gbuf_a,
                                  gbuf_b, gpb, gmisc, residuals=None, *, sr, plen, cap,
                                  min_block, max_block, smooth_alpha):
    """:func:`reverse_echo_scan_bwd` in the kernel's order and roundings
    (same arguments and result), equal to the kernel bit for bit on the
    same ``residuals`` (default: ``echo_control_ref``'s):

    1. the periods in reverse, each period's samples and channels at once:
       gc taken from the written row (which is cleared) and kept; where
       replaying, the replayed row's cotangent fma(fma(gc, fb, gy),
       window, row) and the feedback's part gc y; the read position's part
       from the four taps (0 near unity);
    2. the pitch line's cotangent by :func:`echo_gather`;
    3. the two parts summed over the channels in channel order;
    4. the ratio's and misc's cotangents by :func:`_ratio_and_misc_rows`."""
    kw = dict(sr=sr, plen=plen, cap=cap, min_block=min_block, max_block=max_block,
              smooth_alpha=smooth_alpha)
    if residuals is None:
        residuals = echo_control_ref(blk, ratio, alt, misc, **kw)
    tab, bounds, n_periods = residuals
    T, C = x.shape
    taps, wts, f, omf, window, sgn, rows = _decode(tab)
    inv_half = float(torch.tensor(1.0 / (plen / 2.0), dtype=torch.float32))
    x, y, gy, fb = (v.to(torch.float32) for v in (x, y, gy, fb))
    lam_a, lam_b = gbuf_a.to(torch.float32).clone(), gbuf_b.to(torch.float32).clone()
    line = torch.cat([pitch_buf.to(torch.float32), x])
    gcs, gfb_part, gp_part = (torch.zeros_like(x) for _ in range(3))
    n = int(n_periods.reshape(-1)[0])
    starts = bounds[:n + 1].tolist()
    for a, b in reversed(list(zip(starts[:-1], starts[1:]))):
        t = torch.arange(a, b, device=x.device)
        cur, prev = (lam_a, lam_b) if int(rows[a, 3]) & CUR_IS_A else (lam_b, lam_a)
        wrow, rrow = rows[a:b, 1], rows[a:b, 0]
        gc = cur[wrow].clone()
        cur[wrow] = 0.0
        gcs[a:b] = gc
        play = rrow >= 0
        rr = rrow[play]
        gwet = fmaf(gc[play], fb[a:b, None][play], gy[a:b][play])
        prev[rr] = fmaf(gwet, window[a:b, None][play], prev[rr])
        gfb_part[a:b] = torch.where(play[:, None], gc * y[a:b], 0.0)
        ws = rows[a:b, 2]
        p = [line[_slot(t, ws, taps[a:b, k], plen)] for k in range(4)]
        w = [wts[a:b, k, None] for k in range(4)]
        gs1, gs2 = gc * f[a:b, None], gc * omf[a:b, None]
        s1 = w[0] * p[0] + w[1] * p[1]
        s2 = w[2] * p[2] + w[3] * p[3]
        gpos = ((gs1 * (p[1] - p[0]) + gs2 * (p[3] - p[2]))
                + ((gc * (s1 - s2)) * inv_half) * sgn[a:b, None])
        near = (rows[a:b, 3] & NEAR_UNITY) != 0
        gp_part[a:b] = torch.where(near[:, None], 0.0, gpos)
    gline = echo_gather(gcs, tab, bounds, n_periods, gpb)
    gfb = torch.zeros(T, dtype=torch.float32, device=x.device)
    gp = torch.zeros(T, dtype=torch.float32, device=x.device)
    for c in range(C):  # csrc/channel_sum.cuh's order
        gfb = gfb + gfb_part[:, c]
        gp = gp + gp_part[:, c]
    gratio, gm = _ratio_and_misc_rows(gp, gmisc, T, smooth_alpha)
    return gline[plen:], gratio, gfb, lam_a, lam_b, gline[:plen], gm


def reverse_echo_scan(x, blk, ratio, fb, alt, buf_a, buf_b, pitch_buf, misc, *,
                      sr, plen, cap, min_block, max_block, smooth_alpha):
    """Reverse pitch echo over T samples and C channels.

    x: (T, C) f32; blk/ratio/fb/alt: (T,) f32 (fb pre-clipped, ratio
    pre-floored); buf_a/buf_b: (cap, C) f32; pitch_buf: (plen, C) f32;
    misc: (9,) f32 in MISC_FIELDS order. Returns (wet (T, C), buf_a',
    buf_b', pitch_buf', misc'). CPU tensors take the plain version; CUDA
    tensors launch the kernel (one count in ``reverse_echo_scan.launches``
    per call, which is two launches: the control pass and the audio pass)
    or raise. On the card buf_a and buf_b are consumed: the kernel updates
    them in place and returns them as buf_a' and buf_b'.
    """
    kw = dict(sr=sr, plen=plen, cap=cap, min_block=min_block, max_block=max_block,
              smooth_alpha=smooth_alpha)
    args = (x, blk, ratio, fb, alt, buf_a, buf_b, pitch_buf, misc)
    if x.device.type == "cpu" and not diffable.transformed(blk, ratio, alt, misc):
        return reverse_echo_scan_ref(*args, **kw)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    # the launch; on the CPU under torch.func (the plain control pass reads
    # blk, ratio, alt and misc on the host) the plain version by the same rule
    return _differentiable(*args, **kw)[:5]


reverse_echo_scan.launches = 0


def _launch(x, blk, ratio, fb, alt, buf_a, buf_b, pitch_buf, misc, *, sr, plen,
            cap, min_block, max_block, smooth_alpha, residuals=False):
    """The kernel's two passes: (y, buf_a', buf_b', pitch_buf', misc'),
    and with ``residuals`` its control results too, (tab, bounds,
    n_periods), else scratch."""
    dev = x.device
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1 or plen < 2 or cap < 2:
        raise ValueError(f"unsupported shape x={tuple(x.shape)} plen={plen} cap={cap}")
    if not 1 <= min_block <= max_block <= cap - 1:
        # a period writes rows 0 .. block - 1 of the current buffer, each once
        raise ValueError(f"need 1 <= min_block <= max_block <= cap - 1, got "
                         f"{min_block}, {max_block}, cap={cap}")
    T, C = x.shape
    x = _ext.checked(x, "x", (T, C), dev)
    blk, ratio, fb, alt = (_ext.checked(v, name, (T,), dev) for v, name in
                           ((blk, "blk"), (ratio, "ratio"), (fb, "fb"), (alt, "alt")))
    ba = _ext.checked(buf_a, "buf_a", (cap, C), dev)  # updated in place
    bb = _ext.checked(buf_b, "buf_b", (cap, C), dev)
    pitch_buf = _ext.checked(pitch_buf, "pitch_buf", (plen, C), dev)
    misc = _ext.checked(misc, "misc", (len(MISC_FIELDS),), dev)
    y = torch.empty((T, C), dtype=torch.float32, device=dev)
    pb_out = torch.empty((plen, C), dtype=torch.float32, device=dev)
    misc_out = torch.empty((len(MISC_FIELDS),), dtype=torch.float32, device=dev)
    # the control pass's per-sample table (16 words, csrc/reverse_echo_control.cuh's
    # Tab) and period bounds, read by the audio pass
    tab = torch.empty((T, 16), dtype=torch.int32, device=dev)
    bounds = torch.empty((T + 1,), dtype=torch.int32, device=dev)
    n_periods = torch.empty((1,), dtype=torch.int32, device=dev)
    half = plen / 2.0
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.reverse_echo_scan_launch(
            x.data_ptr(), blk.data_ptr(), ratio.data_ptr(), fb.data_ptr(),
            alt.data_ptr(), ba.data_ptr(), bb.data_ptr(), pitch_buf.data_ptr(),
            misc.data_ptr(), y.data_ptr(), pb_out.data_ptr(), misc_out.data_ptr(),
            tab.data_ptr(), bounds.data_ptr(), n_periods.data_ptr(),
            T, C, float(sr), int(plen), int(cap), int(min_block), int(max_block),
            float(smooth_alpha), 1.0 / plen, half, 1.0 / half,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "reverse_echo_scan")
    reverse_echo_scan.launches += 1
    if residuals:
        return y, ba, bb, pb_out, misc_out, tab, bounds, n_periods
    return y, ba, bb, pb_out, misc_out


# csrc/reverse_echo_scan_bwd.cu's index: a CUDA block ranks the readers of
# 256 line rows, at most four a sample of the plen + 255 that may read them,
# which row of its each reads kept in shared memory (5 x 2 bytes a sample,
# at most 200 KB: a pitch line of sr / 60 up to a 1.2 MHz rate)
_TILE_ROWS = 256
_MAX_BWD_PLEN = 200 * 1024 // 10 - _TILE_ROWS + 1


def _launch_bwd(x, blk, ratio, fb, alt, pitch_buf, misc, y, gy, gbuf_a, gbuf_b, gpb, gmisc,
                tab, bounds, n_periods, *, sr, plen, cap, min_block, max_block, smooth_alpha):
    dev = x.device
    if (x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1 or not 2 <= plen <= _MAX_BWD_PLEN
            or cap < 2):
        raise ValueError(f"unsupported shape x={tuple(x.shape)} plen={plen} (the backward "
                         f"kernel's index takes plen up to {_MAX_BWD_PLEN}) cap={cap}")
    T, C = x.shape
    x, y, gy = (_ext.checked(v, n, (T, C), dev) for v, n in ((x, "x"), (y, "y"), (gy, "gy")))
    fb = _ext.checked(fb, "fb", (T,), dev)
    pitch_buf = _ext.checked(pitch_buf, "pitch_buf", (plen, C), dev)
    gpb = _ext.checked(gpb, "gpb", (plen, C), dev)
    gbuf_a = _ext.checked(gbuf_a, "gbuf_a", (cap, C), dev)
    gbuf_b = _ext.checked(gbuf_b, "gbuf_b", (cap, C), dev)
    gmisc = _ext.checked(gmisc, "gmisc", (len(MISC_FIELDS),), dev)
    for name, t, shape in (("tab", tab, (T, 16)), ("bounds", bounds, (T + 1,)),
                           ("n_periods", n_periods, (1,))):
        if t.dtype != torch.int32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape} on x's device")
    # the outputs, one allocation: the rings' cotangents (updated in place
    # from buf_a''s and buf_b''s), the line's, gfb, gratio, misc's
    n_line, n_ring = (plen + T) * C, cap * C
    out = torch.empty((2 * n_ring + n_line + 2 * T + len(MISC_FIELDS),), dtype=torch.float32,
                      device=dev)
    lam_a, lam_b = out[:n_ring].view(cap, C), out[n_ring:2 * n_ring].view(cap, C)
    gline = out[2 * n_ring:2 * n_ring + n_line].view(plen + T, C)
    gfb, gratio, gm = out[2 * n_ring + n_line:].split((T, T, len(MISC_FIELDS)))
    # scratch: each sample's gc and the two parts, p_rpos's cotangent; the
    # readers' index
    work = torch.empty((3 * T * C + T,), dtype=torch.float32, device=dev)
    tiles = -(-(T + plen) // _TILE_ROWS)
    tile_cap = 4 * (plen + _TILE_ROWS)
    index = torch.empty((2 * (T + plen) + tiles * tile_cap,), dtype=torch.int32, device=dev)
    f, i = work.data_ptr(), index.data_ptr()
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.reverse_echo_scan_bwd_launch(
            x.data_ptr(), fb.data_ptr(), y.data_ptr(), gy.data_ptr(),
            tab.contiguous().data_ptr(), bounds.contiguous().data_ptr(), n_periods.data_ptr(),
            gbuf_a.data_ptr(), gbuf_b.data_ptr(), gmisc.data_ptr(), lam_a.data_ptr(),
            lam_b.data_ptr(), pitch_buf.data_ptr(), gpb.data_ptr(), gline.data_ptr(),
            gfb.data_ptr(), gratio.data_ptr(), gm.data_ptr(), f + 12 * T * C, f,
            f + 4 * T * C, f + 8 * T * C, i, i + 4 * (T + plen), i + 8 * (T + plen), T, C, cap,
            int(plen), tile_cap, 1.0 / (plen / 2.0), float((1.0 - smooth_alpha) ** T),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "reverse_echo_scan_bwd")
    reverse_echo_scan_bwd.launches += 1
    return gline[plen:], gratio, gfb, lam_a, lam_b, gline[:plen], gm


def _backward(args, outs, grads, **kw):
    x, blk, ratio, fb, alt, _, _, pitch_buf, misc = args  # the rings: overwritten
    residuals = tuple(outs[5:8]) if len(outs) > 5 else None  # the launch's control results
    gx, gratio, gfb, gbuf_a, gbuf_b, gpitch, gm = reverse_echo_scan_bwd(
        x, blk, ratio, fb, alt, pitch_buf, misc, outs[0], *grads[:5], residuals, **kw)
    return gx, None, gratio, gfb, None, gbuf_a, gbuf_b, gpitch, gm


def _launch_recorded(*args, **kw):
    if not args[0].is_cuda:  # a call under torch.func on the CPU
        return reverse_echo_scan_ref(*args, **kw)
    return _launch(*args, **kw, residuals=True)


def _launch_untracked(*args, **kw):
    return (_launch if args[0].is_cuda else reverse_echo_scan_ref)(*args, **kw)


# the vmap layout: x, the rings and the pitch line carry the channels; the
# controls, the misc row and the control results are shared by them; the
# rings are updated in place
LAYOUT = dict(channels=(1, None, None, None, None, 1, 1, 1), out_channels=(1, 1, 1, 1),
              inplace=(5, 6))
# the launch as a torch.autograd.Function (the rings marked dirty, not
# saved; the control results kept), its backward reverse_echo_scan_bwd; a
# launch with no gradient (the launch alone) keeps no control results; on
# CPU tensors (a call under torch.func) the plain version stands in for the
# launch
_differentiable = diffable.kernel_function("reverse_echo_scan", _launch_recorded, _backward,
                                           untracked=_launch_untracked, **LAYOUT)
