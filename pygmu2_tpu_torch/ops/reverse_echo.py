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
  in ``reverse_echo_scan_bwd.launches``); on the card
  ``reverse_echo_scan``'s gradient is that launch.
  ``reverse_echo_scan_bwd_ref`` is its plain version in the kernel's
  order: the periods in reverse, each in torch ops.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable

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


def reverse_echo_scan_bwd(x, blk, ratio, fb, alt, pitch_buf, misc, y, gy, gbuf_a, gbuf_b,
                          gpb, gmisc, *, sr, plen, cap, min_block, max_block, smooth_alpha):
    """The cotangents of :func:`reverse_echo_scan`'s inputs: given its
    arguments but the two block buffers (which the forward overwrote), its
    output ``y`` and the cotangents of y (T, C), buf_a', buf_b' (cap, C),
    pitch_buf' (plen, C) and misc' (9,), returns (gx (T, C), gratio (T,),
    gfb (T,), gbuf_a, gbuf_b (cap, C), gpitch_buf (plen, C), gmisc (9,)).
    The block length and the alternation get none (roundings and
    compares). CPU tensors take the plain version; CUDA tensors launch the
    kernel (one count in ``reverse_echo_scan_bwd.launches`` per call) or
    raise."""
    kw = dict(sr=sr, plen=plen, cap=cap, min_block=min_block, max_block=max_block,
              smooth_alpha=smooth_alpha)
    args = (x, blk, ratio, fb, alt, pitch_buf, misc, y, gy, gbuf_a, gbuf_b, gpb, gmisc)
    if x.device.type == "cpu":
        return reverse_echo_scan_bwd_ref(*args, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch_bwd(*args, **kw)


reverse_echo_scan_bwd.launches = 0


def reverse_echo_scan_bwd_ref(x, blk, ratio, fb, alt, pitch_buf, misc, y, gy, gbuf_a, gbuf_b,
                              gpb, gmisc, *, sr, plen, cap, min_block, max_block,
                              smooth_alpha):
    """Plain PyTorch version of :func:`reverse_echo_scan_bwd`, in the
    kernel's order: the control table, the pitch line's final cotangent,
    then the periods in reverse, each period's samples together (a period
    writes distinct rows of one buffer and reads distinct rows of the
    other): the written rows' cotangents taken (and cleared), the replayed
    rows' added, the taps' added to the line ``[pitch_buf ; x]``."""
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
    return _differentiable(*args, **kw)


reverse_echo_scan.launches = 0


def _launch(x, blk, ratio, fb, alt, buf_a, buf_b, pitch_buf, misc, *, sr, plen,
            cap, min_block, max_block, smooth_alpha):
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
    # scratch of the two passes: the per-sample table, the period bounds
    tab = torch.empty((T, 16), dtype=torch.float32, device=dev)
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
    return y, ba, bb, pb_out, misc_out


def _launch_bwd(x, blk, ratio, fb, alt, pitch_buf, misc, y, gy, gbuf_a, gbuf_b, gpb, gmisc,
                *, sr, plen, cap, min_block, max_block, smooth_alpha):
    dev = x.device
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1 or plen < 2 or cap < 2:
        raise ValueError(f"unsupported shape x={tuple(x.shape)} plen={plen} cap={cap}")
    T, C = x.shape
    x, y, gy = (_ext.checked(v, n, (T, C), dev) for v, n in ((x, "x"), (y, "y"), (gy, "gy")))
    blk, ratio, fb, alt = (_ext.checked(v, name, (T,), dev) for v, name in
                           ((blk, "blk"), (ratio, "ratio"), (fb, "fb"), (alt, "alt")))
    pitch_buf = _ext.checked(pitch_buf, "pitch_buf", (plen, C), dev)
    gpb = _ext.checked(gpb, "gpb", (plen, C), dev)
    misc = _ext.checked(misc, "misc", (len(MISC_FIELDS),), dev)
    # the rings' cotangents, updated in place from buf_a', buf_b''s to buf_a's, buf_b's
    lam_a = _ext.checked(gbuf_a, "gbuf_a", (cap, C), dev).clone()
    lam_b = _ext.checked(gbuf_b, "gbuf_b", (cap, C), dev).clone()
    gline = torch.zeros((plen + T, C), dtype=torch.float32, device=dev)
    gfb = torch.empty((T,), dtype=torch.float32, device=dev)
    gp = torch.empty((T,), dtype=torch.float32, device=dev)
    # scratch: the control pass's table, period bounds and misc; the parts
    tab = torch.empty((T, 16), dtype=torch.float32, device=dev)
    bounds = torch.empty((T + 1,), dtype=torch.int32, device=dev)
    n_periods = torch.empty((1,), dtype=torch.int32, device=dev)
    misc_out = torch.empty((len(MISC_FIELDS),), dtype=torch.float32, device=dev)
    gfb_part = torch.empty((T, C), dtype=torch.float32, device=dev)
    gp_part = torch.empty((T, C), dtype=torch.float32, device=dev)
    half = plen / 2.0
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.reverse_echo_scan_bwd_launch(
            x.data_ptr(), blk.data_ptr(), ratio.data_ptr(), fb.data_ptr(), alt.data_ptr(),
            pitch_buf.data_ptr(), misc.data_ptr(), y.data_ptr(), gy.data_ptr(),
            lam_a.data_ptr(), lam_b.data_ptr(), gpb.data_ptr(), gline.data_ptr(),
            gfb.data_ptr(), gp.data_ptr(), tab.data_ptr(), bounds.data_ptr(),
            n_periods.data_ptr(), misc_out.data_ptr(), gfb_part.data_ptr(), gp_part.data_ptr(),
            T, C, float(sr), int(plen), int(cap), int(min_block), int(max_block),
            float(smooth_alpha), 1.0 / plen, half, 1.0 / half,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "reverse_echo_scan_bwd")
    reverse_echo_scan_bwd.launches += 1
    gratio, gm = _ratio_and_misc(gp, gmisc, T, smooth_alpha)
    return gline[plen:], gratio, gfb, lam_a, lam_b, gline[:plen], gm


def _backward(args, outs, grads, **kw):
    x, blk, ratio, fb, alt, _, _, pitch_buf, misc = args  # the rings: overwritten
    gx, gratio, gfb, gbuf_a, gbuf_b, gpitch, gm = reverse_echo_scan_bwd(
        x, blk, ratio, fb, alt, pitch_buf, misc, outs[0], *grads, **kw)
    return gx, None, gratio, gfb, None, gbuf_a, gbuf_b, gpitch, gm


# the vmap layout: x, the rings and the pitch line carry the channels; the
# controls and the misc row are shared by them; the rings are updated in place
LAYOUT = dict(channels=(1, None, None, None, None, 1, 1, 1), out_channels=(1, 1, 1, 1),
              inplace=(5, 6))
# the launch as a torch.autograd.Function (the rings marked dirty, not
# saved), its backward reverse_echo_scan_bwd; on CPU tensors (a call under
# torch.func) the plain version stands in for the launch
_differentiable = diffable.kernel_function(
    "reverse_echo_scan",
    lambda *args, **kw: (_launch if args[0].is_cuda else reverse_echo_scan_ref)(*args, **kw),
    _backward, **LAYOUT)
