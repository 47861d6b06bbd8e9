"""The feedback comb's per-sample recurrence over a ring buffer.

Counterpart of ``pygmu2_tpu.ops.comb_pallas``: one function,
``comb_scan``, takes the (T, C) input, (T,) frequency and feedback
columns, the (L, C) ring buffer, its write position and the smoothed
frequency, and returns the output and the three state pieces after the
last sample. Each sample: the frequency is smoothed by a one-pole, the
delay is round(sr / sf) clipped to [1, L-1], and
``y = x + fb * buf[pos - delay]`` is written at ``pos``.

- ``comb_scan`` is the wrapper. For CUDA tensors it launches the
  hand-written kernel in ``csrc/comb_scan.cu`` and counts the launch in
  ``comb_scan.launches``; for CPU tensors it runs the plain version.
- ``comb_scan_ref`` is the plain PyTorch version: a per-sample loop with
  the JAX package's ``comb_scan_ref`` op order, float32.
- ``comb_scan_windows`` computes the same in the kernel's order (tests
  only): the smoother alone, serially; every sample's delay from it;
  windows cut greedily so that no sample of a window reads a value the
  window writes; then each window's samples and channels at once.
- ``comb_scan_bwd_windows`` is the backward in its kernel's order (tests
  and ``chip_smoke.py`` only): the smoother's adjoint in
  ``csrc/order1_grid.cuh``'s order (``envelope.order1_adjoint_grid``), then
  the forward's windows walked from the last.

Differentiable: on the card the launch is a ``torch.autograd.Function``
(:mod:`~pygmu2_tpu_torch.ops.diffable`) whose backward is
``comb_scan_bwd``, the hand-written adjoint in ``csrc/comb_scan_bwd.cu``
(counted in ``comb_scan_bwd.launches``); on the CPU autograd
differentiates the plain version. ``comb_scan_bwd_ref`` is the backward's
plain version (autograd of ``comb_scan_ref``). The forward launch returns
its control pass's results too (the delays, the windows, the smoothed
values): the Function keeps them as residuals, and the backward kernel
runs no control pass of its own.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable
from pygmu2_tpu_torch.ops.envelope import GRID_ROWS, order1_adjoint_grid


def comb_scan_ref(x, freq, fb, buf, pos, sf, *, L, sr, smooth_alpha):
    """Plain PyTorch version of :func:`comb_scan` (same arguments and
    result). A Python loop over samples: keep T small."""
    dev = x.device
    functional = diffable.transformed(x, freq, fb, buf, sf)  # under torch.func
    buf = buf.clone()
    p = int(pos)  # the write position advances by one per sample
    sf = torch.as_tensor(sf, dtype=torch.float32, device=dev).reshape(())
    sr32 = torch.tensor(sr, dtype=torch.float32, device=dev)
    ys = []
    for xi, fi, fbi in zip(x, freq, fb):
        sf = torch.where(sf < 0.0, fi, sf + (fi - sf) * smooth_alpha)
        delay = torch.round(sr32 / sf.clamp(min=1.0)).to(torch.int32).clamp(1, L - 1)
        read = torch.remainder(p - delay + L, L).long()
        out = xi + fbi * buf[read].clone()  # a copy: buf changes in place below
        buf = diffable.put_row(buf, p, out, functional)
        p = (p + 1) % L
        ys.append(out)
    pos_out = torch.tensor(p, dtype=torch.int32, device=dev)
    return torch.stack(ys), buf, pos_out, sf


def comb_control_ref(freq, sf, *, L, sr, smooth_alpha):
    """The kernel's control pass in torch ops: (the smoothed values (T,),
    the delays (T,) int32, the windows' bounds [0, ..., T] as a list).
    Only the smoother is serial. The windows are cut greedily: one that
    starts at t0 runs to the first t with t - delay[t] >= t0, so each of
    its samples reads a value written before it."""
    dev = freq.device
    sf = torch.as_tensor(sf, dtype=torch.float32, device=dev).reshape(())
    sfs = []
    for fi in freq.tolist():
        sf = torch.where(sf < 0.0, fi, sf + (fi - sf) * smooth_alpha)
        sfs.append(sf)
    sr32 = torch.tensor(sr, dtype=torch.float32, device=dev)
    smoothed = torch.stack(sfs) if sfs else torch.zeros((0,), device=dev)
    delay = torch.round(sr32 / smoothed.clamp(min=1.0)).to(torch.int32).clamp(1, L - 1)
    bounds, t0 = [0], 0
    for t, d in enumerate(delay.tolist()):
        if t - d >= t0:
            bounds.append(t)
            t0 = t
    bounds.append(freq.shape[0])
    return smoothed, delay, bounds


def comb_scan_windows(x, freq, fb, buf, pos, sf, *, L, sr, smooth_alpha):
    """:func:`comb_scan_ref` in the kernel's order (same arguments and
    result, equal bit for bit)."""
    dev = x.device
    T = x.shape[0]
    smoothed, delay, bounds = comb_control_ref(freq, sf, L=L, sr=sr, smooth_alpha=smooth_alpha)
    sf = smoothed[-1] if T else torch.as_tensor(sf, dtype=torch.float32, device=dev).reshape(())
    # the tape: Y[q] = buf[(p0 + q) % L] for q < L, Y[L + t] = y[t]; sample t
    # reads Y[L + t - delay[t]]
    p0 = int(pos)
    tape = torch.cat([torch.roll(buf, -p0, dims=0), torch.empty_like(x)])
    src = torch.arange(T, device=dev) - delay + L
    for a, b in zip(bounds[:-1], bounds[1:]):
        tape[L + a:L + b] = x[a:b] + fb[a:b, None] * tape[src[a:b]]
    buf_out = torch.roll(tape[T:], (p0 + T) % L, dims=0)
    pos_out = torch.tensor((p0 + T) % L, dtype=torch.int32, device=dev)
    return tape[L:], buf_out, pos_out, sf


def comb_scan(x, freq, fb, buf, pos, sf, *, L, sr, smooth_alpha):
    """Feedback comb over T samples and C channels.

    x: (T, C) f32; freq/fb: (T,) f32; buf: (L, C) f32; pos: () int32;
    sf: () f32 (negative: not yet set). Returns (y (T, C), buf' (L, C),
    pos' () int32, sf' () f32). CPU tensors take the plain version; CUDA
    tensors launch the kernel (its two passes, one count in
    ``comb_scan.launches`` per call) or raise.
    """
    kw = dict(L=L, sr=sr, smooth_alpha=smooth_alpha)
    if x.device.type == "cpu":
        return comb_scan_ref(x, freq, fb, buf, pos, sf, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _differentiable(x, freq, fb, buf, pos, sf, **kw)[:4]


comb_scan.launches = 0


def comb_scan_bwd(x, freq, fb, buf, pos, sf, y, gy, gbuf, gsf, residuals=None, *, L, sr,
                  smooth_alpha):
    """The cotangents of :func:`comb_scan`'s float inputs.

    Takes the forward's arguments (the kernel reads fb, buf, pos and sf),
    its output ``y``, the cotangents ``gy`` (T, C), ``gbuf`` (L, C) and
    ``gsf`` () of its float outputs and the forward launch's control
    results ``residuals``, (delay, bounds, n_windows, smoothed) as
    ``_launch`` returns them (the kernel needs them; the plain version does
    not read them); returns (gx
    (T, C), gfreq (T,), gfb (T,), gbuf_in (L, C), gsf_in ()). CPU tensors
    take the plain version; CUDA tensors launch the kernel (one count in
    ``comb_scan_bwd.launches`` per call, which is three launches: the
    smoother's adjoint (after a memset of its flags), the window walk, the
    channel sum) or raise.
    """
    kw = dict(L=L, sr=sr, smooth_alpha=smooth_alpha)
    if y.device.type == "cpu":
        return comb_scan_bwd_ref(x, freq, fb, buf, pos, sf, y, gy, gbuf, gsf, **kw)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    if residuals is None:
        raise ValueError("comb_scan_bwd on the card needs the control results of the "
                         "forward launch")
    return _launch_bwd(fb, buf, pos, sf, y, gy, gbuf, gsf, *residuals, **kw)


comb_scan_bwd.launches = 0


def comb_scan_bwd_ref(x, freq, fb, buf, pos, sf, y, gy, gbuf, gsf, residuals=None, **kw):
    """Plain PyTorch version of :func:`comb_scan_bwd`: autograd of
    :func:`comb_scan_ref` (same arguments and result; the residuals are not
    read)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, freq, fb, buf)]
        sf_in = torch.as_tensor(sf, dtype=torch.float32, device=y.device).reshape(())
        sf_in = sf_in.detach().requires_grad_()
        y2, buf2, _, sf2 = comb_scan_ref(*ins, pos, sf_in, **kw)
        return torch.autograd.grad((y2, buf2, sf2), ins + [sf_in], (gy, gbuf, gsf.reshape(())),
                                   allow_unused=True, materialize_grads=True)


def comb_scan_bwd_windows(x, freq, fb, buf, pos, sf, y, gy, gbuf, gsf, residuals=None, *, L,
                          sr, smooth_alpha):
    """:func:`comb_scan_bwd` in the kernel's order (same arguments and
    result; the control pass recomputed by :func:`comb_control_ref`), in
    torch ops rounded as the kernel's, equal to it bit for bit:

    1. the smoother's adjoint by ``envelope.order1_adjoint_grid`` at one
       channel, its coefficient 1 where the select took f, else alpha, its
       only cotangent gsf's;
    2. the tape's cotangent G (gy on y's rows, plus gbuf where a row ends in
       the ring) walked back window by window, the last first: each
       sample's row is complete when its window is reached; a window's
       adds G[src] += fb * G go into earlier rows, each row taking its adds
       in decreasing t;
    3. the feedback's per-channel parts summed in channel order."""
    dev = y.device
    T, C = y.shape
    smoothed, delay, bounds = comb_control_ref(freq, sf, L=L, sr=sr, smooth_alpha=smooth_alpha)
    sf0 = torch.as_tensor(sf, dtype=torch.float32, device=dev).reshape(())
    prev = torch.cat([sf0.reshape(1), smoothed[:-1]])
    k = torch.where(prev < 0.0, torch.ones((), device=dev),
                    torch.full((), smooth_alpha, dtype=torch.float32, device=dev))
    gfreq, gsf_in = order1_adjoint_grid(k[:, None], torch.zeros((T, 1), device=dev),
                                        gsf.reshape(1))
    gfreq, gsf_in = gfreq[:, 0], gsf_in.reshape(())

    p0 = int(pos)
    G = torch.cat([torch.zeros((L, C), dtype=torch.float32, device=dev), gy])
    rows = torch.arange(L + T, device=dev)
    tail = rows >= T
    G[tail] = G[tail] + gbuf[(p0 + rows[tail]) % L]
    tape = torch.cat([torch.roll(buf, -p0, dims=0), y])
    src = torch.arange(T, device=dev) - delay.long() + L
    gx = torch.empty_like(y)
    part = torch.empty_like(y)
    for a, b in reversed(list(zip(bounds[:-1], bounds[1:]))):
        g = G[L + a:L + b].clone()
        gx[a:b] = g
        part[a:b] = g * tape[src[a:b]]
        adds = fb[a:b, None] * g
        s = src[a:b]
        if len(set(s.tolist())) == b - a:  # every row one add
            G[s] = G[s] + adds
        else:
            for t in reversed(range(b - a)):
                G[s[t]] = G[s[t]] + adds[t]
    gfb = torch.zeros(T, dtype=torch.float32, device=dev)
    for c in range(C):  # csrc/channel_sum.cuh's order
        gfb = gfb + part[:, c]
    return gx, gfreq, gfb, torch.roll(G[:L], p0, dims=0), gsf_in


def _launch(x, freq, fb, buf, pos, sf, *, L, sr, smooth_alpha):
    """The kernel's two passes: (y, buf_out, pos_out, sf_out) and the
    control pass's results (delay, bounds, n_windows, smoothed)."""
    dev = x.device
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1 or L < 2:
        raise ValueError(f"unsupported shape x={tuple(x.shape)} L={L}")
    T, C = x.shape
    x = _ext.checked(x, "x", (T, C), dev)
    freq = _ext.checked(freq, "freq", (T,), dev)
    fb = _ext.checked(fb, "fb", (T,), dev)
    buf = _ext.checked(buf, "buf", (L, C), dev)
    sf = _ext.checked(sf.reshape(()), "sf", (), dev)
    pos = pos.reshape(())
    if pos.dtype != torch.int32 or pos.device != dev:
        raise ValueError("pos must be an int32 scalar tensor on x's device")
    y = torch.empty((T, C), dtype=torch.float32, device=dev)
    buf_out = torch.empty((L, C), dtype=torch.float32, device=dev)
    pos_out = torch.empty((), dtype=torch.int32, device=dev)
    sf_out = torch.empty((), dtype=torch.float32, device=dev)
    # the control pass's per-sample delays, window starts and smoothed values
    delay = torch.empty((T,), dtype=torch.int32, device=dev)
    bounds = torch.empty((T + 1,), dtype=torch.int32, device=dev)
    n_windows = torch.empty((1,), dtype=torch.int32, device=dev)
    smoothed = torch.empty((T,), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.comb_scan_launch(
            x.data_ptr(), freq.data_ptr(), fb.data_ptr(), buf.data_ptr(),
            pos.data_ptr(), sf.data_ptr(), y.data_ptr(), buf_out.data_ptr(),
            pos_out.data_ptr(), sf_out.data_ptr(), delay.data_ptr(), bounds.data_ptr(),
            n_windows.data_ptr(), smoothed.data_ptr(), T, C, L, float(sr),
            float(smooth_alpha), torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "comb_scan")
    comb_scan.launches += 1
    return y, buf_out, pos_out, sf_out, delay, bounds, n_windows, smoothed


# the walk keeps 2L rows of G a channel in shared memory, at most 227 KB a
# CUDA block (csrc/comb_scan_bwd.cu); past that, in device memory
_MAX_SHARED = 232448


def _launch_bwd(fb, buf, pos, sf, y, gy, gbuf, gsf, delay, bounds, n_windows, smoothed, *, L,
                sr, smooth_alpha):
    dev = y.device
    if y.dim() != 2 or y.shape[0] < 1 or y.shape[1] < 1 or L < 2:
        raise ValueError(f"unsupported shape y={tuple(y.shape)} L={L}")
    T, C = y.shape
    fb = _ext.checked(fb, "fb", (T,), dev)
    buf = _ext.checked(buf, "buf", (L, C), dev)
    sf = _ext.checked(sf.reshape(()), "sf", (), dev)
    y = _ext.checked(y, "y", (T, C), dev)
    gy = _ext.checked(gy, "gy", (T, C), dev)
    gbuf = _ext.checked(gbuf, "gbuf", (L, C), dev)
    gsf = _ext.checked(gsf.reshape(()), "gsf", (), dev)
    smoothed = _ext.checked(smoothed, "smoothed", (T,), dev)
    pos = pos.reshape(())
    for name, t, shape in (("pos", pos, ()), ("delay", delay, (T,)), ("bounds", bounds, (T + 1,)),
                           ("n_windows", n_windows, (1,))):
        if t.dtype != torch.int32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape} on y's device")
    gx = torch.empty((T, C), dtype=torch.float32, device=dev)
    gfreq = torch.empty((T,), dtype=torch.float32, device=dev)
    gfb = torch.empty((T,), dtype=torch.float32, device=dev)
    gbuf_in = torch.empty((L, C), dtype=torch.float32, device=dev)
    gsf_in = torch.empty((), dtype=torch.float32, device=dev)
    # scratch: the feedback's per-channel parts; G's ring where 2L rows of
    # one channel exceed the shared memory
    part = torch.empty((T, C), dtype=torch.float32, device=dev)
    ring = (torch.empty((C, 2 * L), dtype=torch.float32, device=dev)
            if 2 * L * 4 > _MAX_SHARED else None)
    # the smoother's adjoint: its chunks' maps, and its ticket and flags
    # (zeroed by the launch)
    chunks = -(-T // GRID_ROWS)
    agg = torch.empty((2, chunks), dtype=torch.float32, device=dev)
    flags = torch.empty((1 + chunks,), dtype=torch.int32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.comb_scan_bwd_launch(
            fb.data_ptr(), buf.data_ptr(), pos.data_ptr(), sf.data_ptr(), y.data_ptr(),
            gy.data_ptr(), gbuf.data_ptr(), gsf.data_ptr(), delay.contiguous().data_ptr(),
            bounds.contiguous().data_ptr(), n_windows.data_ptr(), smoothed.data_ptr(),
            gx.data_ptr(), gfreq.data_ptr(), gfb.data_ptr(), gbuf_in.data_ptr(),
            gsf_in.data_ptr(), part.data_ptr(), None if ring is None else ring.data_ptr(),
            agg.data_ptr(), flags.data_ptr(), T, C, L, float(smooth_alpha),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "comb_scan_bwd")
    comb_scan_bwd.launches += 1
    return gx, gfreq, gfb, gbuf_in, gsf_in


def _backward(args, outs, grads, **kw):
    x, freq, fb, buf, pos, sf = args
    gy, gbuf, _, gsf = grads[:4]
    residuals = tuple(outs[4:8]) if len(outs) > 4 else None  # the launch's control results
    gx, gfreq, gfb, gbuf_in, gsf_in = comb_scan_bwd(x, freq, fb, buf, pos, sf, outs[0], gy, gbuf,
                                                    gsf, residuals, **kw)
    return gx, gfreq, gfb, gbuf_in, None, gsf_in.reshape(sf.shape)


# the vmap layout: x and the ring carry the channels; freq, fb, the write
# position, the smoother and the control pass's results are shared by them
LAYOUT = dict(channels=(1, None, None, 1), out_channels=(1, 1))
# the launch as a torch.autograd.Function, its backward comb_scan_bwd
_differentiable = diffable.kernel_function("comb_scan", _launch, _backward, **LAYOUT)
