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

Differentiable: on the card the launch is a ``torch.autograd.Function``
(:mod:`~pygmu2_tpu_torch.ops.diffable`) whose backward is
``comb_scan_bwd``, the hand-written adjoint in ``csrc/comb_scan_bwd.cu``
(counted in ``comb_scan_bwd.launches``); on the CPU autograd
differentiates the plain version. ``comb_scan_bwd_ref`` is the backward's
plain version (autograd of ``comb_scan_ref``).
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable


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


def comb_scan_windows(x, freq, fb, buf, pos, sf, *, L, sr, smooth_alpha):
    """:func:`comb_scan_ref` in the kernel's order (same arguments and
    result, equal bit for bit)."""
    dev = x.device
    T = x.shape[0]
    # the control pass: only the smoother is serial
    sf = torch.as_tensor(sf, dtype=torch.float32, device=dev).reshape(())
    sfs = []
    for fi in freq.tolist():
        sf = torch.where(sf < 0.0, fi, sf + (fi - sf) * smooth_alpha)
        sfs.append(sf)
    sr32 = torch.tensor(sr, dtype=torch.float32, device=dev)
    smoothed = torch.stack(sfs) if sfs else torch.zeros((0,), device=dev)
    delay = torch.round(sr32 / smoothed.clamp(min=1.0)).to(torch.int32).clamp(1, L - 1)
    # the tape: Y[q] = buf[(p0 + q) % L] for q < L, Y[L + t] = y[t]; sample t
    # reads Y[L + t - delay[t]]
    p0 = int(pos)
    tape = torch.cat([torch.roll(buf, -p0, dims=0), torch.empty_like(x)])
    src = torch.arange(T, device=dev) - delay + L
    # greedy windows: one that starts at t0 runs to the first t with
    # t - delay[t] >= t0, so each of its samples reads a value written before it
    bounds, t0 = [0], 0
    for t, d in enumerate(delay.tolist()):
        if t - d >= t0:
            bounds.append(t)
            t0 = t
    bounds.append(T)
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
    return _differentiable(x, freq, fb, buf, pos, sf, **kw)


comb_scan.launches = 0


def comb_scan_bwd(x, freq, fb, buf, pos, sf, y, gy, gbuf, gsf, *, L, sr, smooth_alpha):
    """The cotangents of :func:`comb_scan`'s float inputs.

    Takes the forward's arguments (the kernel reads all but ``x``) and its
    output ``y``, and the cotangents ``gy`` (T, C), ``gbuf`` (L, C) and ``gsf`` () of
    its float outputs; returns (gx (T, C), gfreq (T,), gfb (T,), gbuf_in
    (L, C), gsf_in ()). CPU tensors take the plain version; CUDA tensors
    launch the kernel (one count in ``comb_scan_bwd.launches`` per call,
    which is three launches: the control pass, the walk, the channel sum)
    or raise.
    """
    kw = dict(L=L, sr=sr, smooth_alpha=smooth_alpha)
    if y.device.type == "cpu":
        return comb_scan_bwd_ref(x, freq, fb, buf, pos, sf, y, gy, gbuf, gsf, **kw)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    return _launch_bwd(x, freq, fb, buf, pos, sf, y, gy, gbuf, gsf, **kw)


comb_scan_bwd.launches = 0


def comb_scan_bwd_ref(x, freq, fb, buf, pos, sf, y, gy, gbuf, gsf, **kw):
    """Plain PyTorch version of :func:`comb_scan_bwd`: autograd of
    :func:`comb_scan_ref` (same arguments and result)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, freq, fb, buf)]
        sf_in = torch.as_tensor(sf, dtype=torch.float32, device=y.device).reshape(())
        sf_in = sf_in.detach().requires_grad_()
        y2, buf2, _, sf2 = comb_scan_ref(*ins, pos, sf_in, **kw)
        return torch.autograd.grad((y2, buf2, sf2), ins + [sf_in], (gy, gbuf, gsf.reshape(())),
                                   allow_unused=True, materialize_grads=True)


def _launch(x, freq, fb, buf, pos, sf, *, L, sr, smooth_alpha):
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
    # scratch: the control pass's per-sample delays and window starts
    delay = torch.empty((T,), dtype=torch.int32, device=dev)
    bounds = torch.empty((T + 1,), dtype=torch.int32, device=dev)
    n_windows = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.comb_scan_launch(
            x.data_ptr(), freq.data_ptr(), fb.data_ptr(), buf.data_ptr(),
            pos.data_ptr(), sf.data_ptr(), y.data_ptr(), buf_out.data_ptr(),
            pos_out.data_ptr(), sf_out.data_ptr(), delay.data_ptr(), bounds.data_ptr(),
            n_windows.data_ptr(), T, C, L, float(sr),
            float(smooth_alpha), torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "comb_scan")
    comb_scan.launches += 1
    return y, buf_out, pos_out, sf_out


def _launch_bwd(x, freq, fb, buf, pos, sf, y, gy, gbuf, gsf, *, L, sr, smooth_alpha):
    dev = y.device
    if y.dim() != 2 or y.shape[0] < 1 or y.shape[1] < 1 or L < 2:
        raise ValueError(f"unsupported shape y={tuple(y.shape)} L={L}")
    T, C = y.shape
    freq = _ext.checked(freq, "freq", (T,), dev)
    fb = _ext.checked(fb, "fb", (T,), dev)
    buf = _ext.checked(buf, "buf", (L, C), dev)
    sf = _ext.checked(sf.reshape(()), "sf", (), dev)
    y = _ext.checked(y, "y", (T, C), dev)
    gy = _ext.checked(gy, "gy", (T, C), dev)
    gbuf = _ext.checked(gbuf, "gbuf", (L, C), dev)
    gsf = _ext.checked(gsf.reshape(()), "gsf", (), dev)
    pos = pos.reshape(())
    if pos.dtype != torch.int32 or pos.device != dev:
        raise ValueError("pos must be an int32 scalar tensor on y's device")
    gx = torch.empty((T, C), dtype=torch.float32, device=dev)
    gfreq = torch.empty((T,), dtype=torch.float32, device=dev)
    gfb = torch.empty((T,), dtype=torch.float32, device=dev)
    gbuf_in = torch.empty((L, C), dtype=torch.float32, device=dev)
    gsf_in = torch.empty((), dtype=torch.float32, device=dev)
    # scratch: the delays, the smoother's entering values, the tape's
    # cotangent, the feedback's per-channel parts
    delay = torch.empty((T,), dtype=torch.int32, device=dev)
    sf_prev = torch.empty((T,), dtype=torch.float32, device=dev)
    G = torch.empty((L + T, C), dtype=torch.float32, device=dev)
    part = torch.empty((T, C), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.comb_scan_bwd_launch(
            freq.data_ptr(), fb.data_ptr(), buf.data_ptr(), pos.data_ptr(), sf.data_ptr(),
            y.data_ptr(), gy.data_ptr(), gbuf.data_ptr(), gsf.data_ptr(), gx.data_ptr(),
            gfreq.data_ptr(), gfb.data_ptr(), gbuf_in.data_ptr(), gsf_in.data_ptr(),
            delay.data_ptr(), sf_prev.data_ptr(), G.data_ptr(), part.data_ptr(), T, C, L,
            float(sr), float(smooth_alpha), torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "comb_scan_bwd")
    comb_scan_bwd.launches += 1
    return gx, gfreq, gfb, gbuf_in, gsf_in


def _backward(args, outs, grads, **kw):
    x, freq, fb, buf, pos, sf = args
    gy, gbuf, _, gsf = grads
    gx, gfreq, gfb, gbuf_in, gsf_in = comb_scan_bwd(x, freq, fb, buf, pos, sf, outs[0], gy, gbuf,
                                                    gsf, **kw)
    return gx, gfreq, gfb, gbuf_in, None, gsf_in.reshape(sf.shape)


# the vmap layout: x and the ring carry the channels; freq, fb, the write
# position and the smoother are shared by them
LAYOUT = dict(channels=(1, None, None, 1), out_channels=(1, 1))
# the launch as a torch.autograd.Function, its backward comb_scan_bwd
_differentiable = diffable.kernel_function("comb_scan", _launch, _backward, **LAYOUT)
