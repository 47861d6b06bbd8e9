"""The asymmetric attack/release envelope follower.

Counterpart of ``pygmu2_tpu.ops.envelope_pallas``: one function,
``envelope_ar_scan``, takes the (T, C) rectified input and the (C,)
carried envelope and returns the (T, C) envelope and its last row. Each
sample: the coefficient is ``atk`` where the input is above the
envelope, else ``rel``, and ``e = e + coeff * (x - e)``.

- ``envelope_ar_scan`` is the wrapper. For CUDA tensors it launches the
  hand-written kernel in ``csrc/envelope_ar_scan.cu`` and counts the
  launch in ``envelope_ar_scan.launches``; for CPU tensors it runs the
  plain version.
- ``envelope_ar_scan_ref`` is the plain PyTorch version: a per-sample
  loop with the JAX package's ``envelope_ar_scan_ref`` op order, float32,
  rounded as XLA's CPU program rounds it: the update is one fused
  multiply-add, ``e = fma(coeff, x - e, e)`` (``ops/xla_math.fmaf``).
- ``envelope_ar_scan_bwd`` is the backward: the cotangents of x and env0
  from those of the two outputs. For CUDA tensors it launches
  ``csrc/envelope_ar_scan_bwd.cu`` (counted in
  ``envelope_ar_scan_bwd.launches``); on the card ``envelope_ar_scan``'s
  gradient is that launch. ``envelope_ar_scan_bwd_ref`` is its plain
  version: the same recurrence, walked serially backward in torch ops
  (:func:`order1_adjoint_ref`). ``envelope_ar_scan_bwd_chunked`` is the
  kernel's order in torch ops (:func:`order1_adjoint_grid`: 256-sample
  chunks, segments composed in the kernel's grouping, its fused
  multiply-adds exact), equal to the kernel bit for bit.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable
from pygmu2_tpu_torch.ops.xla_math import fmaf


def envelope_ar_scan_ref(x, env0, *, atk, rel):
    """Plain PyTorch version of :func:`envelope_ar_scan` (same arguments
    and result). A Python loop over samples: keep T small."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    a, r = f32(atk), f32(rel)
    e = env0.to(torch.float32)
    ys = []
    for xi in x.to(torch.float32):
        coeff = torch.where(xi > e, a, r)
        e = fmaf(coeff, xi - e, e)
        ys.append(e)
    return torch.stack(ys), e


def envelope_ar_scan(x, env0, *, atk, rel):
    """Attack/release follower over T samples and C channels.

    x: (T, C) f32; env0: (C,) f32. Returns (env (T, C), env_final (C,)).
    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    count in ``envelope_ar_scan.launches`` per call) or raise.
    """
    if x.device.type == "cpu":
        return envelope_ar_scan_ref(x, env0, atk=atk, rel=rel)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _differentiable(x, env0, atk=atk, rel=rel)


envelope_ar_scan.launches = 0


def _launch(x, env0, *, atk, rel):
    dev = x.device
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"unsupported shape x={tuple(x.shape)}")
    T, C = x.shape
    x = _ext.checked(x, "x", (T, C), dev)
    env0 = _ext.checked(env0, "env0", (C,), dev)
    env = torch.empty((T, C), dtype=torch.float32, device=dev)
    env_final = torch.empty((C,), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.envelope_ar_scan_launch(
            x.data_ptr(), env0.data_ptr(), env.data_ptr(), env_final.data_ptr(),
            T, C, float(atk), float(rel), torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "envelope_ar_scan")
    envelope_ar_scan.launches += 1
    return env, env_final


def order1_adjoint_ref(k, g, g_final):
    """The adjoint of ``y_t = y_{t-1} + k_t (x_t - y_{t-1})`` over (T, C)
    (or (T,)) planes, the k_t constants: ``lambda_t = g_t + (1 - k_{t+1})
    lambda_{t+1}`` from ``g_final`` (the state out's cotangent) at the
    last sample; returns (gx = k lambda, the state in's cotangent
    (1 - k_0) lambda_0). A Python loop over samples, in torch ops."""
    m = 1.0 - k
    gx = torch.empty_like(g)
    carry = g_final.to(torch.float32)
    for t in range(g.shape[0] - 1, -1, -1):
        lam = g[t] + carry
        gx[t] = k[t] * lam
        carry = m[t] * lam
    return gx, carry


# csrc/order1_grid.cuh's grouping: chunks of GRID_ROWS samples, a CUDA
# block of GRID_WARPS warps
GRID_ROWS, GRID_WARPS = 256, 8


def grid_width(C: int) -> int:
    """order1_grid.cuh's tile of channels: C rounded up to a power of two,
    at most 32; a thread's segment is as many samples."""
    w = 1
    while w < C and w < 32:
        w *= 2
    return w


def order1_adjoint_grid(k, g, g_final):
    """The adjoint of :func:`order1_adjoint_ref` (same arguments and result,
    (T, C) planes) in ``csrc/order1_grid.cuh``'s order, in torch ops
    rounded as the kernel's (its fused multiply-adds exact, by
    ``xla_math.fmaf``). Each chunk of GRID_ROWS samples is GRID_WARPS warps
    of 32 / W segments of W samples (W = :func:`grid_width`); a segment
    walked from a zero carry is the map in -> a in + b; a warp's segments
    compose by a suffix Kogge-Stone scan, the warps' totals from the last,
    the chunks' maps carried from ``g_final`` from the last chunk; then
    each segment walks again from its carry."""
    T, C = g.shape
    W = grid_width(C)
    G, seg = 32 // W, W
    L = -(-T // GRID_ROWS)
    pad = L * GRID_ROWS - T

    def blocks(v):  # (L, warps, G, seg, C); rows past T the identity (k = 0, g = 0)
        v = torch.cat([v.to(torch.float32), v.new_zeros((pad, C), dtype=torch.float32)])
        return v.reshape(L, GRID_WARPS, G, seg, C)

    kk, gg = blocks(k), blocks(g)
    m = 1.0 - kk
    a = torch.ones((L, GRID_WARPS, G, C), dtype=torch.float32, device=g.device)
    b = torch.zeros_like(a)
    for i in reversed(range(seg)):  # each segment from a zero carry
        b = m[:, :, :, i] * (gg[:, :, :, i] + b)
        a = a * m[:, :, :, i]
    d = 1
    while d < G:  # the suffix maps over a warp's segments (warp shuffles)
        na, nb = a.clone(), b.clone()
        nb[:, :, :-d] = fmaf(a[:, :, :-d], b[:, :, d:], b[:, :, :-d])
        na[:, :, :-d] = a[:, :, :-d] * a[:, :, d:]
        a, b = na, nb
        d *= 2
    wa, wb = a[:, :, 0], b[:, :, 0]  # (L, warps, C): the warps' totals
    ca, cb = wa[:, -1], wb[:, -1]  # each chunk's map, from its last warp
    for w in range(GRID_WARPS - 2, -1, -1):
        ca, cb = wa[:, w] * ca, fmaf(wa[:, w], cb, wb[:, w])
    carry = g_final.to(torch.float32).reshape(C)
    cin = [None] * L
    for ch in range(L - 1, -1, -1):  # the carry entering each chunk, from the last
        cin[ch] = carry
        carry = fmaf(ca[ch], carry, cb[ch])
    into = [torch.stack(cin)]  # into each warp, from the last
    for w in range(GRID_WARPS - 2, -1, -1):
        into.insert(0, fmaf(wa[:, w + 1], into[0], wb[:, w + 1]))
    win = torch.stack(into, 1)[:, :, None]  # (L, warps, 1, C)
    into = torch.cat([fmaf(a[:, :, 1:], win, b[:, :, 1:]), win], dim=2)  # into each segment
    gx = torch.empty_like(kk)
    for i in reversed(range(seg)):  # each segment again from its carry
        lam = gg[:, :, :, i] + into
        gx[:, :, :, i] = kk[:, :, :, i] * lam
        into = m[:, :, :, i] * lam
    return gx.reshape(L * GRID_ROWS, C)[:T], into[0, 0, 0]


def _coefficients(x, env0, env, atk, rel):
    """The forward's coefficients, from its compares: atk where x_t is
    above the envelope before it, else rel."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    prev = torch.cat([env0.reshape(1, -1).to(torch.float32), env[:-1]])
    return torch.where(x.to(torch.float32) > prev, f32(atk), f32(rel))


def envelope_ar_scan_bwd_chunked(x, env0, env, genv, genv_final, *, atk, rel):
    """:func:`envelope_ar_scan_bwd` in the kernel's order (same arguments
    and result): the coefficients from the forward's compares, then
    :func:`order1_adjoint_grid`. Equal to the kernel bit for bit."""
    k = _coefficients(x, env0, env, atk, rel)
    return order1_adjoint_grid(k, genv.to(torch.float32), genv_final)


def envelope_ar_scan_bwd(x, env0, env, genv, genv_final, *, atk, rel):
    """The cotangents (gx (T, C), genv0 (C,)) of :func:`envelope_ar_scan`'s
    inputs, given its arguments, its output ``env`` and the cotangents of
    ``env`` (T, C) and ``env_final`` (C,). CPU tensors take the plain
    version; CUDA tensors launch the kernel (one count in
    ``envelope_ar_scan_bwd.launches`` per call) or raise."""
    args = (x, env0, env, genv, genv_final)
    if x.device.type == "cpu":
        return envelope_ar_scan_bwd_ref(*args, atk=atk, rel=rel)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch_bwd(*args, atk=atk, rel=rel)


envelope_ar_scan_bwd.launches = 0


def envelope_ar_scan_bwd_ref(x, env0, env, genv, genv_final, *, atk, rel):
    """Plain PyTorch version of :func:`envelope_ar_scan_bwd`: the
    coefficients from the forward's compares (x_t against the envelope
    before it), then :func:`order1_adjoint_ref`."""
    k = _coefficients(x, env0, env, atk, rel)
    return order1_adjoint_ref(k, genv.to(torch.float32), genv_final)


def _launch_bwd(x, env0, env, genv, genv_final, *, atk, rel):
    dev = x.device
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"unsupported shape x={tuple(x.shape)}")
    T, C = x.shape
    x, env, genv = (_ext.checked(v, n, (T, C), dev) for v, n in
                    ((x, "x"), (env, "env"), (genv, "genv")))
    env0, genv_final = (_ext.checked(v, n, (C,), dev) for v, n in
                        ((env0, "env0"), (genv_final, "genv_final")))
    gx = torch.empty((T, C), dtype=torch.float32, device=dev)
    genv0 = torch.empty((C,), dtype=torch.float32, device=dev)
    # the chunks' maps, and the kernel's ticket and flags (zeroed by the launch)
    L = -(-T // GRID_ROWS)
    agg = torch.empty((2, L, C), dtype=torch.float32, device=dev)
    flags = torch.empty((1 + L * -(-C // grid_width(C)),), dtype=torch.int32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.envelope_ar_scan_bwd_launch(
            x.data_ptr(), env0.data_ptr(), env.data_ptr(), genv.data_ptr(),
            genv_final.data_ptr(), gx.data_ptr(), genv0.data_ptr(), agg.data_ptr(),
            flags.data_ptr(), T, C, float(atk), float(rel),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "envelope_ar_scan_bwd")
    envelope_ar_scan_bwd.launches += 1
    return gx, genv0


def _backward(args, outs, grads, *, atk, rel):
    x, env0 = args
    (env, _), (genv, genv_final) = outs, grads
    return envelope_ar_scan_bwd(x, env0, env, genv, genv_final, atk=atk, rel=rel)


# the vmap layout: every argument and output carries the channels
LAYOUT = dict(channels=(1, 0), out_channels=(1, 0))
# the launch as a torch.autograd.Function, its backward envelope_ar_scan_bwd
_differentiable = diffable.kernel_function("envelope_ar_scan", _launch, _backward, **LAYOUT)
