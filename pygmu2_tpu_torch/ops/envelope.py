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
  (:func:`order1_adjoint_ref`).
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
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    prev = torch.cat([env0.reshape(1, -1).to(torch.float32), env[:-1]])
    k = torch.where(x.to(torch.float32) > prev, f32(atk), f32(rel))
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
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.envelope_ar_scan_bwd_launch(
            x.data_ptr(), env0.data_ptr(), env.data_ptr(), genv.data_ptr(),
            genv_final.data_ptr(), gx.data_ptr(), genv0.data_ptr(), T, C, float(atk),
            float(rel), torch.cuda.current_stream(dev).cuda_stream,
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
