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


# the launches as torch.autograd.Functions whose backward raises on the card:
# the follower's backward kernel is still to port (ROADMAP.md, queue 2); on the CPU autograd
# differentiates the plain version
_differentiable = diffable.kernel_function("envelope_ar_scan", _launch)
