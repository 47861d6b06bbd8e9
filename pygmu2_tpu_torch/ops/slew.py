"""The two-sided slew limiter's per-sample recurrence.

Counterpart of ``pygmu2_tpu.ops.slew_pallas``: one function,
``slew_scan``, takes the (T,) mono input and the carried value and
returns the (T,) output and its last value, in one of two modes:

- LINEAR:      ``y = y + clip(x - y, -p_fall, p_rise)``
- EXPONENTIAL: ``y = y + k * (x - y)``, ``k = p_rise`` if ``x > y`` else
  ``p_fall``

``slew_scan`` is the wrapper. For CUDA tensors it launches the
hand-written kernel in ``csrc/slew_scan.cu`` and counts the launch in
``slew_scan.launches``; for CPU tensors it runs the plain version.
``slew_scan_ref`` is the plain PyTorch version: a per-sample loop with the
JAX package's ``slew_scan_ref`` op order, float32.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable


def slew_scan_ref(x, cur0, *, linear, p_rise, p_fall):
    """Plain PyTorch version of :func:`slew_scan` (same arguments and
    result). A Python loop over samples: keep T small."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    pr, pf = f32(p_rise), f32(p_fall)
    cur = torch.as_tensor(cur0, dtype=torch.float32, device=x.device).reshape(())
    ys = []
    for xi in x.to(torch.float32):
        if linear:
            cur = cur + torch.minimum(torch.maximum(xi - cur, -pf), pr)
        else:
            err = xi - cur
            cur = cur + torch.where(err > 0, pr, pf) * err
        ys.append(cur)
    return torch.stack(ys), cur


def slew_scan(x, cur0, *, linear, p_rise, p_fall):
    """Slew limiter over T samples.

    x: (T,) f32; cur0: () f32. Returns (y (T,), final () f32). CPU tensors
    take the plain version; CUDA tensors launch the kernel (one count in
    ``slew_scan.launches`` per call) or raise.
    """
    kw = dict(linear=linear, p_rise=p_rise, p_fall=p_fall)
    if x.device.type == "cpu":
        return slew_scan_ref(x, cur0, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _differentiable(x, cur0, **kw)


slew_scan.launches = 0


def _launch(x, cur0, *, linear, p_rise, p_fall):
    dev = x.device
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"unsupported shape x={tuple(x.shape)}")
    (T,) = x.shape
    x = _ext.checked(x, "x", (T,), dev)
    cur0 = _ext.checked(cur0.reshape(()), "cur0", (), dev)
    y = torch.empty((T,), dtype=torch.float32, device=dev)
    cur_out = torch.empty((), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.slew_scan_launch(
            x.data_ptr(), cur0.data_ptr(), y.data_ptr(), cur_out.data_ptr(), T,
            int(bool(linear)), float(p_rise), float(p_fall),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "slew_scan")
    slew_scan.launches += 1
    return y, cur_out


# the launches as torch.autograd.Functions whose backward raises on the card:
# the slew limiter's backward kernel is still to port (ROADMAP.md, queue 2); on the CPU autograd
# differentiates the plain version
_differentiable = diffable.kernel_function("slew_scan", _launch)
