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

``slew_scan_bwd`` is the backward: the cotangents of x and cur0. For CUDA
tensors it launches ``csrc/slew_scan_bwd.cu`` (counted in
``slew_scan_bwd.launches``); on the card ``slew_scan``'s gradient is that
launch. ``slew_scan_bwd_ref`` is its plain version; ``slew_scan_bwd_chunked``
is the kernel's order in torch ops (``csrc/order1_grid.cuh``'s, by
``envelope.order1_adjoint_grid``), equal to it bit for bit. The limits are
constants to the gradient, so both modes are ``y = y + k (x - y)``: k the
chosen coefficient (exponential) or the clip's slope (linear: 1 inside the
limits, 0 outside, 1/2 at a tie, where autograd of ``torch.minimum`` /
``torch.maximum`` and ``jax.vjp`` of ``jnp.clip`` split the gradient).
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable
from pygmu2_tpu_torch.ops.envelope import GRID_ROWS, order1_adjoint_grid, order1_adjoint_ref


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


def slew_scan_bwd(x, cur0, y, gy, gcur, *, linear, p_rise, p_fall):
    """The cotangents (gx (T,), gcur0 ()) of :func:`slew_scan`'s inputs,
    given its arguments, its output ``y`` and the cotangents of ``y`` and
    the final value. CPU tensors take the plain version; CUDA tensors
    launch the kernel (one count in ``slew_scan_bwd.launches`` per call)
    or raise."""
    kw = dict(linear=linear, p_rise=p_rise, p_fall=p_fall)
    if x.device.type == "cpu":
        return slew_scan_bwd_ref(x, cur0, y, gy, gcur, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch_bwd(x, cur0, y, gy, gcur, **kw)


slew_scan_bwd.launches = 0


def _coefficients(x, cur0, y, linear, p_rise, p_fall):
    """Each sample's coefficient from the forward's error ``x_t - y_{t-1}``:
    the chosen one (exponential) or the clip's slope (linear)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    pr, pf = f32(p_rise), f32(p_fall)
    err = x.to(torch.float32) - torch.cat([cur0.reshape(1).to(torch.float32), y[:-1]])
    if linear:
        return torch.where((err == pr) | (err == -pf), f32(0.5),
                           ((err < pr) & (err > -pf)).to(torch.float32))
    return torch.where(err > 0, pr, pf)


def slew_scan_bwd_ref(x, cur0, y, gy, gcur, *, linear, p_rise, p_fall):
    """Plain PyTorch version of :func:`slew_scan_bwd`: each sample's
    coefficient from the forward's error ``x_t - y_{t-1}``, then
    ``envelope.order1_adjoint_ref``."""
    k = _coefficients(x, cur0, y, linear, p_rise, p_fall)
    gx, gcur0 = order1_adjoint_ref(k, gy.to(torch.float32), gcur.reshape(()))
    return gx, gcur0.reshape(cur0.shape)


def slew_scan_bwd_chunked(x, cur0, y, gy, gcur, *, linear, p_rise, p_fall):
    """:func:`slew_scan_bwd` in the kernel's order (same arguments and
    result): the coefficients as :func:`slew_scan_bwd_ref` takes them, then
    ``envelope.order1_adjoint_grid`` at one channel. Equal to the kernel bit
    for bit."""
    k = _coefficients(x, cur0, y, linear, p_rise, p_fall)
    gx, gcur0 = order1_adjoint_grid(k[:, None], gy.to(torch.float32)[:, None], gcur.reshape(1))
    return gx[:, 0], gcur0.reshape(cur0.shape)


def _launch_bwd(x, cur0, y, gy, gcur, *, linear, p_rise, p_fall):
    dev = x.device
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"unsupported shape x={tuple(x.shape)}")
    (T,) = x.shape
    x, y, gy = (_ext.checked(v, n, (T,), dev) for v, n in ((x, "x"), (y, "y"), (gy, "gy")))
    cur0 = _ext.checked(cur0.reshape(()), "cur0", (), dev)
    gcur = _ext.checked(gcur.reshape(()), "gcur", (), dev)
    gx = torch.empty((T,), dtype=torch.float32, device=dev)
    gcur0 = torch.empty((), dtype=torch.float32, device=dev)
    # the chunks' maps, and the kernel's ticket and flags (zeroed by the launch)
    chunks = -(-T // GRID_ROWS)
    agg = torch.empty((2, chunks), dtype=torch.float32, device=dev)
    flags = torch.empty((1 + chunks,), dtype=torch.int32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.slew_scan_bwd_launch(
            x.data_ptr(), cur0.data_ptr(), y.data_ptr(), gy.data_ptr(), gcur.data_ptr(),
            gx.data_ptr(), gcur0.data_ptr(), agg.data_ptr(), flags.data_ptr(), T,
            int(bool(linear)), float(p_rise), float(p_fall),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "slew_scan_bwd")
    slew_scan_bwd.launches += 1
    return gx, gcur0


def _backward(args, outs, grads, **kw):
    x, cur0 = args
    (y, _), (gy, gcur) = outs, grads
    gx, gcur0 = slew_scan_bwd(x, cur0, y, gy, gcur, **kw)
    return gx, gcur0.reshape(cur0.shape)


# the launch as a torch.autograd.Function, its backward slew_scan_bwd
_differentiable = diffable.kernel_function("slew_scan", _launch, _backward)
