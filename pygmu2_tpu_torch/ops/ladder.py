"""The Moog ladder's per-sample recurrence.

Counterpart of ``pygmu2_tpu.ops.ladder_pallas``: one function,
``ladder_scan``, takes the (T, C) input, four (T,) per-sample coefficient
columns and the (9, C) carried state, and returns the (T, C) output and
the state after the last sample.

- ``ladder_scan`` is the wrapper. For CUDA tensors it launches the
  hand-written kernel in ``csrc/ladder_scan.cu`` and counts the launch in
  ``ladder_scan.launches``; for CPU tensors it runs the plain version.
- ``ladder_scan_ref`` is the plain PyTorch version: a per-sample loop
  with the JAX package's ``ladder_scan_ref`` op order, float32.

Differentiable: on the card the launch is a ``torch.autograd.Function``
(:mod:`~pygmu2_tpu_torch.ops.diffable`) whose backward is
``ladder_scan_bwd``, the hand-written adjoint in
``csrc/ladder_scan_bwd.cu`` (counted in ``ladder_scan_bwd.launches``);
on the CPU autograd differentiates the plain version, as JAX
differentiates its ``lax.scan`` reference. ``ladder_scan_bwd_ref`` is the
backward's plain version (autograd of ``ladder_scan_ref``).

State rows: z0[0..3], z1[0..3], old (the previous input sample).
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable


def _mode_mix(mode_index: int, u, s1, s2, s3, s4):
    if mode_index == 0:
        return s4
    if mode_index == 1:
        return s2
    if mode_index == 2:
        return (s2 + s4) * 4.0 - s3 * 8.0
    if mode_index == 3:
        return (s1 - s2) * 2.0
    if mode_index == 4:
        return u + s4 - (s1 + s3) * 4.0 + s2 * 6.0
    return u + s2 - s1 * 2.0


def ladder_scan_ref(x, al, qa, ki, dsc, state, *, os_n, pbg, mode_index,
                    input_threshold, state_decay):
    """Plain PyTorch version of :func:`ladder_scan` (same arguments and
    result). A Python loop over samples: keep T small.

    The coefficient columns may also be (T, C), one per channel: C
    independent filters at once, each channel the one-channel call's."""
    os_recip = 1.0 / os_n
    dec = torch.tensor(state_decay, dtype=torch.float32, device=x.device)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    z0 = [state[k] for k in range(4)]
    z1 = [state[4 + k] for k in range(4)]
    old = state[8]
    ys = []
    for xi, al_, qa_, ki_, dsc_ in zip(x, al, qa, ki, dsc):
        input_sample = xi * dsc_
        decay = torch.where(input_sample.abs() < input_threshold, dec, one)
        z0 = [z * decay for z in z0]
        z1 = [z * decay for z in z1]
        old = old * decay
        total = torch.zeros_like(input_sample)
        for s_idx in range(os_n):
            interp = s_idx * os_recip
            in_i = interp * old + (1.0 - interp) * input_sample
            u = torch.tanh(in_i - (z1[3] - pbg * in_i) * ki_ * qa_)
            stages = []
            prev = u
            for st_i in range(4):
                ft = prev * 0.76923077 + 0.23076923 * z0[st_i] - z1[st_i]
                ft = ft * al_ + z1[st_i]
                z1[st_i] = ft
                z0[st_i] = prev
                stages.append(ft)
                prev = ft
            total = total + _mode_mix(mode_index, u, *stages) * os_recip
        old = input_sample
        ys.append(total)
    return torch.stack(ys), torch.stack(z0 + z1 + [old])


def ladder_scan(x, al, qa, ki, dsc, state, *, os_n, pbg, mode_index,
                input_threshold, state_decay):
    """Moog ladder over T samples and C channels.

    x: (T, C) f32; al/qa/ki/dsc: (T,) f32 per-sample coefficients (alpha,
    q_adjust, feedback k, drive); state: (9, C) f32. Returns
    (y (T, C), new_state (9, C)). CPU tensors take the plain version;
    CUDA tensors launch the kernel (one count in ``ladder_scan.launches``
    per call) or raise.
    """
    kw = dict(os_n=os_n, pbg=pbg, mode_index=mode_index,
              input_threshold=input_threshold, state_decay=state_decay)
    if x.device.type == "cpu":
        return ladder_scan_ref(x, al, qa, ki, dsc, state, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _differentiable(x, al, qa, ki, dsc, state, **kw)


ladder_scan.launches = 0


def ladder_scan_bwd(x, al, qa, ki, dsc, state, gy, gstate, *, os_n, pbg, mode_index,
                    input_threshold, state_decay):
    """The cotangents of :func:`ladder_scan`'s inputs.

    Takes the forward's arguments and the cotangents ``gy`` (T, C) and
    ``gstate`` (9, C) of its two outputs; returns (gx (T, C), gal, gqa,
    gki, gdsc (each (T,), summed over the channels), gstate_in (9, C)).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one count in ``ladder_scan_bwd.launches`` per call) or raise.
    """
    kw = dict(os_n=os_n, pbg=pbg, mode_index=mode_index,
              input_threshold=input_threshold, state_decay=state_decay)
    if x.device.type == "cpu":
        return ladder_scan_bwd_ref(x, al, qa, ki, dsc, state, gy, gstate, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch_bwd(x, al, qa, ki, dsc, state, gy, gstate, **kw)


ladder_scan_bwd.launches = 0


def ladder_scan_bwd_ref(x, al, qa, ki, dsc, state, gy, gstate, **kw):
    """Plain PyTorch version of :func:`ladder_scan_bwd`: autograd of
    :func:`ladder_scan_ref` (same arguments and result). The columns may
    also be (T, C), one per channel; their cotangents are then (T, C)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, al, qa, ki, dsc, state)]
        y, st = ladder_scan_ref(*ins, **kw)
        return torch.autograd.grad((y, st), ins, (gy, gstate), allow_unused=True,
                                   materialize_grads=True)


def _launch(x, al, qa, ki, dsc, state, *, os_n, pbg, mode_index,
            input_threshold, state_decay):
    dev = x.device
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (T, C) with T, C >= 1, got {tuple(x.shape)}")
    T, C = x.shape
    cols = [_ext.checked(v, f"column {i}", (T,), dev) for i, v in enumerate((al, qa, ki, dsc))]
    x = _ext.checked(x, "x", (T, C), dev)
    state = _ext.checked(state, "state", (9, C), dev)
    if os_n < 1 or mode_index not in range(6):
        raise ValueError(f"unsupported os_n={os_n} mode_index={mode_index}")
    y = torch.empty((T, C), dtype=torch.float32, device=dev)
    state_out = torch.empty((9, C), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.ladder_scan_launch(
            x.data_ptr(), *(c.data_ptr() for c in cols), state.data_ptr(),
            y.data_ptr(), state_out.data_ptr(), T, C, os_n, float(pbg),
            mode_index, float(input_threshold), float(state_decay),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "ladder_scan")
    ladder_scan.launches += 1
    return y, state_out


def _launch_bwd(x, al, qa, ki, dsc, state, gy, gstate, *, os_n, pbg, mode_index,
                input_threshold, state_decay):
    dev = x.device
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (T, C) with T, C >= 1, got {tuple(x.shape)}")
    T, C = x.shape
    cols = [_ext.checked(v, f"column {i}", (T,), dev) for i, v in enumerate((al, qa, ki, dsc))]
    x = _ext.checked(x, "x", (T, C), dev)
    gy = _ext.checked(gy, "gy", (T, C), dev)
    state = _ext.checked(state, "state", (9, C), dev)
    gstate = _ext.checked(gstate, "gstate", (9, C), dev)
    if os_n < 1 or mode_index not in range(6):
        raise ValueError(f"unsupported os_n={os_n} mode_index={mode_index}")
    gx = torch.empty((T, C), dtype=torch.float32, device=dev)
    gcols = torch.empty((4, T), dtype=torch.float32, device=dev)
    gstate_in = torch.empty((9, C), dtype=torch.float32, device=dev)
    # scratch: each sample's entering state, the columns' per-channel parts
    traj = torch.empty((T, 9, C), dtype=torch.float32, device=dev)
    part = torch.empty((4, T, C), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.ladder_scan_bwd_launch(
            x.data_ptr(), *(c.data_ptr() for c in cols), state.data_ptr(), gy.data_ptr(),
            gstate.data_ptr(), gx.data_ptr(), gcols.data_ptr(), gstate_in.data_ptr(),
            traj.data_ptr(), part.data_ptr(), T, C, os_n, float(pbg), mode_index,
            float(input_threshold), float(state_decay),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "ladder_scan_bwd")
    ladder_scan_bwd.launches += 1
    return gx, gcols[0], gcols[1], gcols[2], gcols[3], gstate_in


def _backward(args, outs, grads, **kw):
    x, al, qa, ki, dsc, state = args
    gy, gstate = grads
    got = ladder_scan_bwd(x, al, qa, ki, dsc, state, gy, gstate, **kw)
    return [g.reshape(a.shape) for g, a in zip(got, args)]


# the vmap layout: x and the state carry the channels; the coefficient
# columns are shared by them (a batched column: one launch per member)
LAYOUT = dict(channels=(1, None, None, None, None, 1), out_channels=(1, 1))
# the launch as a torch.autograd.Function, its backward ladder_scan_bwd
_differentiable = diffable.kernel_function("ladder_scan", _launch, _backward, **LAYOUT)
