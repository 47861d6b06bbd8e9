"""The order-2 affine scan over a wide batch, chunk by chunk.

Counterpart of ``pygmu2_tpu.ops.linrec_pallas``: one function,
``affine_scan_2_kernel``, computes

    s[t] = [[a11[t], a12[t]], [a21[t], a22[t]]] @ s[t-1] + [u1[t], u2[t]]

over (T, C) float32 planes with an optional pair of (C,) states ``s0``
before step 0, and returns the two (T, C) state components.

- ``affine_scan_2_kernel`` is the wrapper. For CUDA tensors it launches
  the hand-written kernel in ``csrc/affine_scan_2.cu`` and counts the
  launch in ``affine_scan_2_kernel.launches``; for CPU tensors it runs the
  plain version.
- ``affine_scan_2_chunked_ref`` is the plain PyTorch version, op for op
  the TPU kernel's (``_affine_scan_2_pallas_raw`` and ``_scan_kernel``):
  ``s0`` folded into ``u[0]``, T zero-padded to the chunk, a Kogge-Stone
  scan within each chunk (shifted-in rows are the identity map), and the
  state carried from chunk to chunk as ``m @ c + v``. Every ``a·b + c·d``
  is one fused multiply-add, ``fma(a, b, c·d)``, as XLA's CPU backend
  contracts it in the JAX package's reference: the plain version equals
  ``affine_scan_2_pallas(..., interpret=True)`` there bit for bit, and the
  kernel (``__fmaf_rn``) equals the plain version.

A plane that every channel shares may be given as (T, 1) or as a view
expanded along the channels (stride 0): the kernel then reads one row per
sample instead of C, with the same result.

Differentiable: on the card the launch is a ``torch.autograd.Function``
(:mod:`~pygmu2_tpu_torch.ops.diffable`) whose backward is
``affine_scan_2_bwd``. The adjoint of ``s[t] = A[t] s[t-1] + u[t]`` is

    lam[t] = g[t] + A[t+1]^T lam[t+1],

the same recurrence run backward in time on the transposed matrices, so
the backward is one launch of the same kernel (counted in
``affine_scan_2_bwd.launches``) on the time-reversed, transposed, shifted
planes, a shared plane kept shared; then, in torch ops, ``gu = lam``,
``gA[t] = lam[t] s[t-1]^T`` (the forward's output the residual),
``gs0 = A[0]^T lam[0]``. On the CPU the same adjoint runs the plain
version (``affine_scan_2_bwd``), and autograd differentiates the plain
forward (``affine_scan_2_bwd_ref``).
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable
from pygmu2_tpu_torch.ops.xla_math import fmaf

_MAX_CHUNK = 1024  # a chunk's rows in one CUDA block


def _dot(a, b, c, d):
    """``a·b + c·d`` as XLA contracts it: ``fma(a, b, c·d)``."""
    return fmaf(a, b, c * d)


def affine_scan_2_chunked_ref(a11, a12, a21, a22, u1, u2, s0=None, *, chunk: int):
    """Plain PyTorch version of :func:`affine_scan_2_kernel` (same
    arguments and result)."""
    a11, a12, a21, a22, u1, u2 = torch.broadcast_tensors(a11, a12, a21, a22, u1, u2)
    T, C = u1.shape
    if all(m.stride(1) == 0 for m in (a11, a12, a21, a22)):
        # maps shared by the channels: their scan runs on one column
        a11, a12, a21, a22 = (m[:, :1] for m in (a11, a12, a21, a22))
    if s0 is not None:
        s01, s02 = s0  # added to the first row, out of place (torch.func.vmap batches it)
        u1 = torch.cat([(u1[0] + _dot(a11[0], s01, a12[0], s02))[None], u1[1:]])
        u2 = torch.cat([(u2[0] + _dot(a21[0], s01, a22[0], s02))[None], u2[1:]])
    L = -(-T // chunk)
    pad = L * chunk - T

    def prep(x):  # zero padding, (L, chunk, C or 1)
        if pad:
            x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        return x.reshape(L, chunk, x.shape[1])

    m11, m12, m21, m22, v1, v2 = (prep(x) for x in (a11, a12, a21, a22, u1, u2))
    s = 1
    while s < chunk:
        def sh(x, fill):
            return torch.cat([x.new_full((L, s, x.shape[2]), fill), x[:, :-s]], dim=1)

        p11, p12, p21, p22 = sh(m11, 1.0), sh(m12, 0.0), sh(m21, 0.0), sh(m22, 1.0)
        q1, q2 = sh(v1, 0.0), sh(v2, 0.0)
        m11, m12, m21, m22, v1, v2 = (
            _dot(m11, p11, m12, p21),
            _dot(m11, p12, m12, p22),
            _dot(m21, p11, m22, p21),
            _dot(m21, p12, m22, p22),
            _dot(m11, q1, m12, q2) + v1,
            _dot(m21, q1, m22, q2) + v2,
        )
        s *= 2

    c1 = c2 = u1.new_zeros((C,))
    in1, in2 = [], []
    for i in range(L):  # the state entering each chunk
        in1.append(c1)
        in2.append(c2)
        c1, c2 = (
            _dot(m11[i, -1], c1, m12[i, -1], c2) + v1[i, -1],
            _dot(m21[i, -1], c1, m22[i, -1], c2) + v2[i, -1],
        )
    in1, in2 = torch.stack(in1)[:, None], torch.stack(in2)[:, None]
    s1 = (_dot(m11, in1, m12, in2) + v1).reshape(L * chunk, C)[:T]
    s2 = (_dot(m21, in1, m22, in2) + v2).reshape(L * chunk, C)[:T]
    return s1, s2


def affine_scan_2_kernel(a11, a12, a21, a22, u1, u2, s0=None, *, chunk: int):
    """Order-2 affine scan of (T, C) planes in chunks of ``chunk`` samples.

    The six planes broadcast to (T, C) (u1 must be (T, C)); ``s0`` is an
    optional pair of (C,) states. Returns (s1, s2), each (T, C). CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    count in ``affine_scan_2_kernel.launches`` per call) or raise.
    """
    if u1.device.type == "cpu":
        return affine_scan_2_chunked_ref(a11, a12, a21, a22, u1, u2, s0, chunk=chunk)
    if u1.device.type != "cuda":
        raise ValueError(f"no kernel for device {u1.device}")
    s01, s02 = (None, None) if s0 is None else s0
    return _differentiable(a11, a12, a21, a22, u1, u2, s01, s02, chunk=chunk)


affine_scan_2_kernel.launches = 0


def _shifted_transposed(a11, a12, a21, a22, T: int):
    """The adjoint's planes: b[r] = A[T - r]^T for r >= 1, b[0] = 0 (it
    multiplies the zero state before the last sample). A shared plane
    stays one column."""
    def rev(a):
        a = a[:, :1] if a.shape[1] == 1 or a.stride(1) == 0 else a
        return torch.cat([a.new_zeros((1, a.shape[1])), a.flip(0)[:-1]])

    return rev(a11), rev(a21), rev(a12), rev(a22)


def affine_scan_2_bwd(a11, a12, a21, a22, u1, u2, s01, s02, s1, s2, g1, g2, *, chunk: int):
    """The cotangents of :func:`affine_scan_2_kernel`'s inputs.

    Takes the forward's planes (broadcast to (T, C)), its entering state
    (``s01``, ``s02``: (C,) each, or None), its outputs ``s1``, ``s2`` and
    their cotangents ``g1``, ``g2``; returns (ga11, ga12, ga21, ga22, gu1,
    gu2), each (T, C), and (gs01, gs02), each (C,) (None without a state).
    The adjoint scan is the plain version on CPU tensors; on CUDA tensors
    it is a launch of the kernel (one count in
    ``affine_scan_2_bwd.launches`` per call).
    """
    a11, a12, a21, a22, u1, u2 = torch.broadcast_tensors(a11, a12, a21, a22, u1, u2)
    T, C = u1.shape
    planes = _shifted_transposed(a11, a12, a21, a22, T) + (g1.flip(0), g2.flip(0))
    if u1.device.type == "cpu":
        l1, l2 = affine_scan_2_chunked_ref(*planes, chunk=chunk)
    elif u1.device.type == "cuda":
        l1, l2 = _launch(planes, None, chunk)
        affine_scan_2_bwd.launches += 1
    else:
        raise ValueError(f"no kernel for device {u1.device}")
    l1, l2 = l1.flip(0), l2.flip(0)
    if s01 is None:
        zero = u1.new_zeros((1, C))
        p1, p2 = torch.cat([zero, s1[:-1]]), torch.cat([zero, s2[:-1]])
    else:
        p1 = torch.cat([(u1.new_zeros((C,)) + s01)[None], s1[:-1]])
        p2 = torch.cat([(u1.new_zeros((C,)) + s02)[None], s2[:-1]])
    gs = (None, None)
    if s01 is not None:
        gs = (a11[0] * l1[0] + a21[0] * l2[0], a12[0] * l1[0] + a22[0] * l2[0])
    return (l1 * p1, l1 * p2, l2 * p1, l2 * p2, l1, l2) + gs


affine_scan_2_bwd.launches = 0


def affine_scan_2_bwd_ref(a11, a12, a21, a22, u1, u2, s01, s02, s1, s2, g1, g2, *,
                          chunk: int):
    """Plain PyTorch version of :func:`affine_scan_2_bwd`: autograd of
    :func:`affine_scan_2_chunked_ref` (same arguments and result)."""
    a11, a12, a21, a22, u1, u2 = torch.broadcast_tensors(a11, a12, a21, a22, u1, u2)
    with torch.enable_grad():
        ins = [t.detach().clone().requires_grad_() for t in (a11, a12, a21, a22, u1, u2)]
        s0 = None
        if s01 is not None:
            s0 = [(u1.new_zeros(u1.shape[1:]) + v).detach().requires_grad_() for v in (s01, s02)]
        out = affine_scan_2_chunked_ref(*ins, s0, chunk=chunk)
        got = torch.autograd.grad(out, ins + (s0 or []), (g1, g2), allow_unused=True,
                                  materialize_grads=True)
    return tuple(got) + ((None, None) if s0 is None else ())


def _plane(x, T: int, C: int, dev, name: str):
    """(tensor, shared): a (T, C) plane, or its (T,) column when every
    channel shares it."""
    if x.dim() != 2 or x.shape[0] != T or x.shape[1] not in (1, C):
        raise ValueError(f"{name}: expected (T, C) = ({T}, {C}) or (T, 1), got {tuple(x.shape)}")
    if x.shape[1] == 1 or x.stride(1) == 0:
        return _ext.checked(x[:, 0], name, (T,), dev), True
    return _ext.checked(x, name, (T, C), dev), False


def _launch(planes, s0, chunk: int):
    u1 = planes[4]
    dev = u1.device
    if u1.dim() != 2 or u1.shape[0] < 1 or u1.shape[1] < 1:
        raise ValueError(f"u1 must be (T, C) with T, C >= 1, got {tuple(u1.shape)}")
    if chunk < 2 or chunk > _MAX_CHUNK or chunk & (chunk - 1):
        raise ValueError(f"chunk must be a power of two in [2, {_MAX_CHUNK}], got {chunk}")
    T, C = u1.shape
    names = ("a11", "a12", "a21", "a22", "u1", "u2")
    checked = [_plane(x, T, C, dev, n) for x, n in zip(planes, names)]
    shared = sum(1 << i for i, (_x, sh) in enumerate(checked) if sh)
    if s0 is not None:
        s0 = [_ext.checked(torch.as_tensor(v, dtype=torch.float32, device=dev).expand(C),
                           f"s0[{i}]", (C,), dev) for i, v in enumerate(s0)]
    s1 = torch.empty((T, C), dtype=torch.float32, device=dev)
    s2 = torch.empty((T, C), dtype=torch.float32, device=dev)
    # each chunk's last row (m11, m12, m21, m22, v1, v2), carried to the next,
    # and the kernel's ticket and flags (zeroed by the launch)
    L = -(-T // chunk)
    agg = torch.empty((6, L, C), dtype=torch.float32, device=dev)
    flags = torch.empty((1 + L * C,), dtype=torch.int32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.affine_scan_2_launch(
            *(x.data_ptr() for x, _sh in checked),
            s0[0].data_ptr() if s0 is not None else None,
            s0[1].data_ptr() if s0 is not None else None,
            s1.data_ptr(), s2.data_ptr(), agg.data_ptr(), flags.data_ptr(), T, C,
            chunk, shared,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "affine_scan_2")
    return s1, s2


def _launch_forward(a11, a12, a21, a22, u1, u2, s01, s02, *, chunk: int):
    out = _launch((a11, a12, a21, a22, u1, u2), None if s01 is None else (s01, s02), chunk)
    affine_scan_2_kernel.launches += 1
    return out


def _backward(args, outs, grads, *, chunk: int):
    got = affine_scan_2_bwd(*args, *outs, *grads, chunk=chunk)
    return [None if g is None else g.sum_to_size(a.shape) for g, a in zip(got, args)]


# the vmap layout: the planes' channels (a (T, 1) plane is shared by them)
# and the entering state's
LAYOUT = dict(channels=(1, 1, 1, 1, 1, 1, 0, 0), out_channels=(1, 1))
# the launch as a torch.autograd.Function, its backward affine_scan_2_bwd
_differentiable = diffable.kernel_function("affine_scan_2", _launch_forward, _backward,
                                           **LAYOUT)
