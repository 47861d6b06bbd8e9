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
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
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
        s01, s02 = s0
        u1, u2 = u1.clone(), u2.clone()
        u1[0] = u1[0] + _dot(a11[0], s01, a12[0], s02)
        u2[0] = u2[0] + _dot(a21[0], s01, a22[0], s02)
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
    return _launch((a11, a12, a21, a22, u1, u2), s0, chunk)


affine_scan_2_kernel.launches = 0


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
    affine_scan_2_kernel.launches += 1
    return s1, s2
