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

the same recurrence run backward in time on the transposed matrices: the
same chunked scan on the time-reversed, transposed, shifted planes (row 0
the zero matrix), then ``gu = lam``, ``gA[t] = lam[t] s[t-1]^T`` (the
forward's output the residual), ``gs0 = A[0]^T lam[0]``. On the card that
is one launch of the same kernel, which reads the forward's planes by index
and writes the cotangents itself (counted in
``affine_scan_2_bwd.launches``; a plane given as a (T, 1) column gets its
column, summed over the channels in the kernel's order, by a second,
small launch). On the CPU ``affine_scan_2_bwd`` runs the plain version of
that order, ``affine_scan_2_bwd_plain``, and autograd differentiates the
plain forward (``affine_scan_2_bwd_ref``).
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


def _summed(planes) -> list:
    """Which of the six planes (a11, a12, a21, a22, u1, u2) are given as a
    (T, 1) column: their cotangents are columns too."""
    return [p.dim() == 2 and p.shape[1] == 1 for p in planes]


def tile_width(all_shared: bool) -> int:
    """The kernel's tile of channels: 8 where the four matrix planes are
    shared by the channels, else 4."""
    return 8 if all_shared else 4


def tile_sum(v, width: int):
    """(T, C) -> (T, 1): the channels summed in the kernel's order, each
    tile of ``width`` channels in channel order from zero, then the tiles
    in tile order from zero (``csrc/channel_sum.cuh``)."""
    T, C = v.shape
    total = v.new_zeros(T)
    for c0 in range(0, C, width):
        part = v.new_zeros(T)
        for c in range(c0, min(C, c0 + width)):
            part = part + v[:, c]
        total = total + part
    return total[:, None]


def affine_scan_2_bwd(a11, a12, a21, a22, u1, u2, s01, s02, s1, s2, g1, g2, *, chunk: int):
    """The cotangents of :func:`affine_scan_2_kernel`'s inputs.

    Takes the forward's planes (each (T, C) or a (T, 1) column shared by
    the channels), its entering state (``s01``, ``s02``: (C,) each, or
    None), its outputs ``s1``, ``s2`` and their cotangents ``g1``, ``g2``;
    returns (ga11, ga12, ga21, ga22, gu1, gu2), each (T, C), or (T, 1) for
    a plane given as a column (the channel sum, :func:`tile_sum`), and
    (gs01, gs02), each (C,) (None without a state). CPU tensors take the
    plain version, :func:`affine_scan_2_bwd_plain`; CUDA tensors launch
    the kernel (one count in ``affine_scan_2_bwd.launches`` per call) or
    raise.
    """
    args = (a11, a12, a21, a22, u1, u2, s01, s02, s1, s2, g1, g2)
    if u1.device.type == "cpu":
        return affine_scan_2_bwd_plain(*args, chunk=chunk)
    if u1.device.type != "cuda":
        raise ValueError(f"no kernel for device {u1.device}")
    got = _launch_bwd(*args, chunk=chunk)
    affine_scan_2_bwd.launches += 1
    return got


affine_scan_2_bwd.launches = 0


def affine_scan_2_bwd_plain(a11, a12, a21, a22, u1, u2, s01, s02, s1, s2, g1, g2, *,
                            chunk: int):
    """Plain PyTorch version of :func:`affine_scan_2_bwd` (same arguments
    and result) in the kernel's order: the adjoint scan by
    :func:`affine_scan_2_chunked_ref` on the reversed, transposed, shifted
    planes; the products rounded alone; a column's channel sum by
    :func:`tile_sum`; gs0 two products and a sum."""
    summed = _summed((a11, a12, a21, a22, u1, u2))
    a11, a12, a21, a22, u1, u2 = torch.broadcast_tensors(a11, a12, a21, a22, u1, u2)
    T, C = u1.shape
    planes = _shifted_transposed(a11, a12, a21, a22, T) + (g1.flip(0), g2.flip(0))
    l1, l2 = affine_scan_2_chunked_ref(*planes, chunk=chunk)
    l1, l2 = l1.flip(0), l2.flip(0)
    zero = u1.new_zeros((1, C))
    e1, e2 = (zero, zero) if s01 is None else (torch.broadcast_to(s01, (1, C)),
                                                torch.broadcast_to(s02, (1, C)))
    p1, p2 = torch.cat([e1, s1[:-1]]), torch.cat([e2, s2[:-1]])
    width = tile_width(all(m.stride(1) == 0 for m in (a11, a12, a21, a22)))
    full = (l1 * p1, l1 * p2, l2 * p1, l2 * p2, l1, l2)
    got = tuple(tile_sum(v, width) if sm else v for v, sm in zip(full, summed))
    gs = (None, None)
    if s01 is not None:
        gs = (a11[0] * l1[0] + a21[0] * l2[0], a12[0] * l1[0] + a22[0] * l2[0])
    return got + gs


def affine_scan_2_bwd_ref(a11, a12, a21, a22, u1, u2, s01, s02, s1, s2, g1, g2, *,
                          chunk: int):
    """Autograd of :func:`affine_scan_2_chunked_ref`: the cotangents of
    :func:`affine_scan_2_bwd` (same arguments and result; a (T, 1)
    column's summed by autograd's own order)."""
    with torch.enable_grad():
        ins = [t.detach().clone().requires_grad_() for t in (a11, a12, a21, a22, u1, u2)]
        s0 = None
        if s01 is not None:
            C = u1.shape[1]
            s0 = [(u1.new_zeros((C,)) + v).detach().requires_grad_() for v in (s01, s02)]
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


def _launch_bwd(a11, a12, a21, a22, u1, u2, s01, s02, s1, s2, g1, g2, *, chunk: int):
    dev = s1.device
    if s1.dim() != 2 or s1.shape[0] < 1 or s1.shape[1] < 1:
        raise ValueError(f"s1 must be (T, C) with T, C >= 1, got {tuple(s1.shape)}")
    if chunk < 2 or chunk > _MAX_CHUNK or chunk & (chunk - 1):
        raise ValueError(f"chunk must be a power of two in [2, {_MAX_CHUNK}], got {chunk}")
    T, C = s1.shape
    for x, n in ((u1, "u1"), (u2, "u2")):
        if x.dim() != 2 or x.shape[0] != T or x.shape[1] not in (1, C):
            raise ValueError(f"{n}: expected (T, C) = ({T}, {C}) or (T, 1), got "
                             f"{tuple(x.shape)}")
    summed = _summed((a11, a12, a21, a22, u1, u2))
    read = [_plane(x, T, C, dev, n) for x, n in
            zip((a11, a12, a21, a22, g1, g2), ("a11", "a12", "a21", "a22", "g1", "g2"))]
    bits = sum(1 << i for i, (_x, sh) in enumerate(read) if sh)
    summed_bits = sum(1 << j for j, sm in enumerate(summed) if sm)
    s1, s2 = (_ext.checked(v, n, (T, C), dev) for v, n in ((s1, "s1"), (s2, "s2")))
    s0 = None
    if s01 is not None:
        s0 = [_ext.checked(torch.as_tensor(v, dtype=torch.float32, device=dev).expand(C),
                           f"s0[{i}]", (C,), dev) for i, v in enumerate((s01, s02))]
    planes = [None if sm else torch.empty((T, C), dtype=torch.float32, device=dev)
              for sm in summed]
    gs0 = [torch.empty((C,), dtype=torch.float32, device=dev) for _ in range(2)] if s0 else None
    # the summed outputs' columns and the tiles' sums they add, the chunks'
    # last rows and the kernel's ticket and flags (zeroed by the launch)
    n_sum = sum(summed)
    tiles = -(-C // tile_width(bits & 15 == 15))
    col = torch.empty((n_sum, T), dtype=torch.float32, device=dev)
    part = torch.empty((n_sum, T, tiles), dtype=torch.float32, device=dev)
    L = -(-T // chunk)
    agg = torch.empty((6, L, C), dtype=torch.float32, device=dev)
    flags = torch.empty((1 + L * C,), dtype=torch.int32, device=dev)

    def ptr(v):
        return None if v is None else v.data_ptr()

    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.affine_scan_2_bwd_launch(
            *(x.data_ptr() for x, _sh in read),
            *(ptr(v) for v in (s0 or (None, None))), s1.data_ptr(), s2.data_ptr(),
            *(ptr(v) for v in planes), *(ptr(v) for v in (gs0 or (None, None))),
            part.data_ptr(), col.data_ptr(), agg.data_ptr(), flags.data_ptr(), T, C, chunk,
            bits, summed_bits, torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "affine_scan_2_bwd")
    columns = iter(col[:, :, None].unbind(0))
    got = tuple(next(columns) if sm else v for v, sm in zip(planes, summed))
    return got + (tuple(gs0) if gs0 else (None, None))


def _backward(args, outs, grads, *, chunk: int):
    got = affine_scan_2_bwd(*args, *outs, *grads, chunk=chunk)
    return [None if g is None else g.sum_to_size(a.shape) for g, a in zip(got, args)]


# the vmap layout: the planes' channels (a (T, 1) plane is shared by them)
# and the entering state's
LAYOUT = dict(channels=(1, 1, 1, 1, 1, 1, 0, 0), out_channels=(1, 1))
# the launch as a torch.autograd.Function, its backward affine_scan_2_bwd
_differentiable = diffable.kernel_function("affine_scan_2", _launch_forward, _backward,
                                           **LAYOUT)
