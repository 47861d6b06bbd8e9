"""The Karplus-Strong string's per-sample recurrence.

Counterpart of ``pygmu2_tpu.ops.ks_pallas``: one function, ``ks_scan``,
takes the (T,) feedback gain ``rho`` and activity mask ``act``, the (L,)
string, its read position and the allpass state, and returns the output
and the four state pieces after the last sample. Each active sample:
``out = rho * (buf[r] + buf[r+1]) * 0.5`` through the fractional-delay
allpass ``ap = c*out + ap_in - c*ap_out``, written back at ``r``. An
inactive sample (before t = 0) outputs 0 and leaves the string alone.

- ``ks_scan`` is the wrapper. For CUDA tensors it launches the
  hand-written kernel in ``csrc/ks_scan.cu`` and counts the launch in
  ``ks_scan.launches``; for CPU tensors it runs the plain version.
- ``ks_scan_ref`` is the plain PyTorch version: a per-sample loop with
  the JAX package's ``ks_scan_ref`` op order, float32, rounded as XLA's
  CPU program rounds it: the allpass is two fused multiply-adds,
  ``fma(-c, ap_out, fma(c, out, ap_in))`` (``ops/xla_math.fmaf``).
- ``ks_blocked_ref`` is the plain version of a call whose samples are all
  active, on a string of at least ``BLOCKED_MIN_L`` samples: the JAX
  KarplusStrongPE takes ``ops/ks_block.ks_blocked`` there, which forms
  the allpass of a block of ``B = min(L - 1, 512)`` samples as one
  lower-triangular matrix-vector product. It computes that product in the
  order of XLA's CPU program (``xla_gemv``: eight lanes of fused
  multiply-adds, their pairwise sum, a serial tail), so it equals the JAX
  render bit for bit. ``ks_scan(..., all_active=True)`` takes it.
- ``ks_scan_windows`` computes ``ks_scan_ref`` in the kernel's order
  (tests only): the active samples compacted, the two-point average of a
  window of them at once from the string as earlier windows left it, then
  the allpass's serial chain over the window.

Differentiable: on the card both launches are ``torch.autograd.Function``s
(:mod:`~pygmu2_tpu_torch.ops.diffable`) whose backward is ``ks_scan_bwd``,
the hand-written adjoint in ``csrc/ks_scan_bwd.cu`` (counted in
``ks_scan_bwd.launches``), one kernel for both orders; on the CPU
autograd differentiates the plain versions. ``ks_scan_bwd_ref`` is the
backward's plain version (``ks_blocked_bwd_ref`` the blocked order's: the
same adjoint, every sample active); ``ks_scan_bwd_pipelined`` computes it
in the kernel's schedule (tests and ``chip_smoke.py``): the tape's
cotangent a ring of L + 1 slots, a window's chain beside the adjoint of
the window after it and the seeds of the window before it. The string
has no channel axis: under ``torch.func.vmap`` it launches once per batch
member.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable
from pygmu2_tpu_torch.ops.xla_math import fmaf

# the longest string the kernel holds in shared memory (200 KB; a string
# below 0.862 Hz at 44.1 kHz is longer and stays in global memory)
MAX_KERNEL_L = 200 * 1024 // 4
# strings this short take the kernel's one-thread loop over every sample
SERIAL_MAX_L = 8
# the kernel's longest window, in active samples
MAX_WINDOW = 1024
# all-active calls on strings this long take the blocked order (the JAX
# KarplusStrongPE's ``delay_len >= 16`` test), in blocks of at most
# BLOCKED_MAX_B samples (``ks_blocked``'s ``max_block``)
BLOCKED_MIN_L = 16
BLOCKED_MAX_B = 512


def window_length(L: int) -> int:
    """Active samples per window of the kernel for a string of L: a window
    of W reads tape values of windows up to two before it when 2W + 1 <= L,
    so one window's averages form while the allpass walks the one before."""
    return min(MAX_WINDOW, (L - 1) // 2)


def ks_scan_ref(rho, act, buf, r, ap_in, ap_out, *, L, allpass_c, all_active=False):
    """Plain PyTorch version of :func:`ks_scan` (same arguments and
    result): :func:`ks_blocked_ref` where ``ks_scan`` takes the blocked
    order, else a Python loop over samples (keep T small)."""
    if all_active and L >= BLOCKED_MIN_L:
        return ks_blocked_ref(rho, buf, r, ap_in, ap_out, L=L, allpass_c=allpass_c)
    dev = rho.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())  # noqa: E731
    functional = diffable.transformed(rho, buf, ap_in, ap_out)  # under torch.func
    buf = buf.to(torch.float32).clone()
    c, ai, ao = f32(allpass_c), f32(ap_in), f32(ap_out)
    rr = int(r)  # advances only on active samples, known from the mask
    ys = []
    for rho_t, a in zip(rho.to(torch.float32), act.tolist()):
        if not a:
            ys.append(torch.zeros((), dtype=torch.float32, device=dev))
            continue
        rn = (rr + 1) % L
        out = rho_t * (buf[rr] + buf[rn]) * 0.5
        ap = fmaf(-c, ao, fmaf(c, out, ai))
        buf = diffable.put_row(buf, rr, ap, functional)
        rr, ai, ao = rn, out, ap
        ys.append(ap)
    y = torch.stack(ys) if ys else torch.zeros((0,), dtype=torch.float32, device=dev)
    return y, buf, torch.tensor(rr, dtype=torch.int32, device=dev), ai, ao


def ks_scan_windows(rho, act, buf, r, ap_in, ap_out, *, L, allpass_c):
    """:func:`ks_scan_ref` in the kernel's order (same arguments and
    result, equal bit for bit), in the kernel's windows (``window_length``;
    L - 1 for the strings it walks sample by sample)."""
    dev = rho.device
    f32 = torch.float32
    c = torch.as_tensor(allpass_c, dtype=f32, device=dev).reshape(())
    idx = torch.nonzero(act).flatten()  # active sample k is act's k-th True
    K = idx.numel()
    rho_c = rho.to(f32)[idx]
    W = L - 1 if L <= SERIAL_MAX_L else window_length(L)
    r0 = int(r)
    # the tape: S[j] = buf[(r0 + j) % L] for j < L, S[L + k] = sample k's output
    S = torch.cat([torch.roll(buf.to(f32), -r0), torch.empty(K, dtype=f32, device=dev)])
    last = torch.as_tensor(ap_in, dtype=f32, device=dev).reshape(())
    ap = torch.as_tensor(ap_out, dtype=f32, device=dev).reshape(())
    for k0 in range(0, K, W):
        n = min(W, K - k0)
        # sample k reads S[k] and S[k + 1], written by earlier windows
        out = rho_c[k0:k0 + n] * (S[k0:k0 + n] + S[k0 + 1:k0 + n + 1]) * 0.5
        P = fmaf(c, out, torch.cat([last[None], out[:-1]]))  # c * out + ap_in
        for i in range(n):  # the allpass: its one serial chain
            ap = fmaf(-c, ap, P[i])
            S[L + k0 + i] = ap
        last = out[-1]
    y = torch.zeros(rho.shape[0], dtype=f32, device=dev)
    y[idx] = S[L:]
    buf_out = torch.roll(S[K:], (r0 + K) % L)
    r_out = torch.tensor((r0 + K) % L, dtype=torch.int32, device=dev)
    return y, buf_out, r_out, last, ap


@functools.cache
def blocked_tables(L: int, allpass_c: float):
    """``ks_blocked``'s operators for a string of L: (B, the (B, B) float32
    lower-triangular matrix ``TRIL[j, k] = (-c)^(j-k)``, the (B,) float32
    ``(-c)^(j+1)``), formed in float64 numpy as the JAX package forms them."""
    B = min(L - 1, BLOCKED_MAX_B)
    jk = np.arange(B)[:, None] - np.arange(B)[None, :]
    tril = np.where(jk >= 0, (-float(allpass_c)) ** np.clip(jk, 0, None), 0.0)
    powv = (-float(allpass_c)) ** (np.arange(B) + 1)
    return B, tril.astype(np.float32), powv.astype(np.float32)


def xla_gemv(m, v):
    """``m @ v`` for a (M, K) float32 matrix and a (K,) vector, rounded as
    XLA's CPU program computes it (its tiled row-major GEMV, eight lanes):
    lane l sums ``m[i, k] * v[k]`` over k = l mod 8 below K - K % 8 by fused
    multiply-adds from 0, the lanes are summed pairwise (rows in the tiles
    of 8: ((l0 + l1) + (l2 + l3)) + ((l4 + l5) + (l6 + l7)); the rows after
    them: ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7))), and the
    K % 8 last columns, summed in order by fused multiply-adds from 0, are
    added last."""
    M, K = m.shape
    K8, M8 = K - K % 8, M - M % 8
    acc = torch.zeros((M, 8), dtype=torch.float32, device=m.device)
    for k0 in range(0, K8, 8):
        acc = fmaf(m[:, k0:k0 + 8], v[k0:k0 + 8], acc)
    a = acc.unbind(1)
    h = torch.cat([
        ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7])),
        ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7])),
    ])
    h = torch.cat([h[:M8], h[M + M8:]])
    e = torch.zeros(M, dtype=torch.float32, device=m.device)
    for k in range(K8, K):
        e = fmaf(m[:, k], v[k], e)
    return h + e


def ks_blocked_ref(rho, buf, r, ap_in, ap_out, *, L, allpass_c):
    """Plain PyTorch version of :func:`ks_scan` on a call whose samples are
    all active (the arguments but ``act``; the same result), for
    ``L >= BLOCKED_MIN_L``: the JAX package's ``ks_blocked`` op for op.
    Each block of B samples reads the string's B + 1 oldest values:
    ``out = rho * (W[j] + W[j + 1]) * 0.5``, ``u = c * out + out_prev``
    (``fma(c, out, ap_in)`` at j = 0), ``ap = fma((-c)^(j+1), ap_out,
    TRIL @ u)``, and the block's outputs
    become the string's newest."""
    dev = rho.device
    f32 = torch.float32
    T = rho.shape[0]
    B, tril, powv = blocked_tables(L, float(allpass_c))
    tril = torch.from_numpy(tril).to(dev)
    powv = torch.from_numpy(powv).to(dev)
    c = torch.tensor(np.float32(allpass_c), device=dev)
    nb = -(-T // B)
    rb = torch.cat([rho.to(f32), torch.zeros(nb * B - T, dtype=f32, device=dev)]).view(nb, B)
    r0 = int(r)
    W = buf.to(f32)[(r0 + torch.arange(L, device=dev)) % L]  # W[0]: the next read
    ai = torch.as_tensor(ap_in, dtype=f32, device=dev).reshape(())
    ao = torch.as_tensor(ap_out, dtype=f32, device=dev).reshape(())
    aps, outs = [], []
    for b in range(nb):
        out = (rb[b] * (W[:B] + W[1:B + 1])) * 0.5
        # u[0] = fma(c, out[0], ap_in); after it both terms are products
        # and LLVM fuses the left one, out[j - 1] = (rho * s) * 0.5, whose
        # product by 0.5 is exact: u[j] = round(c * out[j]) + out[j - 1]
        u = torch.cat([fmaf(c, out[:1], ai[None]), c * out[1:] + out[:-1]])
        ap = fmaf(powv, ao, xla_gemv(tril, u))
        W = torch.cat([W[B:], ap])
        ai, ao = out[-1], ap[-1]
        aps.append(ap)
        outs.append(out)
    y = torch.cat(aps)[:T]
    r2 = (r0 + T) % L
    if T >= L:
        buf2 = torch.roll(y[T - L:], r2)  # the slot of y[T - L] is r2
    else:
        buf2 = torch.index_put(buf.to(f32), ((r0 + torch.arange(T, device=dev)) % L,), y)
    return (y, buf2, torch.tensor(r2, dtype=torch.int32, device=dev),
            torch.cat(outs)[T - 1], y[T - 1])


def ks_scan(rho, act, buf, r, ap_in, ap_out, *, L, allpass_c, all_active=False):
    """Karplus-Strong string over T samples.

    rho: (T,) f32; act: (T,) bool; buf: (L,) f32; r: () int32 in [0, L);
    ap_in / ap_out: () f32. Returns (y (T,), buf' (L,), r' () int32,
    ap_in' () f32, ap_out' () f32). ``all_active`` (a host flag: every
    ``act`` is set) with ``L >= BLOCKED_MIN_L`` takes the blocked order of
    :func:`ks_blocked_ref`, as the JAX KarplusStrongPE does on such a
    block; else the per-sample order of :func:`ks_scan_ref`. CPU tensors
    take the plain version; CUDA tensors launch the kernel (one count in
    ``ks_scan.launches`` per call) or raise. Any L >= 2: a string longer
    than ``MAX_KERNEL_L`` lives in global memory on the card.
    """
    kw = dict(L=L, allpass_c=allpass_c)
    if rho.device.type == "cpu":
        return ks_scan_ref(rho, act, buf, r, ap_in, ap_out, all_active=all_active, **kw)
    if rho.device.type != "cuda":
        raise ValueError(f"no kernel for device {rho.device}")
    if all_active and L >= BLOCKED_MIN_L:
        return _differentiable_blocked(rho, buf, r, ap_in, ap_out, **kw)
    return _differentiable(rho, act, buf, r, ap_in, ap_out, **kw)


ks_scan.launches = 0
ks_scan.blocked_launches = 0  # of them, the blocked order's


def _launch(rho, act, buf, r, ap_in, ap_out, *, L, allpass_c):
    dev = rho.device
    if rho.dim() != 1 or rho.shape[0] < 1 or L < 2:
        raise ValueError(f"unsupported shape rho={tuple(rho.shape)} L={L}")
    (T,) = rho.shape
    rho = _ext.checked(rho, "rho", (T,), dev)
    buf = _ext.checked(buf, "buf", (L,), dev)
    ap_in = _ext.checked(ap_in.reshape(()), "ap_in", (), dev)
    ap_out = _ext.checked(ap_out.reshape(()), "ap_out", (), dev)
    if act.shape != (T,) or act.dtype != torch.bool or act.device != dev:
        raise ValueError("act must be a (T,) bool tensor on rho's device")
    act = act.contiguous()
    r = r.reshape(())
    if r.dtype != torch.int32 or r.device != dev:
        raise ValueError("r must be an int32 scalar tensor on rho's device")
    y = torch.empty((T,), dtype=torch.float32, device=dev)
    buf_out = torch.empty((L,), dtype=torch.float32, device=dev)
    r_out = torch.empty((), dtype=torch.int32, device=dev)
    ai_out = torch.empty((), dtype=torch.float32, device=dev)
    ao_out = torch.empty((), dtype=torch.float32, device=dev)
    idx = torch.empty((T,), dtype=torch.int32, device=dev)  # scratch: compaction
    rho_c = torch.empty((T,), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.ks_scan_launch(
            rho.data_ptr(), act.data_ptr(), buf.data_ptr(), r.data_ptr(),
            ap_in.data_ptr(), ap_out.data_ptr(), y.data_ptr(), buf_out.data_ptr(),
            r_out.data_ptr(), ai_out.data_ptr(), ao_out.data_ptr(), idx.data_ptr(),
            rho_c.data_ptr(), T, L,
            float(allpass_c), torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "ks_scan")
    ks_scan.launches += 1
    return y, buf_out, r_out, ai_out, ao_out


# the blocked order's tables on the card, uploaded once per string
_DEVICE_TABLES: dict = {}


def _launch_blocked(rho, buf, r, ap_in, ap_out, *, L, allpass_c):
    dev = rho.device
    if rho.dim() != 1 or rho.shape[0] < 1 or L < BLOCKED_MIN_L:
        raise ValueError(f"unsupported shape rho={tuple(rho.shape)} L={L}")
    (T,) = rho.shape
    rho = _ext.checked(rho, "rho", (T,), dev)
    buf = _ext.checked(buf, "buf", (L,), dev)
    ap_in = _ext.checked(ap_in.reshape(()), "ap_in", (), dev)
    ap_out = _ext.checked(ap_out.reshape(()), "ap_out", (), dev)
    r = r.reshape(())
    if r.dtype != torch.int32 or r.device != dev:
        raise ValueError("r must be an int32 scalar tensor on rho's device")
    key = (L, float(allpass_c), str(dev))
    if key not in _DEVICE_TABLES:
        B, tril, powv = blocked_tables(L, float(allpass_c))
        # TRIL is Toeplitz: its first column is every diagonal
        _DEVICE_TABLES[key] = (B, torch.from_numpy(np.ascontiguousarray(tril[:, 0])).to(dev),
                               torch.from_numpy(powv).to(dev))
    B, diag, powv = _DEVICE_TABLES[key]
    y = torch.empty((T,), dtype=torch.float32, device=dev)
    buf_out = torch.empty((L,), dtype=torch.float32, device=dev)
    r_out = torch.empty((), dtype=torch.int32, device=dev)
    ai_out = torch.empty((), dtype=torch.float32, device=dev)
    ao_out = torch.empty((), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.ks_blocked_launch(
            rho.data_ptr(), buf.data_ptr(), r.data_ptr(), ap_in.data_ptr(),
            ap_out.data_ptr(), diag.data_ptr(), powv.data_ptr(), y.data_ptr(),
            buf_out.data_ptr(), r_out.data_ptr(), ai_out.data_ptr(), ao_out.data_ptr(),
            T, L, B, float(allpass_c), torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "ks_scan")
    ks_scan.launches += 1
    ks_scan.blocked_launches += 1
    return y, buf_out, r_out, ai_out, ao_out


def ks_scan_bwd(rho, act, buf, r, y, gy, gbuf, gai, gao, *, L, allpass_c):
    """The cotangents of :func:`ks_scan`'s float inputs, in either order.

    Takes the forward's ``rho``, ``act`` (None: every sample active, the
    blocked order's calls), the string ``buf`` and read position ``r`` it
    was given and its output ``y``, and the cotangents ``gy`` (T,),
    ``gbuf`` (L,), ``gai`` () and ``gao`` () of y, buf', ap_in' and
    ap_out'; returns (grho (T,), gbuf_in (L,), gap_in (), gap_out ()).
    The allpass state's values are not needed: the string is linear in
    them. CPU tensors take the plain version; CUDA tensors launch the
    kernel in ``csrc/ks_scan_bwd.cu`` (one count in
    ``ks_scan_bwd.launches`` per call) or raise.
    """
    kw = dict(L=L, allpass_c=allpass_c)
    if rho.device.type == "cpu":
        return ks_scan_bwd_ref(rho, act, buf, r, y, gy, gbuf, gai, gao, **kw)
    if rho.device.type != "cuda":
        raise ValueError(f"no kernel for device {rho.device}")
    return _launch_bwd(rho, act, buf, r, y, gy, gbuf, gai, gao, **kw)


ks_scan_bwd.launches = 0
ks_scan_bwd.blocked_launches = 0  # of them, the blocked order's (act None)


def bwd_window(L: int) -> int:
    """Active samples per window of the adjoint's walk for a string of L:
    the forward's ``window_length`` (L - 1 for the strings the kernel
    walks sample by sample). A window's seeds (the tape cotangents of its
    outputs) are complete once every later sample is walked when it is at
    most L - 1 long, and need only the windows after the next one when
    2W + 1 <= L: they form while the chain walks the next one."""
    return L - 1 if L <= SERIAL_MAX_L else window_length(L)


def ks_scan_bwd_ref(rho, act, buf, r, y, gy, gbuf, gai, gao, *, L, allpass_c):
    """Plain PyTorch version of :func:`ks_scan_bwd` (same arguments and
    result), in the kernel's order and roundings, so equal to it bit for
    bit. Any window of 1 .. L - 1 samples gives the same bits: each tape
    slot takes its adds in one order whatever the window.

    Active samples compacted as k = 0 .. K - 1, the tape S as in
    :func:`ks_scan_windows` (S[j] = buf[(r + j) % L] for j < L, S[L + k] =
    sample k's output), G its cotangent, seeded with gbuf at the tape
    slots the string holds after the call. Walking k down, a window of
    ``bwd_window(L)`` samples at a time:

    - lam_k = (G[L + k] + gy_k) - c lam_{k+1} (at k = K - 1: + gao), the
      cotangent of sample k's allpass output; the window's one serial chain;
    - mu_k = c lam_k + lam_{k+1} (at k = K - 1: + gai), that of its
      two-point average;
    - grho_k = (mu_k (S[k] + S[k+1])) / 2, and G[k], then G[k + 1], gain
      mu_k (rho_k / 2).

    gap_in = lam_0, gap_out = -c lam_0; inactive samples get grho = 0."""
    dev = rho.device
    f32 = torch.float32
    c = torch.as_tensor(allpass_c, dtype=f32, device=dev).reshape(())
    T = rho.shape[0]
    idx = (torch.arange(T, device=dev) if act is None else torch.nonzero(act).flatten())
    K = idx.numel()
    rho_c, gy_c = rho.to(f32)[idx], gy.to(f32)[idx]
    r0 = int(r)
    S = torch.cat([torch.roll(buf.to(f32), -r0), y.to(f32)[idx]])
    G = torch.zeros(L + K + 1, dtype=f32, device=dev)
    G[K:K + L] = torch.roll(gbuf.to(f32), -((r0 + K) % L))
    grho_c = torch.zeros(K, dtype=f32, device=dev)
    gai = torch.as_tensor(gai, dtype=f32, device=dev).reshape(())
    gao = torch.as_tensor(gao, dtype=f32, device=dev).reshape(())
    lam_next, lam, W = gai, None, bwd_window(L)
    for k0 in reversed(range(0, K, W)):
        n = min(W, K - k0)
        g = G[L + k0:L + k0 + n] + gy_c[k0:k0 + n]
        lams = torch.empty(n, dtype=f32, device=dev)
        for i in range(n - 1, -1, -1):  # the serial chain
            lam = g[i] + gao if lam is None else g[i] + (-c) * lam
            lams[i] = lam
        mu = c * lams + torch.cat([lams[1:], lam_next[None]])
        m = mu * (rho_c[k0:k0 + n] * 0.5)
        grho_c[k0:k0 + n] = (mu * (S[k0:k0 + n] + S[k0 + 1:k0 + n + 1])) * 0.5
        G[k0:k0 + n] += m
        G[k0 + 1:k0 + n + 1] += m
        lam_next = lams[0]
    grho = torch.zeros(T, dtype=f32, device=dev)
    grho[idx] = grho_c
    gbuf_in = torch.roll(G[:L], r0)
    if lam is None:  # no active sample: the state passes through
        return grho, gbuf_in, gai.clone(), gao.clone()
    return grho, gbuf_in, lam_next, (-c) * lam_next


def ks_scan_bwd_pipelined(rho, act, buf, r, y, gy, gbuf, gai, gao, *, L, allpass_c):
    """:func:`ks_scan_bwd_ref` in the schedule of ``csrc/ks_scan_bwd.cu``
    (same arguments and result, equal bit for bit), for the tests and
    ``chip_smoke.py``: the tape's cotangent G a ring of L + 1 slots (G[m]
    at m mod (L + 1), a seed's slot cleared once read: it holds G[k - 1]
    next); windows of ``bwd_window(L)`` from the last, the call's last
    seed formed with + gao and the chain started from a zero whose product
    by -c is -0; beside window j's chain, in order, (1) mu, grho and the
    tape adds of window j + 1, slot by slot (G[k] + mu_k rho_k / 2, then
    + mu_{k-1} rho_{k-1} / 2) and (2) the seeds of window j - 1. Strings
    of L <= SERIAL_MAX_L: the kernel walks them sample by sample, in the
    plain version's order."""
    if L <= SERIAL_MAX_L:
        return ks_scan_bwd_ref(rho, act, buf, r, y, gy, gbuf, gai, gao, L=L,
                               allpass_c=allpass_c)
    dev = rho.device
    f32 = torch.float32
    c = torch.as_tensor(allpass_c, dtype=f32, device=dev).reshape(())
    T = rho.shape[0]
    idx = (torch.arange(T, device=dev) if act is None else torch.nonzero(act).flatten())
    K = idx.numel()
    rho_c, gy_c = rho.to(f32)[idx], gy.to(f32)[idx]
    r0 = int(r)
    S = torch.cat([torch.roll(buf.to(f32), -r0), y.to(f32)[idx]])  # the tape
    R = L + 1
    m = K + torch.arange(L + 1, device=dev)
    ring = torch.empty(R, dtype=f32, device=dev)
    ring[m % R] = torch.where(m < K + L, gbuf.to(f32)[(r0 + m) % L], torch.zeros((), device=dev))
    gai = torch.as_tensor(gai, dtype=f32, device=dev).reshape(())
    gao = torch.as_tensor(gao, dtype=f32, device=dev).reshape(())
    grho = torch.zeros(T, dtype=f32, device=dev)
    if K == 0:
        return grho, torch.roll(ring[:L], r0), gai.clone(), gao.clone()
    W = bwd_window(L)
    n_win = -(-K // W)
    grho_c = torch.empty(K, dtype=f32, device=dev)

    def span(j):
        return j * W, min(W, K - j * W)

    def seeds(j, last):
        k0, n = span(j)
        s = (L + k0 + torch.arange(n, device=dev)) % R
        g = ring[s] + gy_c[k0:k0 + n]
        ring[s] = 0.0
        if last:
            g[n - 1] = g[n - 1] + gao
        return g

    def adjoint(j, lw, after):
        k0, n = span(j)
        mu = c * lw + torch.cat([lw[1:], after[None]])
        m = mu * (rho_c[k0:k0 + n] * 0.5)
        grho_c[k0:k0 + n] = (mu * (S[k0:k0 + n] + S[k0 + 1:k0 + n + 1])) * 0.5
        s = (k0 + torch.arange(n + 1, device=dev)) % R
        g = ring[s]
        g[:n] = g[:n] + m
        g[1:] = g[1:] + m
        ring[s] = g

    seed = {n_win - 1: seeds(n_win - 1, True)}
    walked = {}
    lam = torch.copysign(torch.zeros((), device=dev), c)
    for j in range(n_win - 1, -2, -1):
        if j >= 0:  # the chain
            _, n = span(j)
            after = gai if j == n_win - 1 else lam
            lw = torch.empty(n, dtype=f32, device=dev)
            for i in range(n - 1, -1, -1):
                lam = seed[j][i] + (-c) * lam
                lw[i] = lam
            walked[j] = (lw, after)
            del seed[j]
        if j + 1 < n_win:  # beside it: (1) window j + 1, then (2) window j - 1's seeds
            adjoint(j + 1, *walked.pop(j + 1))
        if j >= 1:
            seed[j - 1] = seeds(j - 1, False)
    grho[idx] = grho_c
    return grho, torch.roll(ring[:L], r0), lam, (-c) * lam


def ks_blocked_bwd_ref(rho, buf, r, y, gy, gbuf, gai, gao, *, L, allpass_c):
    """The blocked order's adjoint: :func:`ks_scan_bwd_ref` with every
    sample active (same arguments but ``act``, same result). The blocked
    order computes the per-sample recurrence with other roundings (its
    allpass a matrix-vector product), so its exact derivative is the
    per-sample order's, taken at the blocked forward's own tape; the card
    runs the one backward kernel for both orders."""
    return ks_scan_bwd_ref(rho, None, buf, r, y, gy, gbuf, gai, gao, L=L,
                           allpass_c=allpass_c)


def _launch_bwd(rho, act, buf, r, y, gy, gbuf, gai, gao, *, L, allpass_c):
    dev = rho.device
    if rho.dim() != 1 or rho.shape[0] < 1 or L < 2:
        raise ValueError(f"unsupported shape rho={tuple(rho.shape)} L={L}")
    (T,) = rho.shape
    rho, y, gy = (_ext.checked(v, n, (T,), dev) for v, n in ((rho, "rho"), (y, "y"), (gy, "gy")))
    buf = _ext.checked(buf, "buf", (L,), dev)
    gbuf = _ext.checked(gbuf, "gbuf", (L,), dev)
    gai = _ext.checked(gai.reshape(()), "gai", (), dev)
    gao = _ext.checked(gao.reshape(()), "gao", (), dev)
    if act is not None:
        if act.shape != (T,) or act.dtype != torch.bool or act.device != dev:
            raise ValueError("act must be a (T,) bool tensor on rho's device")
        act = act.contiguous()
    r = r.reshape(())
    if r.dtype != torch.int32 or r.device != dev:
        raise ValueError("r must be an int32 scalar tensor on rho's device")
    grho = torch.empty((T,), dtype=torch.float32, device=dev)
    gbuf_in = torch.empty((L,), dtype=torch.float32, device=dev)
    gap_in = torch.empty((), dtype=torch.float32, device=dev)
    gap_out = torch.empty((), dtype=torch.float32, device=dev)
    # scratch: the compaction (the active samples' indices, and their rho,
    # gy and y), and the tape's cotangent (a ring of L + 1) when the string
    # is too long for shared memory
    idx = torch.empty((T,), dtype=torch.int32, device=dev)
    comp = torch.empty((3 * T if act is not None else 1,), dtype=torch.float32, device=dev)
    ring = torch.empty((L + 1 if L > MAX_KERNEL_L else 1,), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.ks_scan_bwd_launch(
            rho.data_ptr(), None if act is None else act.data_ptr(), buf.data_ptr(),
            r.data_ptr(), y.data_ptr(), gy.data_ptr(), gbuf.data_ptr(), gai.data_ptr(),
            gao.data_ptr(), grho.data_ptr(), gbuf_in.data_ptr(), gap_in.data_ptr(),
            gap_out.data_ptr(), idx.data_ptr(), comp.data_ptr(), ring.data_ptr(), T, L,
            bwd_window(L),
            float(allpass_c), torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "ks_scan_bwd")
    ks_scan_bwd.launches += 1
    ks_scan_bwd.blocked_launches += act is None
    return grho, gbuf_in, gap_in, gap_out


def _backward(args, outs, grads, **kw):
    rho, act, buf, r, ap_in, ap_out = args
    gy, gbuf, _, gai, gao = grads
    grho, gbuf_in, gap_in, gap_out = ks_scan_bwd(rho, act, buf, r, outs[0], gy, gbuf, gai, gao,
                                                 **kw)
    return grho, None, gbuf_in, None, gap_in.reshape(ap_in.shape), gap_out.reshape(ap_out.shape)


def _backward_blocked(args, outs, grads, **kw):
    rho, buf, r, ap_in, ap_out = args
    gy, gbuf, _, gai, gao = grads
    grho, gbuf_in, gap_in, gap_out = ks_scan_bwd(rho, None, buf, r, outs[0], gy, gbuf, gai, gao,
                                                 **kw)
    return grho, gbuf_in, None, gap_in.reshape(ap_in.shape), gap_out.reshape(ap_out.shape)


# the launches as torch.autograd.Functions, both backwards ks_scan_bwd (the
# string has no channel axis: under torch.func.vmap one launch per member)
_differentiable = diffable.kernel_function("ks_scan", _launch, _backward)
_differentiable_blocked = diffable.kernel_function("ks_scan (blocked)", _launch_blocked,
                                                   _backward_blocked)
