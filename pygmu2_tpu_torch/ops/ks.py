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
  the JAX package's ``ks_scan_ref`` op order, float32.
- ``ks_scan_windows`` computes the same in the kernel's order (tests
  only): the active samples compacted, the two-point average of a window
  of them at once from the string as earlier windows left it, then the
  allpass's serial chain over the window.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext

# the longest string the kernel holds in shared memory (200 KB; a string
# below 0.862 Hz at 44.1 kHz is longer and stays in global memory)
MAX_KERNEL_L = 200 * 1024 // 4
# strings this short take the kernel's one-thread loop over every sample
SERIAL_MAX_L = 8
# the kernel's longest window, in active samples
MAX_WINDOW = 1024


def window_length(L: int) -> int:
    """Active samples per window of the kernel for a string of L: a window
    of W reads tape values of windows up to two before it when 2W + 1 <= L,
    so one window's averages form while the allpass walks the one before."""
    return min(MAX_WINDOW, (L - 1) // 2)


def ks_scan_ref(rho, act, buf, r, ap_in, ap_out, *, L, allpass_c):
    """Plain PyTorch version of :func:`ks_scan` (same arguments and
    result). A Python loop over samples: keep T small."""
    dev = rho.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())  # noqa: E731
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
        ap = c * out + ai - c * ao
        buf[rr] = ap
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
        P = c * out + torch.cat([last[None], out[:-1]])  # c * out + ap_in
        for i in range(n):  # the allpass: its one serial chain
            ap = P[i] - c * ap
            S[L + k0 + i] = ap
        last = out[-1]
    y = torch.zeros(rho.shape[0], dtype=f32, device=dev)
    y[idx] = S[L:]
    buf_out = torch.roll(S[K:], (r0 + K) % L)
    r_out = torch.tensor((r0 + K) % L, dtype=torch.int32, device=dev)
    return y, buf_out, r_out, last, ap


def ks_scan(rho, act, buf, r, ap_in, ap_out, *, L, allpass_c):
    """Karplus-Strong string over T samples.

    rho: (T,) f32; act: (T,) bool; buf: (L,) f32; r: () int32 in [0, L);
    ap_in / ap_out: () f32. Returns (y (T,), buf' (L,), r' () int32,
    ap_in' () f32, ap_out' () f32). CPU tensors take the plain version;
    CUDA tensors launch the kernel (one count in ``ks_scan.launches`` per
    call) or raise. Any L >= 2: a string longer than ``MAX_KERNEL_L``
    lives in global memory on the card.
    """
    kw = dict(L=L, allpass_c=allpass_c)
    if rho.device.type == "cpu":
        return ks_scan_ref(rho, act, buf, r, ap_in, ap_out, **kw)
    if rho.device.type != "cuda":
        raise ValueError(f"no kernel for device {rho.device}")
    return _launch(rho, act, buf, r, ap_in, ap_out, **kw)


ks_scan.launches = 0


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
