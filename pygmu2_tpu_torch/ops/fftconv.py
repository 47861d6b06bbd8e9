"""Batched overlap-save FFT convolution primitive.

Counterpart of ``pygmu2_tpu.ops.fftconv`` (reference counterparts:
src/pygmu2/convolve_pe.py:285-340, spatial_pe.py:465-519 — sequential
overlap-save loops with carried tails). The caller supplies the input
window including the (L−1)-sample history, and every frame transforms in
one batched ``torch.fft.rfft`` (cuFFT on the card, pocketfft on the CPU)
— no sequential dependency.
"""

from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def framed_conv(x_window, h, out_len: int, nfft: int | None = None):
    """Convolve with history: returns ``y[t] = Σ_k h[k]·x[t−k]``.

    Args:
        x_window: (out_len + L − 1, C) input covering the history; row
            L−1 corresponds to output sample 0.
        h: (L, C) or (L, 1) FIR (broadcasts over channels when mono).
        out_len: number of output samples.
        nfft: FFT size (≥ L); default next_pow2(max(2048, 2L)).

    Returns:
        (out_len, C) float32 output.
    """
    L = h.shape[0]
    tail = L - 1
    C = x_window.shape[1]
    if nfft is None:
        # 2L, not L: nfft == next_pow2(L) degenerates to hop == 1 when L
        # is a power of two; the output is the same for any nfft >= L
        nfft = next_pow2(max(2048, 2 * L))
    hop = nfft - tail
    n_frames = -(-out_len // hop)

    pad = n_frames * hop + nfft - (out_len + tail)
    xp = torch.cat([x_window, x_window.new_zeros((pad, C))])
    # frames (n_frames, nfft, C): frame i is xp[i*hop : i*hop + nfft]
    if tail <= hop:
        # overlapping windows as two reshapes of slices (no index gather)
        a = xp[: n_frames * hop].reshape(n_frames, hop, C)
        b = xp[hop : hop + n_frames * hop].reshape(n_frames, hop, C)
        frames = torch.cat([a, b[:, :tail]], dim=1)
    else:  # a caller-forced small nfft
        idx = (torch.arange(n_frames, device=xp.device)[:, None] * hop
               + torch.arange(nfft, device=xp.device)[None, :])
        frames = xp[idx]
    frames = frames.transpose(1, 2)  # the FFT axis minor

    H = torch.fft.rfft(h.T, n=nfft, dim=-1)  # (hC, bins)
    X = torch.fft.rfft(frames, dim=-1)  # (n_frames, C, bins)
    Y = X * (H[None, 0:1] if h.shape[1] == 1 else H[None])
    y = torch.fft.irfft(Y, n=nfft, dim=-1)  # (n_frames, C, nfft)
    valid = y[:, :, tail : tail + hop].transpose(1, 2).reshape(n_frames * hop, -1)
    return valid[:out_len].to(torch.float32)
