"""The fused audio-rate pass of the offline SoundFont render.

Counterpart of ``pygmu2_tpu.soundfont.filter_pallas``: one function,
``osc_filter_gain_mix``, takes the per-(block, voice) control rows of
``offline._gain_rows`` + ``offline._osc_rows``, a wavetable and the
(4, P) carried state, and returns the (T, 2) stereo mix and the state
after the last sample. It covers what the JAX package splits between
``osc_filter_gain_mix_pallas`` (small fonts) and
``osc_window_filter_gain_mix_pallas`` (large fonts): the wavetable is
read from device memory whatever its size.

- ``osc_filter_gain_mix`` is the wrapper. For CUDA tensors it launches
  the hand-written kernel in ``csrc/osc_filter_gain_mix.cu`` and counts
  the launch in ``osc_filter_gain_mix.launches``; for CPU tensors it runs
  the plain version.
- ``osc_filter_gain_mix_ref`` is the plain PyTorch version: the XLA
  branch of the JAX package's ``offline._audio_pass`` over the same rows,
  extended with the carried state.

State layout (as ``filter_pallas.osc_filter_gain_mix_pallas``): rows
``[y1; y2; x[-2]; x[-1]]`` — the biquad's last two outputs and the
oscillator's last two samples.
"""

from __future__ import annotations

import ctypes

import torch

from pygmu2_tpu_torch.ops.linrec import affine_scan_2
from pygmu2_tpu_torch.soundfont.params import NON_AUDIBLE

# Row order is the kernel's ABI: csrc/osc_filter_gain_mix.cu indexes the
# stacked planes by these positions.
_OSC_F32_ROWS = (
    "ratio", "base_frac", "loopf", "ls_val",
    "b0", "b1", "b2", "a1", "a2", "freshf", "pgl", "gl", "pgr", "gr",
)
_OSC_I32_ROWS = ("base_int", "loop_start", "loop_len", "smp_end")
# float planes of (B, P) scratch the kernel's three launches share
_SCRATCH_PLANES = 10
# the mixdown launch runs one thread per voice in one CUDA block
_MAX_VOICES = 256


def _oscillator(rows, wave, N: int):
    """(T, P) oscillator samples: read position, loop wrap, linear
    interpolation, validity (``offline._audio_pass`` XLA branch)."""
    B, P = rows["ratio"].shape

    def e(name):  # (B, P) -> (B, 1, P) broadcast plane
        return rows[name][:, None, :]

    steps = torch.arange(N, dtype=torch.float32, device=wave.device)[None, :, None]
    offset = e("base_frac") + steps * e("ratio")  # (B, N, P)
    off_int = torch.floor(offset)
    frac = offset - off_int
    abs_idx = e("base_int") + off_int.to(torch.int32)
    loop_start = e("loop_start")
    loop_len = e("loop_len")
    looping = e("loopf") > 0.5
    w = torch.remainder(abs_idx - loop_start, loop_len)
    idx_eff = torch.where(looping, loop_start + w, abs_idx)
    W = wave.shape[0]
    i0 = idx_eff.clamp(0, W - 2).long()
    w0 = wave[i0]
    w1 = wave[i0 + 1]
    # loop-end wrap of the second lerp tap: i0 + 1 -> loop_start
    wrap = looping & ((i0 + 1) >= (loop_start + loop_len))
    w1 = torch.where(wrap, e("ls_val"), w1)
    smp = (1.0 - frac) * w0 + frac * w1
    valid = looping | (abs_idx < e("smp_end"))
    return torch.where(valid, smp, 0.0).reshape(B * N, P)


def osc_filter_gain_mix_ref(rows, wave, N: int, state=None):
    """Plain PyTorch version of :func:`osc_filter_gain_mix`.

    rows: dict of (B, P) planes — f32 ``_OSC_F32_ROWS``, i32
    ``_OSC_I32_ROWS``; wave: (L,) f32; state: optional (4, P) f32.
    Returns ((T, 2) f32, (4, P) f32) with T = B * N.
    """
    B, P = rows["ratio"].shape
    T = B * N
    dev = wave.device
    xt = _oscillator(rows, wave, N)
    if state is None:
        state = torch.zeros((4, P), dtype=torch.float32, device=dev)

    # epoch boundaries: the first sample of a fresh block sees neither
    # the previous epoch's y-state nor its FIR inputs
    boundary = torch.zeros((B, N, P), dtype=torch.bool, device=dev)
    boundary[:, 0, :] = rows["freshf"] > 0.5
    boundary = boundary.reshape(T, P)

    def per_sample(name):  # (B, P) -> (T, P)
        return rows[name][:, None, :].expand(B, N, P).reshape(T, P)

    x1 = torch.cat([state[3:4], xt[:-1]])  # x[t-1]; x[-1] from the state
    x2 = torch.cat([state[2:4], xt[:-2]])  # x[t-2]
    b1_ok = ~boundary
    b2_ok = b1_ok & torch.cat([torch.ones_like(b1_ok[:1]), b1_ok[:-1]])
    fir = (
        per_sample("b0") * xt
        + per_sample("b1") * torch.where(b1_ok, x1, 0.0)
        + per_sample("b2") * torch.where(b2_ok, x2, 0.0)
    )
    keep = b1_ok.to(torch.float32)
    zeros = torch.zeros_like(fir)
    y, y_prev = affine_scan_2(
        -per_sample("a1") * keep, -per_sample("a2") * keep, keep, zeros,
        fir, zeros, s0=(state[0], state[1]),
    )

    # gains with per-block ramps
    ramp = torch.arange(N, dtype=torch.float32, device=dev)[None, :, None] / N

    def gain_grid(prev, cur):  # (B, P) each -> (T, P)
        prev, cur = rows[prev], rows[cur]
        audible = torch.maximum(prev, cur) >= NON_AUDIBLE
        const = torch.abs(cur - prev) < 1.0e-3
        g = torch.where(
            const[:, None, :],
            cur[:, None, :],
            prev[:, None, :] + (cur - prev)[:, None, :] * ramp,
        )
        return torch.where(audible[:, None, :], g, 0.0).reshape(T, P)

    left = torch.sum(gain_grid("pgl", "gl") * y, dim=1)
    right = torch.sum(gain_grid("pgr", "gr") * y, dim=1)
    state_out = torch.stack([y[-1], y_prev[-1], xt[-2], xt[-1]])
    return torch.stack([left, right], dim=1), state_out


def osc_filter_gain_mix(rows, wave, N: int, state=None):
    """Oscillator + biquad + gain ramps + stereo mix for B MIDI blocks.

    Same arguments and result as :func:`osc_filter_gain_mix_ref`. CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (one count in ``osc_filter_gain_mix.launches`` per call) or raise.
    """
    if wave.device.type == "cpu":
        return osc_filter_gain_mix_ref(rows, wave, N, state)
    if wave.device.type != "cuda":
        raise ValueError(f"no kernel for device {wave.device}")
    return _launch(rows, wave, N, state)


osc_filter_gain_mix.launches = 0


def _launch(rows, wave, N: int, state):
    from pygmu2_tpu_torch import _ext

    dev = wave.device
    B, P = rows["ratio"].shape
    L = wave.shape[0]
    if wave.dtype != torch.float32 or wave.dim() != 1 or L < 2:
        raise ValueError("wave must be a 1-D float32 tensor of >= 2 samples")
    if not 2 <= N or not 1 <= P <= _MAX_VOICES or B < 1:
        raise ValueError(f"unsupported shape B={B} P={P} N={N}")
    for k in _OSC_F32_ROWS + _OSC_I32_ROWS:
        if rows[k].shape != (B, P) or rows[k].device != dev:
            raise ValueError(f"row {k!r}: {tuple(rows[k].shape)} on {rows[k].device}")
    if state is None:
        state = torch.zeros((4, P), dtype=torch.float32, device=dev)
    if state.shape != (4, P) or state.dtype != torch.float32 or state.device != dev:
        raise ValueError("state must be a (4, P) float32 tensor on the wave's device")
    rows_f = torch.stack([rows[k].to(torch.float32) for k in _OSC_F32_ROWS])
    rows_i = torch.stack([rows[k].to(torch.int32) for k in _OSC_I32_ROWS])
    wave = wave.contiguous()
    state = state.contiguous()
    out = torch.empty((B * N, 2), dtype=torch.float32, device=dev)
    state_out = torch.empty((4, P), dtype=torch.float32, device=dev)
    scratch = torch.empty((_SCRATCH_PLANES, B, P), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.osc_filter_gain_mix_launch(
            rows_f.data_ptr(), rows_i.data_ptr(), wave.data_ptr(), L,
            state.data_ptr(), out.data_ptr(), state_out.data_ptr(),
            scratch.data_ptr(), B, P, N,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = ctypes.string_at(lib.pgt_cuda_error_string(err)).decode()
        raise RuntimeError(f"osc_filter_gain_mix launch failed: {msg} ({err})")
    osc_filter_gain_mix.launches += 1
    return out, state_out
