"""The audio-rate pass of the offline SoundFont render.

Counterpart of ``pygmu2_tpu.soundfont.filter_pallas``. Two functions:

``osc_filter_gain_mix`` takes the per-(block, voice) control rows of
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

``filter_gain_mix`` is the unfused pass (``filter_gain_mix_pallas``): it
takes (T, P) oscillator samples computed beforehand and the filter and
gain rows, and returns the (T, 2) mix of one render from zero state.

- ``filter_gain_mix`` is the wrapper: the kernel in
  ``csrc/filter_gain_mix.cu`` for CUDA tensors (counted in
  ``filter_gain_mix.launches``), the plain version for CPU tensors.
- ``filter_gain_mix_ref`` is the plain PyTorch version, op for op the TPU
  kernel's (``_make_kernel`` and ``_filter_mix_math``): chunks of 128
  samples, a Kogge-Stone scan of the block's constant transition per
  chunk, the epoch reset at a chunk's first sample, the filter state and
  FIR tail carried from chunk to chunk from zero.
"""

from __future__ import annotations

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
# float planes of (B, P) scratch the kernels' three launches share
_SCRATCH_PLANES = 10
# Row order of the unfused pass, the kernel's ABI as well
# (csrc/filter_gain_mix.cu); also the tail of _OSC_F32_ROWS.
_FILTER_ROWS = ("b0", "b1", "b2", "a1", "a2", "freshf", "pgl", "gl", "pgr", "gr")
# samples per chunk of filter_gain_mix_pallas
FILTER_CHUNK = 128
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
    _ext.raise_on_error(err, "osc_filter_gain_mix")
    osc_filter_gain_mix.launches += 1
    return out, state_out


def filter_gain_mix_ref(xt, rows, N: int):
    """Plain PyTorch version of :func:`filter_gain_mix` (same arguments and
    result)."""
    T, P = xt.shape
    C = FILTER_CHUNK
    cpb = N // C
    n_chunks = T // C
    dev = xt.device
    x = xt.reshape(n_chunks, C, P)
    r = {k: rows[k][:, None, :] for k in _FILTER_ROWS}  # (B, 1, P)
    blk = torch.arange(n_chunks, device=dev) // cpb

    # FIR inputs: the previous chunk's last two samples (zero before the
    # first), forgotten at an epoch's first sample
    first = (torch.arange(n_chunks, device=dev) % cpb == 0).float()[:, None, None]
    keep = 1.0 - first * (r["freshf"] > 0.5).float()[blk]  # (n_chunks, 1, P)
    tail = torch.cat([x.new_zeros((1, 2, P)), x[:-1, C - 2:]]) * keep
    x1 = torch.cat([tail[:, 1:2], x[:, : C - 1]], dim=1)
    x2 = torch.cat([tail[:, 0:2], x[:, : C - 2]], dim=1)
    fir = r["b0"][blk] * x + r["b1"][blk] * x1 + r["b2"][blk] * x2

    # the block's transition A and its squarings A^(2^s), (B, 1, P) each
    a = [-r["a1"], -r["a2"], torch.ones_like(r["a1"]), torch.zeros_like(r["a1"])]
    powers = []
    s = 1
    while s < C:
        powers.append(a)
        a11, a12, a21, a22 = a
        a = [a11 * a11 + a12 * a21, a11 * a12 + a12 * a22,
             a21 * a11 + a22 * a21, a21 * a12 + a22 * a22]
        s *= 2

    carry = xt.new_zeros((2, P))
    ys = []
    for i in range(n_chunks):
        b, k = int(blk[i]), keep[i]
        c1, c2 = carry[0:1] * k, carry[1:2] * k
        a11, a12 = powers[0][0][b], powers[0][1][b]
        v1 = torch.cat([fir[i, 0:1] + a11 * c1 + a12 * c2, fir[i, 1:]])
        v2 = torch.cat([c1, x.new_zeros((C - 1, P))])
        s = 1
        for a11, a12, a21, a22 in (tuple(m[b] for m in pw) for pw in powers):
            q1 = torch.cat([x.new_zeros((s, P)), v1[:-s]])
            q2 = torch.cat([x.new_zeros((s, P)), v2[:-s]])
            v1, v2 = a11 * q1 + a12 * q2 + v1, a21 * q1 + a22 * q2 + v2
            s *= 2
        carry = torch.cat([v1[C - 1:], v2[C - 1:]])
        ys.append(v1)
    y = torch.stack(ys)  # (n_chunks, C, P)

    pos = ((torch.arange(n_chunks, device=dev) % cpb) * C)[:, None, None] \
        + torch.arange(C, device=dev)[None, :, None]
    ramp = pos.float() * (1.0 / N)

    def gain(prev, cur):
        prev, cur = r[prev][blk], r[cur][blk]
        audible = torch.maximum(prev, cur) >= NON_AUDIBLE
        const = torch.abs(cur - prev) < 1.0e-3
        g = torch.where(const, cur, prev + (cur - prev) * ramp)
        return torch.where(audible, g, 0.0)

    left = torch.sum(gain("pgl", "gl") * y, dim=2).reshape(T)
    right = torch.sum(gain("pgr", "gr") * y, dim=2).reshape(T)
    return torch.stack([left, right], dim=1)


def filter_gain_mix(xt, rows, N: int):
    """Biquad + gain ramps + stereo mix of (T, P) oscillator samples.

    xt: (T, P) f32 with T = B * N; rows: dict of (B, P) f32 planes
    ``_FILTER_ROWS``; N a multiple of 128. Returns (T, 2) f32. CPU tensors
    take the plain version; CUDA tensors launch the kernel (one count in
    ``filter_gain_mix.launches`` per call) or raise.
    """
    if N % FILTER_CHUNK or xt.dim() != 2 or xt.shape[0] % N:
        raise ValueError(f"need N % {FILTER_CHUNK} == 0 and T % N == 0 (N={N}, "
                         f"xt {tuple(xt.shape)})")
    if xt.device.type == "cpu":
        return filter_gain_mix_ref(xt, rows, N)
    if xt.device.type != "cuda":
        raise ValueError(f"no kernel for device {xt.device}")
    return _launch_filter(xt, rows, N)


filter_gain_mix.launches = 0


def _launch_filter(xt, rows, N: int):
    from pygmu2_tpu_torch import _ext

    dev = xt.device
    T, P = xt.shape
    B = T // N
    if not 1 <= P <= _MAX_VOICES:
        raise ValueError(f"unsupported voice count P={P}")
    xt = _ext.checked(xt, "xt", (T, P), dev)
    stacked = torch.stack([_ext.checked(rows[k], f"row {k!r}", (B, P), dev)
                           for k in _FILTER_ROWS])
    out = torch.empty((T, 2), dtype=torch.float32, device=dev)
    scratch = torch.empty((_SCRATCH_PLANES, B, P), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.filter_gain_mix_launch(
            xt.data_ptr(), stacked.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            B, P, N, torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "filter_gain_mix")
    filter_gain_mix.launches += 1
    return out
