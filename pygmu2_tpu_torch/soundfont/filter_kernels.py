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

- ``osc_filter_gain_mix_cut`` computes the same in the kernel's order, in
  torch ops: each segment of ``OSC_SEG`` samples of a block run from zero
  state, its map composed with its group's earlier ones in the kernel's
  fixed order, the re-run from the entering state, and the mix summed over
  ``OSC_VOICES`` voices as the kernel's butterfly adds them, then over the
  blocks of voices in order. The CPU tests hold it to the plain version and
  the JAX package's kernels; on the card it is the kernel's reference order.

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
- ``filter_gain_mix_cut`` computes the same in the kernel's order, in
  torch ops: the fused pass's segments (``osc_filter_gain_mix_cut``; both
  kernels are the segment pass of ``csrc/filter_pass.cuh``) over ``xt``
  from zero state.
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
# the segment pass's cut (csrc/filter_pass.cuh kSeg, kV, kGroup), both
# kernels': samples of a block per segment, voices per CUDA block, segments
# per group of entering states
OSC_SEG, OSC_VOICES, OSC_GROUP = 512, 32, 32
# Row order of the unfused pass, the kernel's ABI as well
# (csrc/filter_pass.cuh FilterRow); also the tail of _OSC_F32_ROWS.
_FILTER_ROWS = ("b0", "b1", "b2", "a1", "a2", "freshf", "pgl", "gl", "pgr", "gr")
# samples per chunk of filter_gain_mix_pallas
FILTER_CHUNK = 128
# voices a call takes (the JAX package's kernels take 128)
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


def _osc_scratch_sizes(B: int, P: int, N: int) -> tuple[int, int]:
    """(floats, ints) of the fused kernel's scratch: a map of 8 floats per
    segment and voice, an entering state of 2 per group and voice, and with
    more than ``OSC_VOICES`` voices a partial mix per segment and block of
    voices; the ticket, a count per segment and the flags of the maps and
    entering states."""
    S, G = -(-N // OSC_SEG), -(-P // OSC_VOICES)
    nseg = B * S
    groups = -(-nseg // OSC_GROUP)
    n_f = nseg * P * 8 + groups * P * 2 + (nseg * G * 2 * OSC_SEG if G > 1 else 0)
    return n_f, 1 + nseg + nseg * P + groups * P


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
    n_f, n_i = _osc_scratch_sizes(B, P, N)
    scratch_f = torch.empty((n_f,), dtype=torch.float32, device=dev)
    scratch_i = torch.empty((n_i,), dtype=torch.int32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.osc_filter_gain_mix_launch(
            rows_f.data_ptr(), rows_i.data_ptr(), wave.data_ptr(), L,
            state.data_ptr(), out.data_ptr(), state_out.data_ptr(),
            scratch_f.data_ptr(), n_f, scratch_i.data_ptr(), n_i, B, P, N,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "osc_filter_gain_mix")
    osc_filter_gain_mix.launches += 1
    return out, state_out


def _matmul(a, b):
    """The 2x2 product a b of matrices (m11, m12, m21, m22)."""
    a11, a12, a21, a22 = a
    b11, b12, b21, b22 = b
    return (a11 * b11 + a12 * b21, a11 * b12 + a12 * b22,
            a21 * b11 + a22 * b21, a21 * b12 + a22 * b22)


def _then(f, g):
    """The affine map g after f; a map (z1, z2, m11, m12, m21, m22) takes
    the biquad's output state s = (y[n-1], y[n-2]) to z + m s."""
    return (*_apply(g, *f[:2]), *_matmul(g[2:], f[2:]))


def _apply(f, s1, s2):
    z1, z2, m11, m12, m21, m22 = f
    return z1 + m11 * s1 + m12 * s2, z2 + m21 * s1 + m22 * s2


def _where(cond, f, g):
    return tuple(torch.where(cond, a, b) for a, b in zip(f, g))


def osc_filter_gain_mix_cut(rows, wave, N: int, state=None):
    """:func:`osc_filter_gain_mix_ref` in the kernel's order (same
    arguments and result): the biquad cut into segments of ``OSC_SEG``
    samples, each run from zero state, the entering states composed in the
    kernel's fixed order, each segment re-run from its entering state, and
    the mix summed as the kernel sums it."""
    B, P = rows["ratio"].shape
    if state is None:
        state = torch.zeros((4, P), dtype=torch.float32, device=wave.device)
    x = _oscillator(rows, wave, N).reshape(B, N, P)
    ramp = torch.arange(N, dtype=torch.float32, device=wave.device)[None, :, None] / N
    return _segment_cut(x, rows, state, ramp)


def filter_gain_mix_cut(xt, rows, N: int):
    """:func:`filter_gain_mix_ref` in its kernel's order (same arguments and
    result): the segment pass of :func:`osc_filter_gain_mix_cut` over
    ``xt``, from zero state, its gain ramps at ``n * (1 / N)``."""
    T, P = xt.shape
    state = torch.zeros((4, P), dtype=torch.float32, device=xt.device)
    ramp = torch.arange(N, dtype=torch.float32, device=xt.device)[None, :, None] * (1.0 / N)
    return _segment_cut(xt.reshape(T // N, N, P), rows, state, ramp)[0]


def _segment_cut(x, rows, state, ramp):
    """The segment pass (csrc/filter_pass.cuh) in torch ops over (B, N, P)
    input samples ``x``, from the (4, P) ``state``, with the gain ramps'
    (1, N, 1) positions ``ramp``: ((B * N, 2) mix, (4, P) state after)."""
    B, N, P = x.shape
    dev = x.device
    S, G = -(-N // OSC_SEG), -(-P // OSC_VOICES)
    nseg = B * S
    fresh = rows["freshf"] > 0.5  # (B, P)
    b0, b1, b2, a1, a2 = (rows[k] for k in ("b0", "b1", "b2", "a1", "a2"))
    zero, one = torch.zeros_like(a1), torch.ones_like(a1)

    # run 1, segment by segment (k: the segment's place in its block): the
    # FIR line, the feedback from zero state, and the segment's map
    firs, maps = [], []
    for k in range(S):
        n0, n = k * OSC_SEG, min(OSC_SEG, N - k * OSC_SEG)
        if n0 > 0:
            x2, x1 = x[:, n0 - 2], x[:, n0 - 1]
        else:  # the block before's last samples, the state's before block 0
            x2 = torch.where(fresh, 0.0, torch.cat([state[2:3], x[:-1, N - 2]]))
            x1 = torch.where(fresh, 0.0, torch.cat([state[3:4], x[:-1, N - 1]]))
        y1 = y2 = zero
        fir = []
        for i in range(n):
            xi = x[:, n0 + i]
            f = b0 * xi + b1 * x1 + b2 * x2
            y1, y2 = f - a1 * y1 - a2 * y2, y1
            x2, x1 = x1, xi
            fir.append(f)
        firs.append(torch.stack(fir, dim=1))
        # M = A^n for A = [[-a1, -a2], [1, 0]], by squaring as the kernel does;
        # a fresh block's first segment forgets its entering state (M = 0)
        m, pw, e = (one, zero, zero, one), (-a1, -a2, one, zero), n
        while e:
            if e & 1:
                m = _matmul(m, pw)
            pw, e = _matmul(pw, pw), e >> 1
        if k == 0:
            m = tuple(torch.where(fresh, 0.0, v) for v in m)
        maps.append((y1, y2, *m))
    # (nseg, P) planes in the kernel's segment order: seg = b * S + k
    own = tuple(torch.stack([mp[c] for mp in maps], dim=1).reshape(nseg, P) for c in range(6))
    fresh_seg = torch.cat([fresh[:, None], torch.zeros((B, S - 1, P), dtype=torch.bool,
                                                       device=dev)], dim=1).reshape(nseg, P)
    seg = torch.arange(nseg, device=dev)
    first = seg // OSC_GROUP * OSC_GROUP

    # each segment's composition of its group's earlier maps: four at a time
    # (a producer warp of the kernel each), then those in order
    ones, zeros = torch.ones((nseg, P), device=dev), torch.zeros((nseg, P), device=dev)
    ident = (zeros, zeros, ones, zeros, zeros, ones)
    composed = ident
    for w in range(OSC_GROUP // 4):
        q = ident
        for t in range(4):
            k = first + 4 * w + t
            earlier = tuple(c[k.clamp(max=nseg - 1)] for c in own)
            q = _where((k < seg)[:, None], _then(q, earlier), q)
        composed = _where((first + 4 * w < seg)[:, None], _then(composed, q), composed)
    reset = (composed[2] == 0) & (composed[3] == 0) & (composed[4] == 0) & (composed[5] == 0)

    # the entering states; each group's from the group before's last segment
    s_in1, s_in2 = torch.empty((nseg, P), device=dev), torch.empty((nseg, P), device=dev)
    g1, g2 = state[0], state[1]
    for lo in range(0, nseg, OSC_GROUP):
        hi = min(nseg, lo + OSC_GROUP)
        c = tuple(v[lo:hi] for v in composed)
        e1, e2 = _apply(c, g1, g2)
        e1 = torch.where(reset[lo:hi], c[0], e1)
        e2 = torch.where(reset[lo:hi], c[1], e2)
        s_in1[lo:hi] = torch.where(fresh_seg[lo:hi], 0.0, e1)
        s_in2[lo:hi] = torch.where(fresh_seg[lo:hi], 0.0, e2)
        g1, g2 = _apply(tuple(v[hi - 1] for v in own), s_in1[hi - 1], s_in2[hi - 1])
    s_in1, s_in2 = s_in1.reshape(B, S, P), s_in2.reshape(B, S, P)

    # run 2 from the entering states
    ys = []
    for k in range(S):
        y1, y2 = s_in1[:, k], s_in2[:, k]
        out = []
        for i in range(firs[k].shape[1]):
            y1, y2 = firs[k][:, i] - a1 * y1 - a2 * y2, y1
            out.append(y1)
        ys.append(torch.stack(out, dim=1))
    y = torch.cat(ys, dim=1)  # (B, N, P)

    # the gain ramps; the sum over each block of OSC_VOICES voices as the
    # kernel's butterfly adds it (halves), then over the blocks in order
    def mixed(prev, cur):
        prev, cur = rows[prev][:, None, :], rows[cur][:, None, :]
        g = torch.where(torch.abs(cur - prev) < 1.0e-3, cur, prev + (cur - prev) * ramp)
        g = torch.where(torch.maximum(prev, cur) >= NON_AUDIBLE, g, 0.0)
        v = torch.nn.functional.pad(g * y, (0, G * OSC_VOICES - P)).reshape(B, N, G, -1)
        while v.shape[-1] > 1:
            v = v[..., : v.shape[-1] // 2] + v[..., v.shape[-1] // 2:]
        acc = v[..., 0, 0]
        for h in range(1, G):
            acc = acc + v[..., h, 0]
        return acc.reshape(B * N)

    out = torch.stack([mixed("pgl", "gl"), mixed("pgr", "gr")], dim=1)
    state_out = torch.stack([y[-1, -1], y[-1, -2], x[-1, -2], x[-1, -1]])
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
    n_f, n_i = _osc_scratch_sizes(B, P, N)
    scratch_f = torch.empty((n_f,), dtype=torch.float32, device=dev)
    scratch_i = torch.empty((n_i,), dtype=torch.int32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.filter_gain_mix_launch(
            xt.data_ptr(), stacked.data_ptr(), out.data_ptr(), scratch_f.data_ptr(), n_f,
            scratch_i.data_ptr(), n_i, B, P, N, torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "filter_gain_mix")
    filter_gain_mix.launches += 1
    return out
