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

A launch recorded for a backward (through the Function) also writes the
forward's checkpoints: each channel's entering state every
``CHECKPOINT_EVERY`` samples, a (ceil(T / K), 9, C) residual from which
the backward kernel re-walks its chunks in parallel; a launch outside
the Function (no gradient, no ``torch.func``) writes none. A no-grad call
under ``torch.func.vmap`` still goes through the Function and so writes
them too, though nothing reads them. ``ladder_checkpoints_ref`` (the
checkpoints' plain version) and ``ladder_scan_bwd_chunked`` (the backward
in the kernel's order) serve tests and ``chip_smoke.py`` only.

State rows: z0[0..3], z1[0..3], old (the previous input sample).
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable

# Samples between two checkpoints of the forward. The kernel writes them
# at the start of its 32-sample stages, so a multiple of 32. K trades a
# chunk's serial re-walk in the backward (~K x 400 cycles, twice) against
# the serial carry over the ceil(T / K) chunks (a 9 x 9 matrix-vector
# product each, ~70 cycles).
CHECKPOINT_EVERY = 32
_MAX_SHARED = 232448  # bytes of shared memory a CUDA block may use


def _bwd_shared_bytes(os_n: int, every: int, per: int = 3, rewalk: bool = False,
                      steps_global: bool = False) -> int:
    """The backward kernel's shared memory (csrc/ladder_scan_bwd.cu,
    item_floats): ``per`` chunks a CUDA block, each (6 os_n + 7) floats a
    sample; with ``rewalk`` 16 floats a sample (its inputs and entering
    state) and one sample's steps, 6 os_n floats, unless those are in
    device memory (``steps_global``)."""
    if rewalk:
        item = every * 16 + (0 if steps_global else 6 * os_n)
    else:
        item = every * (6 * os_n + 7)
    return per * (item | 1) * 4


def _bwd_layout(os_n: int, every: int) -> tuple[int, bool, bool]:
    """The backward kernel's layout, (chunks a CUDA block, rewalk,
    steps_global): the first that fits in shared memory of three chunks
    keeping their steps (os_n up to 99 at 32 samples a chunk), one chunk
    keeping them (to 301), three chunks re-walking each sample's steps from
    its entering state (to ~3100), one (to ~9600), and past that one chunk
    with a sample's steps in device memory. Every layout gives the same
    bits."""
    for per, rewalk in ((3, False), (1, False), (3, True), (1, True)):
        if _bwd_shared_bytes(os_n, every, per, rewalk) <= _MAX_SHARED:
            return per, rewalk, False
    return 1, True, True


_C1, _C2 = 0.76923077, 0.23076923  # the stages' trapezoidal weights
# d mix / d stage m and d mix / d u, by response mode (of _mode_mix)
_MIX_GRADS = {0: ((0, 0, 0, 1), 0), 1: ((0, 1, 0, 0), 0), 2: ((0, 4, -8, 4), 0),
              3: ((2, -2, 0, 0), 0), 4: ((-4, 6, -4, 1), 1), 5: ((-2, 1, 0, 0), 1)}


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


def ladder_checkpoints_ref(x, al, qa, ki, dsc, state, *, every=CHECKPOINT_EVERY, **kw):
    """Plain version of the forward's checkpoints: the entering states of
    samples 0, every, 2 every, ... as (ceil(T / every), 9, C), from
    :func:`ladder_scan_ref` run chunk by chunk (the same ops as one call)."""
    out = []
    for t0 in range(0, x.shape[0], every):
        out.append(state)
        _, state = ladder_scan_ref(*(v[t0:t0 + every] for v in (x, al, qa, ki, dsc)), state,
                                   **kw)
    return torch.stack(out)


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
    return _differentiable(x, al, qa, ki, dsc, state, **kw)[:2]


ladder_scan.launches = 0


def ladder_scan_bwd(x, al, qa, ki, dsc, state, gy, gstate, checkpoints=None, *, os_n, pbg,
                    mode_index, input_threshold, state_decay):
    """The cotangents of :func:`ladder_scan`'s inputs.

    Takes the forward's arguments, the cotangents ``gy`` (T, C) and
    ``gstate`` (9, C) of its two outputs and the forward's checkpoints
    (the kernel needs them; the plain version does not read them);
    returns (gx (T, C), gal, gqa, gki, gdsc (each (T,), summed over the
    channels), gstate_in (9, C)). CPU tensors take the plain version;
    CUDA tensors launch the kernel (one count in
    ``ladder_scan_bwd.launches`` per call, which is four launches: the
    chunks' transfers, the carry, the final walks, the channel sum) or
    raise.
    """
    kw = dict(os_n=os_n, pbg=pbg, mode_index=mode_index,
              input_threshold=input_threshold, state_decay=state_decay)
    if x.device.type == "cpu":
        return ladder_scan_bwd_ref(x, al, qa, ki, dsc, state, gy, gstate, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if checkpoints is None:
        raise ValueError("ladder_scan_bwd on the card needs the checkpoints of the forward "
                         "launch recorded for a backward")
    return _launch_bwd(x, al, qa, ki, dsc, checkpoints, gy, gstate, **kw)


ladder_scan_bwd.launches = 0


def ladder_scan_bwd_ref(x, al, qa, ki, dsc, state, gy, gstate, checkpoints=None, **kw):
    """Plain PyTorch version of :func:`ladder_scan_bwd`: autograd of
    :func:`ladder_scan_ref` (same arguments and result; the checkpoints
    are not read). The columns may also be (T, C), one per channel; their
    cotangents are then (T, C)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, al, qa, ki, dsc, state)]
        y, st = ladder_scan_ref(*ins, **kw)
        return torch.autograd.grad((y, st), ins, (gy, gstate), allow_unused=True,
                                   materialize_grads=True)


# ---- the backward in the kernel's order, in torch ops ----


def _rewalk(st, xs, cs, valid, *, os_n, pbg, input_threshold, state_decay):
    """The forward from the chunks' entering states ``st`` (nine (n, C)
    tensors), sample by sample over all chunks at once, rounded as
    :func:`ladder_scan_ref`; returns each sample's decay and, for each
    oversampled step, (u, w, pre): w = z1[3] - pbg in_i and pre[m] stage
    m's value before its alpha product. A sample past T keeps the state."""
    recip = 1.0 / os_n
    dec = torch.tensor(state_decay, dtype=torch.float32, device=xs.device)
    one = torch.ones((), dtype=torch.float32, device=xs.device)
    z0, z1, old = list(st[:4]), list(st[4:8]), st[8]
    decays, steps = [], []
    for i in range(xs.shape[1]):
        a, q, k, d = (col[:, i, None] for col in cs)
        in_s = xs[:, i] * d
        decay = torch.where(in_s.abs() < input_threshold, dec, one)
        n0, n1, n_old = [v * decay for v in z0], [v * decay for v in z1], old * decay
        step = []
        for s_idx in range(os_n):
            interp = s_idx * recip
            in_i = interp * n_old + (1.0 - interp) * in_s
            w = n1[3] - pbg * in_i
            u = torch.tanh(in_i - w * k * q)
            prev, pre = u, []
            for m in range(4):
                p = prev * _C1 + _C2 * n0[m] - n1[m]
                ft = p * a + n1[m]
                pre.append(p)
                n1[m], n0[m], prev = ft, prev, ft
            step.append((u, w, pre))
        ok = valid[:, i, None]
        z0 = [torch.where(ok, v, o) for v, o in zip(n0, z0)]
        z1 = [torch.where(ok, v, o) for v, o in zip(n1, z1)]
        old = torch.where(ok, in_s, old)
        decays.append(decay)
        steps.append(step)
    return decays, steps


def _adjoint(g, gy, decays, steps, xs, cs, valid, *, os_n, pbg, mode_index, lanes):
    """The cotangent walked back over the chunks' samples, the last first,
    in csrc/ladder_scan_bwd.cu's op order (every op rounded once). ``g``:
    the nine cotangents of the state after the chunks' last samples, (n,
    C), or (n, 10, C) with ``lanes`` (the transfer's ten lanes); ``gy``
    shaped alike with the sample axis second. Returns the cotangents of
    the chunks' entering states and, without ``lanes``, gx (n, K, C) and
    the columns' per-channel parts (4, n, K, C)."""
    recip = 1.0 / os_n
    d_mix, d_u = _MIX_GRADS[mode_index]

    def lane(v):  # a (n, C) value against (n, 10, C) cotangents
        return v[:, None] if lanes else v

    g0, g1, gold = list(g[:4]), list(g[4:8]), g[8]
    gx, parts = [], []
    for i in reversed(range(xs.shape[1])):
        a, q, k, d = (lane(col[:, i, None]) for col in cs)
        gmix = gy[:, i] * recip
        g_in, g_old = gold, 0.0
        ga = gq = gk = 0.0
        n0, n1 = list(g0), list(g1)
        for s_idx in reversed(range(os_n)):
            u, w, pre = steps[i][s_idx]
            u, w, pre = lane(u), lane(w), [lane(p) for p in pre]
            interp = s_idx * recip
            gft = [n1[m] + d_mix[m] * gmix for m in range(4)]
            gu = d_u * gmix
            for m in reversed(range(4)):
                gpre = gft[m] * a
                ga = ga + gft[m] * pre[m]
                gprev = n0[m] + gpre * _C1
                n0[m] = gpre * _C2
                n1[m] = gft[m] - gpre
                if m > 0:
                    gft[m - 1] = gft[m - 1] + gprev
                else:
                    gu = gu + gprev
            gv = gu * (1.0 - u * u)  # tanh
            gwq = -gv  # of (w k) q
            gq = gq + gwq * (w * k)
            gwk = gwq * q
            gk = gk + gwk * w
            gw = gwk * k
            n1[3] = n1[3] + gw
            gi = gv - pbg * gw  # of in_i
            g_old = g_old + interp * gi
            g_in = g_in + (1.0 - interp) * gi
        ok, dec = lane(valid[:, i, None]), lane(decays[i])
        g0 = [torch.where(ok, v * dec, o) for v, o in zip(n0, g0)]
        g1 = [torch.where(ok, v * dec, o) for v, o in zip(n1, g1)]
        gold = torch.where(ok, g_old * dec, gold)
        if not lanes:
            zero = torch.zeros_like(g_in)
            gx.append(g_in * d)
            parts.append([ga + zero, gq + zero, gk + zero, g_in * xs[:, i]])
    g_start = [*g0, *g1, gold]
    if lanes:
        return g_start, None, None
    return (g_start, torch.stack(gx[::-1], 1),
            torch.stack([torch.stack(p, 1) for p in zip(*parts[::-1])]))


def ladder_scan_bwd_chunked(x, al, qa, ki, dsc, state, gy, gstate, checkpoints=None, *,
                            every=CHECKPOINT_EVERY, os_n, pbg, mode_index, input_threshold,
                            state_decay):
    """:func:`ladder_scan_bwd` in the kernel's order (same arguments and
    result, the columns (T,); the checkpoints, where none are given, from
    :func:`ladder_checkpoints_ref`), in torch ops rounded as the kernel's:

    1. each chunk of ``every`` samples re-walks the forward from its
       checkpoint, then walks back ten cotangents at once: the nine basis
       vectors with no output cotangent, and zero with the output's gy.
       That is the chunk's affine map of the cotangent: g_in = M g_out + b;
    2. the carry, from the last chunk to the first: the cotangent leaving
       chunk j - 1 is M_j g + b_j, summed from b in state order;
    3. each chunk walks back again from its true cotangent: gx, the
       columns' per-channel parts (then summed over the channels in
       channel order) and, at chunk 0, gstate_in.

    On the card the kernel equals this bit for bit (torch's CUDA tanh is
    tanhf); on the CPU torch's tanh rounds otherwise."""
    gx, parts, gstate_in = ladder_scan_bwd_parts(
        x, al, qa, ki, dsc, state, gy, gstate, checkpoints, every=every, os_n=os_n, pbg=pbg,
        mode_index=mode_index, input_threshold=input_threshold, state_decay=state_decay)
    return (gx, *channel_sums(parts), gstate_in)


def channel_sums(parts, lo: int = 0, hi: int | None = None):
    """The columns' cotangents: ``parts`` (4, T, C) summed over channels
    ``lo`` to ``hi`` in channel order, from zero (csrc/channel_sum.cuh's
    order)."""
    hi = parts.shape[2] if hi is None else hi
    cols = []
    for part in parts:
        acc = torch.zeros(part.shape[0], dtype=torch.float32, device=part.device)
        for c in range(lo, hi):
            acc = acc + part[:, c]
        cols.append(acc)
    return cols


def ladder_scan_bwd_parts(x, al, qa, ki, dsc, state, gy, gstate, checkpoints=None, *,
                          every=CHECKPOINT_EVERY, os_n, pbg, mode_index, input_threshold,
                          state_decay):
    """:func:`ladder_scan_bwd_chunked` before its channel sum: (gx (T, C),
    the columns' per-channel parts (4, T, C), gstate_in (9, C)). Channels
    are independent but for that sum, so calls that share their columns
    can run as one, each summing its own channels (:func:`channel_sums`)."""
    kw = dict(os_n=os_n, pbg=pbg, input_threshold=input_threshold, state_decay=state_decay)
    T, C = x.shape
    dev = x.device
    if checkpoints is None:
        checkpoints = ladder_checkpoints_ref(x, al, qa, ki, dsc, state, every=every,
                                             mode_index=mode_index, **kw)
    n = -(-T // every)
    pad = n * every - T

    def chunked(v):
        return torch.cat([v, v.new_zeros((pad, *v.shape[1:]))]).reshape(n, every, *v.shape[1:])

    xs, gys = chunked(x), chunked(gy)
    cs = [chunked(v) for v in (al, qa, ki, dsc)]
    valid = (torch.arange(n * every, device=dev) < T).reshape(n, every)
    decays, steps = _rewalk(list(checkpoints.unbind(1)), xs, cs, valid, **kw)
    adj = dict(os_n=os_n, pbg=pbg, mode_index=mode_index)

    # 1. the transfers: lane l < 9 starts from basis vector l, lane 9 from 0 with gy
    basis = torch.eye(10, 9, dtype=torch.float32, device=dev)  # (lane, state row)
    g = [basis[:, r][None, :, None].expand(n, 10, C) for r in range(9)]
    gy_lanes = torch.where(torch.arange(10, device=dev)[:, None] == 9, gys[:, :, None],
                           torch.zeros((), device=dev))
    mb, _, _ = _adjoint(g, gy_lanes, decays, steps, xs, cs, valid, **adj, lanes=True)
    mb = torch.stack(mb, 1)  # (n, state row, lane, C): lane i < 9 is M's column i, 9 is b

    # 2. the carry: g_end[j], the cotangent of the state after chunk j
    g_end = [None] * n
    g_end[n - 1] = gstate
    for j in range(n - 1, 0, -1):
        rows = []
        for r in range(9):
            acc = mb[j, r, 9]
            for i in range(9):
                acc = acc + mb[j, r, i] * g_end[j][i]
            rows.append(acc)
        g_end[j - 1] = torch.stack(rows)
    g_end = torch.stack(g_end)

    # 3. the final walks
    g_start, gx, parts = _adjoint(list(g_end.unbind(1)), gys, decays, steps, xs, cs, valid,
                                  **adj, lanes=False)
    gx = gx.reshape(n * every, C)[:T]
    return gx, parts.reshape(4, n * every, C)[:, :T], torch.stack([v[0] for v in g_start])


# ---- the launches ----


def _launch(x, al, qa, ki, dsc, state, *, os_n, pbg, mode_index,
            input_threshold, state_decay, checkpoints=False, every=CHECKPOINT_EVERY):
    """The kernel's launch: (y, state_out, checkpoints); the checkpoints,
    every ``every`` samples (a multiple of 32), are written only with
    ``checkpoints`` (else an empty (0, 9, C))."""
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
    n_ck = -(-T // every) if checkpoints else 0
    ckpt = torch.empty((n_ck, 9, C), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.ladder_scan_launch(
            x.data_ptr(), *(c.data_ptr() for c in cols), state.data_ptr(),
            y.data_ptr(), state_out.data_ptr(), ckpt.data_ptr() if checkpoints else None,
            every, T, C, os_n, float(pbg), mode_index, float(input_threshold),
            float(state_decay), torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "ladder_scan")
    ladder_scan.launches += 1
    return y, state_out, ckpt


def _launch_recorded(*args, **kw):
    return _launch(*args, **kw, checkpoints=True)


def _launch_bwd(x, al, qa, ki, dsc, ckpt, gy, gstate, *, os_n, pbg, mode_index,
                input_threshold, state_decay, every=CHECKPOINT_EVERY, layout=None):
    """The backward kernel's launches on checkpoints written every
    ``every`` samples: (gx, gal, gqa, gki, gdsc, gstate_in). ``layout``
    (chunks a CUDA block, rewalk, steps_global) overrides
    :func:`_bwd_layout`'s choice (tests: every layout gives the same bits)."""
    dev = x.device
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (T, C) with T, C >= 1, got {tuple(x.shape)}")
    T, C = x.shape
    n = -(-T // every)
    cols = [_ext.checked(v, f"column {i}", (T,), dev) for i, v in enumerate((al, qa, ki, dsc))]
    x = _ext.checked(x, "x", (T, C), dev)
    gy = _ext.checked(gy, "gy", (T, C), dev)
    ckpt = _ext.checked(ckpt, "checkpoints", (n, 9, C), dev)
    gstate = _ext.checked(gstate, "gstate", (9, C), dev)
    if os_n < 1 or mode_index not in range(6):
        raise ValueError(f"unsupported os_n={os_n} mode_index={mode_index}")
    per, rewalk, steps_global = layout or _bwd_layout(os_n, every)
    if _bwd_shared_bytes(os_n, every, per, rewalk, steps_global) > _MAX_SHARED:
        raise ValueError(f"layout {(per, rewalk, steps_global)} exceeds shared memory at "
                         f"os_n={os_n}")
    gx = torch.empty((T, C), dtype=torch.float32, device=dev)
    gcols = torch.empty((4, T), dtype=torch.float32, device=dev)
    gstate_in = torch.empty((9, C), dtype=torch.float32, device=dev)
    # scratch: the chunks' transfers (M's nine columns and b, 9 rows each,
    # padded to 96 floats for 16-byte copies),
    # the cotangents leaving the chunks, the columns' per-channel parts
    transfers = torch.empty((max(n - 1, 1), C, 96), dtype=torch.float32, device=dev)
    g_end = torch.empty((max(n - 1, 1), 9, C), dtype=torch.float32, device=dev)
    part = torch.empty((4, T, C), dtype=torch.float32, device=dev)
    # past shared memory, a sample's steps: a slice of 6 os_n floats an item
    steps = (torch.empty((n * C, 6 * os_n), dtype=torch.float32, device=dev)
             if steps_global else None)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.ladder_scan_bwd_launch(
            x.data_ptr(), *(c.data_ptr() for c in cols), ckpt.data_ptr(), gy.data_ptr(),
            gstate.data_ptr(), gx.data_ptr(), gcols.data_ptr(), gstate_in.data_ptr(),
            transfers.data_ptr(), g_end.data_ptr(), part.data_ptr(),
            steps.data_ptr() if steps_global else None, T, C, every, os_n, per, int(rewalk),
            float(pbg), mode_index, float(input_threshold), float(state_decay),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "ladder_scan_bwd")
    ladder_scan_bwd.launches += 1
    return gx, gcols[0], gcols[1], gcols[2], gcols[3], gstate_in


def _backward(args, outs, grads, **kw):
    x, al, qa, ki, dsc, state = args
    gy, gstate = grads[:2]
    ckpt = outs[2] if len(outs) > 2 else None  # the recorded launch's checkpoints
    got = ladder_scan_bwd(x, al, qa, ki, dsc, state, gy, gstate, ckpt, **kw)
    return [g.reshape(a.shape) for g, a in zip(got, args)]


# the vmap layout: x, the state and the checkpoints carry the channels; the
# coefficient columns are shared by them (a batched column: one launch per
# member)
LAYOUT = dict(channels=(1, None, None, None, None, 1), out_channels=(1, 1, 2))
# the launch as a torch.autograd.Function, its backward ladder_scan_bwd: a
# launch recorded for a backward writes the checkpoints, one with no
# gradient (the launch alone) does not
_differentiable = diffable.kernel_function("ladder_scan", _launch_recorded, _backward,
                                           untracked=_launch, **LAYOUT)
