"""The gated / triggered ADSR state machine.

Counterpart of ``pygmu2_tpu.ops.adsr_pallas``: one function,
``adsr_scan``, takes a (T,) gate (gate levels, or trigger magnitudes for
the triggered variant, selected by ``sustain_samples``) and the (4,)
state ``[stage, e0, n, prev_gate]``, and returns the (T,) envelope and
the state after the last sample. The envelope is recomputed fresh as
``env = e0 + n * slope`` (one float32 rounding whatever the segment
length), as the JAX package's kernel does.

- ``adsr_scan`` is the wrapper. For CUDA tensors it launches the
  hand-written kernel in ``csrc/adsr_scan.cu`` and counts the launch in
  ``adsr_scan.launches``; for CPU tensors it runs the plain version.
- ``adsr_scan_ref`` is the plain PyTorch version: a per-sample loop with
  the JAX package's ``adsr_scan_ref`` op order, float32.

The triggered variant counts its sustain in float32 samples, exact for
``sustain_samples`` up to 2**24. ``AdsrTriggeredPE`` takes it for
``1 < sustain_samples < 2**24`` only, as the JAX PE takes its closed form;
outside that range both run the JAX PE's ``lax.scan`` branch instead, an
absolute-clock machine with a float64 envelope and an int64 deadline:

- ``adsr_clock_scan`` is its wrapper (kernel ``adsr_clock`` in the same
  ``csrc/adsr_scan.cu``, counted in ``adsr_clock_scan.launches``);
- ``adsr_clock_scan_ref`` is its plain version.

Stage codes match models.envelopes: IDLE/ATTACK/DECAY/SUSTAIN/RELEASE.
"""

from __future__ import annotations

import torch

from pygmu2_tpu_torch import _ext

_IDLE, _ATTACK, _DECAY, _SUSTAIN, _RELEASE = 0.0, 1.0, 2.0, 3.0, 4.0
_I, _A, _D, _S, _R = 0, 1, 2, 3, 4  # the clock machine's int32 stages


def env_of_state(state, *, dA, dD, dR, sus):
    """The envelope value implied by a [stage, e0, n, pg] state vector."""
    stage, e0, n = state[0], state[1], state[2]
    # fills, not copies: a host-to-card copy would synchronize the stream
    f = lambda v: torch.full((), v, dtype=torch.float32, device=state.device)  # noqa: E731
    d = torch.where(stage == _ATTACK, f(dA), torch.where(stage == _DECAY, f(dD), f(dR)))
    return torch.where(
        stage == _IDLE, f(0.0), torch.where(stage == _SUSTAIN, f(sus), e0 + n * d)
    )


def adsr_scan_ref(gate, state, *, dA, dD, dR, sus, sustain_samples=None):
    """Plain PyTorch version of :func:`adsr_scan` (same arguments and
    result). A Python loop over samples: keep T small.

    The gate edges are read on the host (``gate.tolist()``); the clip
    transitions, which depend on the envelope, stay tensor selects.
    """
    gated = sustain_samples is None
    dev = gate.device
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    cA, cD, cR, csus = f(dA), f(dD), f(dR), f(sus)
    c0, c1 = f(0.0), f(1.0)
    sA, sD, sS, sR, sI = f(_ATTACK), f(_DECAY), f(_SUSTAIN), f(_RELEASE), f(_IDLE)
    state = state.to(torch.float32)
    stage, e0, n = state[0], state[1], state[2]
    pg = float(state[3])
    envs = []
    for g in gate.tolist():
        d = torch.where(stage == _ATTACK, cA, torch.where(stage == _DECAY, cD, cR))
        env = torch.where(
            stage == _IDLE, c0, torch.where(stage == _SUSTAIN, csus, e0 + n * d)
        )
        envs.append(env)
        if gated:
            rising = pg == 0.0 and g == 1.0
            falling = pg == 1.0 and g == 0.0
            if rising:
                stage = sA
            elif falling:
                stage = sR
            edge = rising or falling
        else:
            edge = g > 0.0
            if edge:
                stage = sA
        if edge:
            e0, n = env, c0

        d2 = torch.where(stage == _ATTACK, cA, torch.where(stage == _DECAY, cD, cR))
        n1 = n + 1.0
        cand = e0 + n1 * d2
        hit_a = (stage == _ATTACK) & (cand >= c1)
        hit_d = (stage == _DECAY) & (cand <= csus)
        hit_r = (stage == _RELEASE) & (cand <= c0)
        if gated:
            expire = torch.zeros_like(hit_a)
        else:
            expire = (stage == _SUSTAIN) & (n1 >= float(sustain_samples))
        stage2 = torch.where(
            hit_a, sD,
            torch.where(hit_d, sS, torch.where(hit_r, sI, torch.where(expire, sR, stage))),
        )
        e0 = torch.where(
            hit_a, c1, torch.where(hit_d | expire, csus, torch.where(hit_r, c0, e0))
        )
        n = torch.where(hit_a | hit_d | hit_r | expire, c0, n1)
        stage = stage2
        pg = g
    new_state = torch.stack([stage, e0, n, f(pg)])
    return torch.stack(envs), new_state


def adsr_scan(gate, state, *, dA, dD, dR, sus, sustain_samples=None):
    """ADSR over a (T,) gate.

    gate: (T,) f32 (gate levels, or trigger magnitudes for the triggered
    variant — ``sustain_samples`` not None selects it); state: (4,) f32
    [stage, e0, n, prev_gate]. Returns (env (T,) f32, new_state (4,) f32).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one count in ``adsr_scan.launches`` per call) or raise.
    """
    kw = dict(dA=dA, dD=dD, dR=dR, sus=sus, sustain_samples=sustain_samples)
    if gate.device.type == "cpu":
        return adsr_scan_ref(gate, state, **kw)
    if gate.device.type != "cuda":
        raise ValueError(f"no kernel for device {gate.device}")
    return _launch(gate, state, **kw)


adsr_scan.launches = 0


def _launch(gate, state, *, dA, dD, dR, sus, sustain_samples):
    dev = gate.device
    if gate.dim() != 1 or gate.shape[0] < 1:
        raise ValueError(f"gate must be (T,) with T >= 1, got {tuple(gate.shape)}")
    (T,) = gate.shape
    gate = _ext.checked(gate, "gate", (T,), dev)
    state = _ext.checked(state, "state", (4,), dev)
    env = torch.empty((T,), dtype=torch.float32, device=dev)
    state_out = torch.empty((4,), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.adsr_scan_launch(
            gate.data_ptr(), state.data_ptr(), env.data_ptr(), state_out.data_ptr(),
            T, float(dA), float(dD), float(dR), float(sus),
            -1 if sustain_samples is None else _count_limit(sustain_samples),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "adsr_scan")
    adsr_scan.launches += 1
    return env, state_out


def _count_limit(sustain_samples) -> int:
    """``sustain_samples`` for the kernel's int argument. A float32 count
    stops at 2**24, so a limit above that never expires, in the kernel as
    in the plain version; clamping into [0, 2**31 - 1] keeps that."""
    return min(max(int(sustain_samples), 0), (1 << 31) - 1)


# ---- the absolute-clock machine (the JAX PE's lax.scan branch) ----------


def adsr_clock_scan_ref(trig, stage, env, ends, *, t0, dA, dD, dR, sus, sustain_samples):
    """Plain version of :func:`adsr_clock_scan` (same arguments and
    result). A per-sample loop in Python floats and ints, which are IEEE
    doubles and int64 as the JAX branch's ``prec.WIDE`` envelope and
    ``prec.INDEX`` clock: keep T small."""
    dev = trig.device
    st, e, end = int(stage), float(env), int(ends)
    out = []
    for i, g in enumerate(trig.tolist()):
        now = t0 + i
        out.append(e)  # the envelope before this sample's update
        if g > 0.0:
            st = _A
        if st == _I:
            e2, st2 = 0.0, st
        elif st == _A:
            e2 = e + dA
            e2, st2 = (1.0, _D) if e2 >= 1.0 else (e2, st)
        elif st == _D:
            e2 = e + dD
            e2, st2 = (sus, _S) if e2 <= sus else (e2, st)
        elif st == _S:
            e2, st2 = sus, st
        else:
            e2 = e + dR
            e2, st2 = (0.0, _I) if e2 <= 0.0 else (e2, st)
        if st == _D and st2 == _S:  # entering SUSTAIN arms the deadline
            end = now + sustain_samples
        if st2 == _S and now >= end:
            st2 = _R
        st, e = st2, e2
    y = torch.tensor(out, dtype=torch.float64, device=dev).to(torch.float32)
    return y, (
        torch.tensor(st, dtype=torch.int32, device=dev),
        torch.tensor(e, dtype=torch.float64, device=dev),
        torch.tensor(end, dtype=torch.int64, device=dev),
    )


def adsr_clock_scan(trig, stage, env, ends, *, t0, dA, dD, dR, sus, sustain_samples):
    """Triggered ADSR on an absolute clock, the JAX ``AdsrTriggeredPE``'s
    ``lax.scan`` branch, for any sustain length.

    trig: (T,) f32 trigger magnitudes (> 0 restarts the attack); stage: ()
    int32; env: () float64; ends: () int64, the sustain deadline in
    absolute samples; t0: the absolute index of trig[0] (a host int);
    sustain_samples: the deadline's offset from the sample that enters
    SUSTAIN. Each sample outputs the envelope before its update. Returns
    (env (T,) f32, (stage', env', ends')). CPU tensors take the plain
    version; CUDA tensors launch the kernel (one count in
    ``adsr_clock_scan.launches`` per call) or raise.
    """
    kw = dict(t0=t0, dA=dA, dD=dD, dR=dR, sus=sus, sustain_samples=sustain_samples)
    if trig.device.type == "cpu":
        return adsr_clock_scan_ref(trig, stage, env, ends, **kw)
    if trig.device.type != "cuda":
        raise ValueError(f"no kernel for device {trig.device}")
    return _launch_clock(trig, stage, env, ends, **kw)


adsr_clock_scan.launches = 0


def _launch_clock(trig, stage, env, ends, *, t0, dA, dD, dR, sus, sustain_samples):
    dev = trig.device
    if trig.dim() != 1 or trig.shape[0] < 1:
        raise ValueError(f"trig must be (T,) with T >= 1, got {tuple(trig.shape)}")
    (T,) = trig.shape
    trig = _ext.checked(trig, "trig", (T,), dev)
    state = {"stage": (stage, torch.int32), "env": (env, torch.float64),
             "ends": (ends, torch.int64)}
    for name, (t, dtype) in state.items():
        if t.shape != () or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name} must be a {dtype} scalar tensor on trig's device")
    y = torch.empty((T,), dtype=torch.float32, device=dev)
    stage_out = torch.empty((), dtype=torch.int32, device=dev)
    env_out = torch.empty((), dtype=torch.float64, device=dev)
    ends_out = torch.empty((), dtype=torch.int64, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.adsr_clock_launch(
            trig.data_ptr(), stage.data_ptr(), env.data_ptr(), ends.data_ptr(),
            y.data_ptr(), stage_out.data_ptr(), env_out.data_ptr(), ends_out.data_ptr(),
            T, int(t0), float(dA), float(dD), float(dR), float(sus), int(sustain_samples),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "adsr_clock_scan")
    adsr_clock_scan.launches += 1
    return y, (stage_out, env_out, ends_out)
