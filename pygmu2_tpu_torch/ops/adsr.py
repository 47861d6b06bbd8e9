"""The gated / triggered ADSR state machine.

Counterpart of ``pygmu2_tpu.ops.adsr_pallas``: one function,
``adsr_scan``, takes a (T,) gate (gate levels, or trigger magnitudes for
the triggered variant, selected by ``sustain_samples``) and the (4,)
state ``[stage, e0, n, prev_gate]``, and returns the (T,) envelope, the
state after the last sample and the envelope the next sample would emit
(``env_of_state`` of that state: the value the PEs carry into their next
block, as the JAX PEs carry ``env_of_state``). The envelope is recomputed fresh as
``env = e0 + n * slope`` in one fused multiply-add (one float32 rounding
whatever the segment length), and the step that decides a transition
computes its candidate ``e0 + (n + 1) * slope`` the same way: XLA
contracts both products into their sums on the CPU, so the JAX package's
``adsr_scan_ref`` and ``adsr_closed_form`` round them once.

- ``adsr_scan`` is the wrapper. For CUDA tensors it launches the
  hand-written kernel in ``csrc/adsr_scan.cu`` and counts the launch in
  ``adsr_scan.launches``; for CPU tensors it runs the plain version.
- ``adsr_scan_ref`` is the plain PyTorch version: a per-sample loop with
  the JAX package's ``adsr_scan_ref`` op order, float32.
- ``adsr_scan_phases`` is the kernel's order in torch ops: the gate's
  edges, a walk over the edges that gives each segment between two edges
  its phase table, then every sample evaluated from its segment's table.
  It equals ``adsr_scan_ref`` bit for bit.

The machine's transitions depend on the gate, which is known for the
whole call, and on where linear ramps cross their clip levels, never on
the output. Between two edges a segment runs a fixed chain of phases: its
entering stage, then DECAY from 1 (after ATTACK), SUSTAIN, RELEASE from
``sus`` (triggered: after ``sustain_samples`` steps) and IDLE. A
crossing is the first count ``n1`` whose rounded candidate passes the
clip level; rounding is monotone, so the candidate is monotone in ``n1``
and a window around the real crossing, with a bisection where it misses,
finds it exactly. Counts are float32: ``fl(2**24 + 1) = 2**24``, so a
count stops at 2**24 and a ramp that has not crossed by then never does.

The triggered variant counts its sustain in float32 samples, exact for
``sustain_samples`` up to 2**24. ``AdsrTriggeredPE`` takes it for
``1 < sustain_samples < 2**24`` only, as the JAX PE takes its closed form;
outside that range both run the JAX PE's ``lax.scan`` branch instead, an
absolute-clock machine with a float64 envelope and an int64 deadline:

- ``adsr_clock_scan`` is its wrapper (kernel ``adsr_clock`` in the same
  ``csrc/adsr_scan.cu``, counted in ``adsr_clock_scan.launches``);
- ``adsr_clock_scan_ref`` is its plain version.

The backward of both: ``adsr_scan_bwd`` and ``adsr_clock_scan_bwd`` launch
``csrc/adsr_scan_bwd.cu`` for CUDA tensors (counted in their
``.launches``); on the card the two wrappers' gradients are those
launches. The gate and the stage enter only through compares: their
cotangents are zero. The state's e0 and n reach every sample emitted in
ATTACK, DECAY or RELEASE until the first cut (a hit, an expiry, or an edge
where the value emitted is a constant), carried across edges (an edge
re-anchors e0 to the value emitted there); the clock branch's float64
envelope likewise until its first constant value. ``adsr_scan_bwd_ref``
and ``adsr_clock_scan_bwd_ref`` are the plain versions: the walk to the
cut segment by segment, and the masked sums in torch ops.
``adsr_scan_bwd_tiled`` is the kernel's order in torch ops (every sample's
cut test at once, the sums in the kernel's tiles and trees), equal to it
bit for bit.

Stage codes match models.envelopes: IDLE/ATTACK/DECAY/SUSTAIN/RELEASE.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygmu2_tpu_torch import _ext
from pygmu2_tpu_torch.ops import diffable
from pygmu2_tpu_torch.ops.xla_math import fmaf

_IDLE, _ATTACK, _DECAY, _SUSTAIN, _RELEASE = 0.0, 1.0, 2.0, 3.0, 4.0
_I, _A, _D, _S, _R = 0, 1, 2, 3, 4  # the clock machine's int32 stages
N_MAX = 1 << 24  # a float32 count stops here: fl(2**24 + 1) = 2**24
_NEVER = 1 << 40  # a phase that never ends (beyond any call's length)


def env_of_state(state, *, dA, dD, dR, sus):
    """The envelope value implied by a [stage, e0, n, pg] state vector:
    what the machine emits next, ``e0 + n * d`` in one rounding as the
    JAX package's XLA program rounds it. The plain versions' ``env_next``;
    the kernel computes it on the card."""
    stage, e0, n = state[0], state[1], state[2]
    f = lambda v: torch.full((), v, dtype=torch.float32, device=state.device)  # noqa: E731
    d = torch.where(stage == _ATTACK, f(dA), torch.where(stage == _DECAY, f(dD), f(dR)))
    return torch.where(
        stage == _IDLE, f(0.0), torch.where(stage == _SUSTAIN, f(sus), fmaf(n, d, e0))
    )


def adsr_scan_ref(gate, state, *, dA, dD, dR, sus, sustain_samples=None):
    """Plain PyTorch version of :func:`adsr_scan` (same arguments and
    result). A Python loop over samples: keep T small.

    Also takes C independent machines at once: a (T, C) gate and a (4, C)
    state give (T, C), (4, C) and (C,) results, each column the one-column
    call's. Every step is a tensor select, so a loop over many columns
    costs about what one column does.
    """
    gated = sustain_samples is None
    dev = gate.device
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    cA, cD, cR, csus = f(dA), f(dD), f(dR), f(sus)
    c0, c1 = f(0.0), f(1.0)
    sA, sD, sS, sR, sI = f(_ATTACK), f(_DECAY), f(_SUSTAIN), f(_RELEASE), f(_IDLE)
    state = state.to(torch.float32)
    stage, e0, n, pg = state[0], state[1], state[2], state[3]
    envs = []
    for g in gate.to(torch.float32):
        d = torch.where(stage == _ATTACK, cA, torch.where(stage == _DECAY, cD, cR))
        env = torch.where(
            stage == _IDLE, c0, torch.where(stage == _SUSTAIN, csus, fmaf(n, d, e0))
        )
        envs.append(env)
        if gated:
            rising = (pg == 0.0) & (g == 1.0)
            falling = (pg == 1.0) & (g == 0.0)
            stage = torch.where(rising, sA, torch.where(falling, sR, stage))
            edge = rising | falling
        else:
            edge = g > 0.0
            stage = torch.where(edge, sA, stage)
        e0 = torch.where(edge, env, e0)
        n = torch.where(edge, c0, n)

        d2 = torch.where(stage == _ATTACK, cA, torch.where(stage == _DECAY, cD, cR))
        n1 = n + 1.0
        cand = fmaf(n1, d2, e0)
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
    new_state = torch.stack([stage, e0, n, pg])
    return torch.stack(envs), new_state, env_of_state(new_state, dA=dA, dD=dD, dR=dR, sus=sus)


# ---- the kernel's order: edges, a walk over the edges, every sample ----


class _Chain:
    """A call's constants: the slopes and ``sus`` as float32 values, the
    float32 sustain count, and where each phase of the chain that follows
    a segment's entering stage starts: DECAY from 1 at 0, SUSTAIN at
    ``c_s``, RELEASE from ``sus`` at ``c_r``, IDLE at ``c_i``. A segment
    joins the chain, after its entering stage, at ``join[stage]``."""

    def __init__(self, dA, dD, dR, sus, sustain_samples):
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        self.dA, self.dD, self.dR, self.sus = f32(dA), f32(dD), f32(dR), f32(sus)
        self.S = None if sustain_samples is None else int(np.float32(sustain_samples))
        one = torch.tensor(1.0)
        decay = _crossing(one, 0, self.dD, self.sus, ge=False)
        release = _crossing(torch.tensor(self.sus), 0, self.dR, 0.0, ge=False)
        hold = _NEVER if self.S is None or self.S > N_MAX else max(self.S, 1)
        self.c_s = _NEVER if decay is None else decay
        self.c_r = self.c_s + hold
        self.c_i = self.c_r + (_NEVER if release is None else release)
        self.join = torch.tensor([0, 0, self.c_s, self.c_r, self.c_i])

    def first_phase(self, stage: int, e0, n0: int) -> int:
        """Samples a segment entering ``stage`` with (e0, n0) spends in it
        (at least 1), or ``_NEVER``."""
        if stage == _A:
            m = _crossing(e0, n0, self.dA, 1.0, ge=True)
        elif stage == _D:
            m = _crossing(e0, n0, self.dD, self.sus, ge=False)
        elif stage == _R:
            m = _crossing(e0, n0, self.dR, 0.0, ge=False)
        elif stage == _S and self.S is not None:
            m = self.S if self.S <= N_MAX else None  # n1 >= S expires
        else:
            return _NEVER
        return _NEVER if m is None else max(m - n0, 1)

    def eval(self, stage, e0, n0, r1, rel):
        """The envelope emitted ``rel`` samples into segments entering
        ``stage`` with (e0, n0) and a first phase of ``r1`` samples, and
        the machine's state there: (env, stage, e0, n). Tensors of one
        shape: int64 but e0 (float32)."""
        first = rel < r1
        n = torch.clamp(n0 + rel, max=N_MAX)
        d = torch.where(stage == _A, self.dA, torch.where(stage == _D, self.dD, self.dR))
        env0 = torch.where(stage == _I, 0.0, torch.where(
            stage == _S, self.sus, fmaf(n.float(), d.float(), e0)))
        q = self.join[stage] + rel - r1  # the position in the chain
        p = ((q >= self.c_s).long() + (q >= self.c_r).long() + (q >= self.c_i).long())
        q = torch.clamp(q - torch.tensor([0, self.c_s, self.c_r, self.c_i])[p], max=N_MAX)
        base = torch.tensor([1.0, self.sus, self.sus, 0.0])[p]
        slope = torch.tensor([self.dD, 0.0, self.dR, 0.0])[p]
        env1 = torch.where((p == 0) | (p == 2), fmaf(q.float(), slope, base), base)
        return (
            torch.where(first, env0, env1).float(),
            torch.where(first, stage, torch.tensor([_D, _S, _R, _I])[p]),
            torch.where(first, e0, torch.tensor([1.0, self.sus, self.sus, 0.0])[p]),
            torch.where(first, n, q),
        )


def _crossing(e0, n0: int, d: float, th: float, *, ge: bool):
    """The first count ``n1`` in [min(n0 + 1, 2**24), 2**24] whose
    candidate ``fmaf(n1, d, e0)`` is >= th (``ge``) or <= th, or None.

    The candidate is monotone in ``n1``. Where it moves away from ``th``
    (or stays), only the first count can pass; else a window of 32 counts
    around the real crossing ``(th - e0) / d`` holds it unless the float
    estimate is far off, and a bisection finds it where the window
    misses."""
    lo = min(n0 + 1, N_MAX)

    def passes(m0, m1):  # the counts m0 .. m1 - 1
        v = fmaf(torch.arange(m0, m1).float(), d, e0)
        return (v >= th) if ge else (v <= th)

    if not (d > 0.0 if ge else d < 0.0):
        return lo if bool(passes(lo, lo + 1)) else None
    est = (th - float(e0)) / d
    base = max(lo, math.floor(est) - 15) if math.isfinite(est) and est < N_MAX else lo
    base = min(base, max(lo, N_MAX - 31))
    top = min(base + 32, N_MAX + 1)
    hit = passes(base, top)
    if bool(hit.any()) and (base == lo or not bool(hit[0])):
        return base + int(hit.int().argmax())
    if bool(hit[0]):  # below the window
        a, b = lo, base
    elif top <= N_MAX and bool(passes(N_MAX, N_MAX + 1)):  # above it
        a, b = top, N_MAX
    else:
        return None
    while a < b:  # b passes; the first that does is in [a, b]
        mid = (a + b) // 2
        if bool(passes(mid, mid + 1)):
            b = mid
        else:
            a = mid + 1
    return b


def in_closed_form(state) -> bool:
    """Whether the incoming state is one the machine produces: a stage
    code and an integer count in [0, 2**24]. The kernel runs any other
    per sample, as the plain version does."""
    stage, n0 = float(state[0]), float(state[2])
    return stage in (0.0, 1.0, 2.0, 3.0, 4.0) and n0 == math.floor(n0) and 0 <= n0 <= N_MAX


def adsr_scan_phases(gate, state, *, dA, dD, dR, sus, sustain_samples=None):
    """:func:`adsr_scan` in the kernel's order, in torch ops on the CPU
    (same arguments and result; bit for bit the plain version's):

    1. the gate's edges (gated: 0 -> 1 rising, 1 -> 0 falling, against the
       previous sample or ``state[3]``; triggered: g > 0);
    2. a walk over the edges: a segment starts at each, entering ATTACK
       (rising, or a trigger) or RELEASE with ``e0`` the envelope emitted
       there by the segment before and a count of 0; each gets the length
       of its entering stage (a crossing, or the sustain count), and the
       chain that follows is the same for every segment;
    3. every sample evaluated from its segment (the edges strictly before
       it): an edge's own sample still emits the segment before.

    An incoming state outside :func:`in_closed_form` takes the plain
    version, as the kernel takes its per-sample loop.
    """
    state = state.to(torch.float32)
    if not in_closed_form(state):
        return adsr_scan_ref(gate, state, dA=dA, dD=dD, dR=dR, sus=sus,
                             sustain_samples=sustain_samples)
    c = _Chain(dA, dD, dR, sus, sustain_samples)
    g = gate.to(torch.float32)
    T = g.shape[0]
    if sustain_samples is None:
        pgv = torch.cat([state[3:4], g[:-1]])
        rising = (pgv == 0.0) & (g == 1.0)
        edge = rising | ((pgv == 1.0) & (g == 0.0))
    else:
        rising = edge = g > 0.0
    edges = torch.nonzero(edge)[:, 0]

    # each segment's start, entering stage, e0 and count, first-phase length
    starts, stages, e0s, n0s = [0], [int(state[0])], [state[1]], [int(state[2])]
    r1s = [c.first_phase(stages[0], e0s[0], n0s[0])]
    for p in edges.tolist():  # 2. serial over the edges only
        one = lambda v: torch.tensor([v])  # noqa: E731
        env = c.eval(one(stages[-1]), e0s[-1].reshape(1), one(n0s[-1]), one(r1s[-1]),
                     one(p - starts[-1]))[0][0]
        stage = _A if bool(rising[p]) else _R
        starts.append(p), stages.append(stage), e0s.append(env), n0s.append(0)
        r1s.append(c.first_phase(stage, env, 0))
    start, stage, n0, r1 = (torch.tensor(v) for v in (starts, stages, n0s, r1s))
    e0 = torch.stack(e0s).float()

    t = torch.arange(T)
    sid = torch.searchsorted(edges, t)  # edges strictly before t
    env = c.eval(stage[sid], e0[sid], n0[sid], r1[sid], t - start[sid])[0]
    k = len(starts) - 1
    _, st, e, n = c.eval(stage[k:], e0[k:], n0[k:], r1[k:], T - start[k:])
    new_state = torch.stack([st[0].float(), e[0], n[0].float(), g[T - 1]]).to(gate.device)
    return (env.to(gate.device), new_state,
            env_of_state(new_state, dA=dA, dD=dD, dR=dR, sus=sus))


def adsr_scan(gate, state, *, dA, dD, dR, sus, sustain_samples=None):
    """ADSR over a (T,) gate.

    gate: (T,) f32 (gate levels, or trigger magnitudes for the triggered
    variant — ``sustain_samples`` not None selects it); state: (4,) f32
    [stage, e0, n, prev_gate]. Returns (env (T,) f32, new_state (4,) f32,
    env_next () f32: :func:`env_of_state` of new_state).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one count in ``adsr_scan.launches`` per call) or raise.
    """
    kw = dict(dA=dA, dD=dD, dR=dR, sus=sus, sustain_samples=sustain_samples)
    if gate.device.type == "cpu":
        return adsr_scan_ref(gate, state, **kw)
    if gate.device.type != "cuda":
        raise ValueError(f"no kernel for device {gate.device}")
    return _differentiable(gate, state, **kw)


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
    env_next = torch.empty((), dtype=torch.float32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.adsr_scan_launch(
            gate.data_ptr(), state.data_ptr(), env.data_ptr(), state_out.data_ptr(),
            env_next.data_ptr(), T, float(dA), float(dD), float(dR), float(sus),
            -1 if sustain_samples is None else _count_limit(sustain_samples),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "adsr_scan")
    adsr_scan.launches += 1
    return env, state_out, env_next


def adsr_scan_bwd(gate, state, env, genv, gstate, genv_next, *, dA, dD, dR, sus,
                  sustain_samples=None):
    """The cotangent (4,) of :func:`adsr_scan`'s state (the gate's is zero),
    given its arguments, its output ``env`` and the cotangents of env (T,),
    the state out (4,) and env_next (). CPU tensors take the plain
    version; CUDA tensors launch the kernel (one count in
    ``adsr_scan_bwd.launches`` per call) or raise."""
    kw = dict(dA=dA, dD=dD, dR=dR, sus=sus, sustain_samples=sustain_samples)
    args = (gate, state, env, genv, gstate, genv_next)
    if gate.device.type == "cpu":
        return adsr_scan_bwd_ref(*args, **kw)
    if gate.device.type != "cuda":
        raise ValueError(f"no kernel for device {gate.device}")
    return _launch_bwd(*args, **kw)


adsr_scan_bwd.launches = 0


def adsr_scan_bwd_ref(gate, state, env, genv, gstate, genv_next, *, dA, dD, dR, sus,
                      sustain_samples=None, with_walked=False):
    """Plain PyTorch version of :func:`adsr_scan_bwd`, in the kernel's
    order: the gate's edges, then segment by segment to the first cut, a
    segment's hit found among its candidates ``fmaf(n + 1, d, e0)`` at
    once, its samples' cotangents summed with the segment's weights (e0's
    1, n's ``a_n + d b_n``: 0 and 1 before the first edge, the slope there
    and 0 after). A state outside :func:`in_closed_form` is walked per
    sample, as the kernel walks it. ``with_walked``: also return how many
    samples the walk read (to the cut, or all)."""
    dev = gate.device
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    slopes = {_ATTACK: f(dA), _DECAY: f(dD)}
    cR, csus = f(dR), f(sus)
    gated = sustain_samples is None
    g, gy = gate.to(torch.float32), genv.to(torch.float32)
    host = state.detach().to("cpu", torch.float32)
    stage, pg0 = float(host[0]), float(host[3])
    e0, n = state.detach()[1].to(torch.float32), state.detach()[2].to(torch.float32)
    T = g.shape[0]

    def slope(st):
        return slopes.get(st, cR)

    def ramp(st):  # emits fma(n, d, e0)
        return st not in (_IDLE, _SUSTAIN)

    def cut(st, e0, n1):  # a hit or an expiry at counts n1
        cand = fmaf(n1, slope(st).expand_as(n1), e0.expand_as(n1))
        if st == _ATTACK:
            return cand >= 1.0
        if st == _DECAY:
            return cand <= csus
        if st == _RELEASE:
            return cand <= 0.0
        if st == _SUSTAIN and not gated:
            return n1 >= float(sustain_samples)
        return torch.zeros_like(n1, dtype=torch.bool)

    pgv = torch.cat([f(pg0).reshape(1), g[:-1]])
    if gated:
        rising = (pgv == 0.0) & (g == 1.0)
        edge = rising | ((pgv == 1.0) & (g == 0.0))
    else:
        rising = edge = g > 0.0
    a_n, b_n, acc_e, acc_n = f(0.0), f(1.0), f(0.0), f(0.0)
    live, walked = True, T
    if in_closed_form(host):
        edges, rise = torch.nonzero(edge)[:, 0].tolist(), rising.tolist()
        t, k = 0, 0
        while t < T:
            p = edges[k] if k < len(edges) else None
            stop = T if p is None else p  # samples t .. stop - 1 can hit
            n1 = torch.clamp(n + torch.arange(1, stop - t + 1, device=dev,
                                              dtype=torch.float32), max=float(N_MAX))
            hits = torch.nonzero(cut(stage, e0, n1))[:, 0].tolist()
            last = t + hits[0] if hits else (T - 1 if p is None else p)
            if ramp(stage):
                s = gy[t:last + 1].sum()
                acc_e = acc_e + s
                acc_n = acc_n + (a_n + slope(stage) * b_n) * s
            if hits or p is None or not ramp(stage):
                live = not hits and p is None
                walked = last + 1
                break
            a_n, b_n = a_n + slope(stage) * b_n, f(0.0)  # the edge at p re-anchors e0
            e0 = env.detach()[p].to(torch.float32)
            stage = _ATTACK if rise[p] else _RELEASE
            if bool(cut(stage, e0, f(1.0).reshape(1))[0]):
                live, walked = False, p + 1
                break
            n, t, k = f(1.0), p + 1, k + 1
    else:
        for t in range(T):
            d = slope(stage)
            value = (f(0.0) if stage == _IDLE else csus if stage == _SUSTAIN
                     else fmaf(n, d, e0))
            if ramp(stage):
                acc_e = acc_e + gy[t]
                acc_n = acc_n + (a_n + d * b_n) * gy[t]
            if bool(edge[t]):
                if not ramp(stage):
                    live, walked = False, t + 1
                    break
                a_n, b_n, e0, n = a_n + d * b_n, f(0.0), value, f(0.0)
                stage = _ATTACK if bool(rising[t]) else _RELEASE
            n1 = n + 1.0
            if bool(cut(stage, e0, n1.reshape(1))[0]):
                live, walked = False, t + 1
                break
            n = n1
    if live:  # the state out and env_next still carry the state in
        ge, gn = gstate[1].to(torch.float32), gstate[2].to(torch.float32)
        if ramp(stage):
            ge = ge + genv_next.to(torch.float32)
            gn = gn + slope(stage) * genv_next.to(torch.float32)
        acc_e = acc_e + ge
        acc_n = acc_n + a_n * ge + b_n * gn
    zero = f(0.0)
    out = torch.stack([zero, acc_e, acc_n, zero])
    return (out, walked) if with_walked else out


# csrc/adsr_scan_bwd.cu's grouping: a CUDA block (a tile) of BWD_THREADS
# threads, BWD_PER consecutive samples each, in warps of 32
BWD_THREADS, BWD_PER = 256, 4
BWD_TILE = BWD_THREADS * BWD_PER


def _block_tree(v):
    """The kernel's sum over a block of (..., BWD_THREADS) values: each
    warp's 32 by a halving tree (the shuffles), then the warps' sums by the
    same tree (zeros past the last warp)."""
    v = v.reshape(*v.shape[:-1], BWD_THREADS // 32, 32)
    o = 16
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    v = torch.cat([v[..., 0], v.new_zeros((*v.shape[:-2], 32 - BWD_THREADS // 32))], dim=-1)
    o = 16
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def adsr_scan_bwd_tiled(gate, state, env, genv, gstate, genv_next, *, dA, dD, dR, sus,
                        sustain_samples=None):
    """:func:`adsr_scan_bwd` in the kernel's order (same arguments and
    result), in torch ops rounded as the kernel's, equal to it bit for bit:

    1. the gate's edges, and for every sample the last edge at or before it
       (a running maximum): the stage after it (ATTACK or RELEASE), e0 the
       envelope emitted there, the count ``t - edge + 1``; before the first
       edge the state in's stage, e0 and ``min(n + t + 1, 2**24)``;
    2. every sample's cut test at once (the forward's rounded candidate
       against its clip level, the triggered sustain count, an edge whose
       entering stage is IDLE or SUSTAIN), the first cut;
    3. the cotangents up to and including it (where the entering stage
       ramps) summed as the kernel sums them: each thread's BWD_PER samples
       in order, a tile's threads by :func:`_block_tree`, the tiles' sums
       by the same tree (a thread the tiles ``tid``, ``tid +
       BWD_THREADS``, ... in order); ge0 that sum, gn0 the entering slope
       times it; where nothing cut, the state out's and env_next's
       cotangents added with n's weight (the entering slope after an edge,
       1 before).

    A state outside :func:`in_closed_form` is walked per sample with the
    kernel's ops (its thread 0's walk)."""
    dev = gate.device
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    gated = sustain_samples is None
    limit = None if gated else float(np.float32(_count_limit(sustain_samples)))
    g, gy = gate.to(torch.float32), genv.to(torch.float32)
    host = state.detach().to("cpu", torch.float32)
    st = state.detach().to(torch.float32)
    stage_in, e0_in, n_in, pg0 = float(host[0]), st[1], st[2], st[3]
    go, gnext = gstate.to(torch.float32), genv_next.to(torch.float32).reshape(())
    slope = {_ATTACK: f(dA), _DECAY: f(dD)}
    cR, csus = f(dR), f(sus)

    def d_of(code):
        return slope.get(code, cR)

    def ramp(code):
        return code not in (_IDLE, _SUSTAIN)

    def finish(acc_e, acc_n, live, stage, a_n, b_n):
        if live:
            r = ramp(stage)
            ge = go[1] + (gnext if r else f(0.0))
            gn = go[2] + (d_of(stage) * gnext if r else f(0.0))
            acc_e = acc_e + ge
            acc_n = fmaf(a_n, ge, fmaf(b_n, gn, acc_n))
        zero = f(0.0)
        return torch.stack([zero, acc_e.reshape(()), acc_n.reshape(()), zero])

    T = g.shape[0]
    if not in_closed_form(host):  # thread 0's walk
        stage, e0, n, pg = stage_in, e0_in, n_in, pg0
        a_n, b_n, acc_e, acc_n, live = f(0.0), f(1.0), f(0.0), f(0.0), True
        for t in range(T):
            d = d_of(stage)
            value = f(0.0) if stage == _IDLE else csus if stage == _SUSTAIN else fmaf(n, d, e0)
            if ramp(stage):
                acc_e = acc_e + gy[t]
                acc_n = fmaf(fmaf(d, b_n, a_n), gy[t], acc_n)
            if gated:
                rising = bool(pg == 0.0) and bool(g[t] == 1.0)
                edge = rising or (bool(pg == 1.0) and bool(g[t] == 0.0))
            else:
                rising = edge = bool(g[t] > 0.0)
            if edge:
                if not ramp(stage):
                    live = False
                    break
                a_n, b_n, e0, n = fmaf(d, b_n, a_n), f(0.0), value, f(0.0)
                stage = _ATTACK if rising else _RELEASE
            n1 = n + 1.0
            if bool(_cut_tests(stage, e0, n1, slope_of=d_of, csus=csus, limit=limit)):
                live = False
                break
            n, pg = n1, g[t]
        return finish(acc_e, acc_n, live, stage, a_n, b_n)

    # 1. edges, and the last edge at or before each sample
    t_idx = torch.arange(T, device=dev)
    pgv = torch.cat([pg0.reshape(1), g[:-1]])
    if gated:
        rising = (pgv == 0.0) & (g == 1.0)
        edge = rising | ((pgv == 1.0) & (g == 0.0))
    else:
        rising = edge = g > 0.0
    E = torch.cummax(torch.where(edge, t_idx, torch.full_like(t_idx, -1)), 0).values
    before = torch.cat([torch.full((1,), -1, device=dev, dtype=E.dtype), E[:-1]])
    none = E < 0
    Ec = E.clamp(min=0)
    stage = torch.where(none, f(stage_in),
                        torch.where(rising[Ec], f(_ATTACK), f(_RELEASE)))
    e0 = torch.where(none, e0_in, env.to(torch.float32)[Ec])
    n1 = torch.where(none, n_in + (t_idx + 1).to(torch.float32),
                     (t_idx - E + 1).to(torch.float32)).clamp(max=float(N_MAX))
    # 2. the cut tests, the first cut
    d = torch.where(stage == _ATTACK, f(dA), torch.where(stage == _DECAY, f(dD), cR))
    cand = fmaf(n1, d, e0)
    cut = (((stage == _ATTACK) & (cand >= 1.0)) | ((stage == _DECAY) & (cand <= csus))
           | ((stage == _RELEASE) & (cand <= 0.0)))
    if not gated:
        cut = cut | ((stage == _SUSTAIN) & (n1 >= limit))
    if not ramp(stage_in):
        cut = cut | (edge & (before < 0))  # an edge in IDLE or SUSTAIN
    hits = torch.nonzero(cut)[:, 0]
    first = int(hits[0]) if len(hits) else None
    # 3. the sums up to the cut, in the kernel's grouping: each tile's, then
    # the tiles' (a thread the tiles tid, tid + BWD_THREADS, ... in order)
    last = T - 1 if first is None else first
    tiles = -(-T // BWD_TILE)
    keep = t_idx <= last if ramp(stage_in) else torch.zeros(T, dtype=torch.bool, device=dev)
    v = torch.zeros(tiles * BWD_TILE, dtype=torch.float32, device=dev)
    v[:T] = torch.where(keep, gy, f(0.0))
    v = v.reshape(tiles, BWD_THREADS, BWD_PER)
    part = torch.zeros((tiles, BWD_THREADS), dtype=torch.float32, device=dev)
    for i in range(BWD_PER):  # a thread's samples in order
        part = part + v[..., i]
    sums = _block_tree(part)  # (tiles,)
    rows = -(-tiles // BWD_THREADS)
    sums = torch.cat([sums, sums.new_zeros(rows * BWD_THREADS - tiles)]).reshape(
        rows, BWD_THREADS)
    acc = torch.zeros(BWD_THREADS, dtype=torch.float32, device=dev)
    for r in range(rows):
        acc = acc + sums[r]
    total = _block_tree(acc)
    # without a cut the last edge (if any) sets the stage out; n's weight
    # is the entering slope after an edge, its own (1) before
    any_edge = bool(edge.any())
    d_in, r_in = d_of(stage_in), ramp(stage_in)
    return finish(total if r_in else f(0.0), d_in * total if r_in else f(0.0), first is None,
                  float(stage[-1]) if any_edge else stage_in,
                  d_in if any_edge else f(0.0), f(0.0) if any_edge else f(1.0))


def _cut_tests(stage, e0, n1, *, slope_of, csus, limit):
    """The cut test of one sample's post-step: a hit of its stage's clip
    level by the rounded candidate, or the triggered sustain count
    (``limit``, None gated) reached."""
    cand = fmaf(n1, slope_of(stage), e0)
    if stage == _ATTACK:
        return cand >= 1.0
    if stage == _DECAY:
        return cand <= csus
    if stage == _RELEASE:
        return cand <= 0.0
    return stage == _SUSTAIN and limit is not None and bool(n1 >= limit)


def _launch_bwd(gate, state, env, genv, gstate, genv_next, *, dA, dD, dR, sus,
                sustain_samples):
    dev = gate.device
    if gate.dim() != 1 or gate.shape[0] < 1:
        raise ValueError(f"gate must be (T,) with T >= 1, got {tuple(gate.shape)}")
    (T,) = gate.shape
    gate, env, genv = (_ext.checked(v, n, (T,), dev) for v, n in
                       ((gate, "gate"), (env, "env"), (genv, "genv")))
    state = _ext.checked(state, "state", (4,), dev)
    gstate = _ext.checked(gstate, "gstate", (4,), dev)
    genv_next = _ext.checked(genv_next.reshape(()), "genv_next", (), dev)
    gstate_in = torch.empty((4,), dtype=torch.float32, device=dev)
    # past one tile: the tiles' ticket, finished count and last edges (a
    # 64-bit word each; zeroed by the launch), and each tile's first cut
    # and sum
    tiles = -(-T // BWD_TILE)
    flags = info = None
    if tiles > 1:
        flags = torch.empty((2 + 2 * tiles,), dtype=torch.int32, device=dev)
        info = torch.empty((2 * tiles,), dtype=torch.int32, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.adsr_scan_bwd_launch(
            gate.data_ptr(), state.data_ptr(), env.data_ptr(), genv.data_ptr(),
            gstate.data_ptr(), genv_next.data_ptr(), gstate_in.data_ptr(),
            None if flags is None else flags.data_ptr(),
            None if info is None else info.data_ptr(), T, float(dA), float(dD), float(dR),
            float(sus),
            -1 if sustain_samples is None else _count_limit(sustain_samples),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "adsr_scan_bwd")
    adsr_scan_bwd.launches += 1
    return gstate_in


def _backward(args, outs, grads, **kw):
    gate, state = args
    genv, gstate, genv_next = grads
    return None, adsr_scan_bwd(gate, state, outs[0], genv, gstate, genv_next, **kw)


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
    if trig.device.type == "cpu" and not diffable.transformed(trig, stage, env, ends):
        return adsr_clock_scan_ref(trig, stage, env, ends, **kw)
    if trig.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {trig.device}")
    # the launch; on the CPU under torch.func the plain version's loop, which
    # reads the trigger on the host, runs as the card's launch does, by its rule
    env_t, *state_out = _differentiable_clock(trig, stage, env, ends, **kw)
    return env_t, tuple(state_out)


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


def adsr_clock_scan_bwd(trig, stage, env, gy, genv_out, *, dA, dD, dR, sus, **_):
    """The cotangent () float64 of :func:`adsr_clock_scan`'s envelope in
    (the trigger's and the integer state's are zero), given its arguments
    and the cotangents of its output (T,) and envelope out (). CPU tensors
    take the plain version; CUDA tensors launch the kernel (one count in
    ``adsr_clock_scan_bwd.launches`` per call) or raise."""
    kw = dict(dA=dA, dD=dD, dR=dR, sus=sus)
    if trig.device.type == "cpu":
        return adsr_clock_scan_bwd_ref(trig, stage, env, gy, genv_out, **kw)
    if trig.device.type != "cuda":
        raise ValueError(f"no kernel for device {trig.device}")
    return _launch_clock_bwd(trig, stage, env, gy, genv_out, **kw)


adsr_clock_scan_bwd.launches = 0


def adsr_clock_scan_bwd_ref(trig, stage, env, gy, genv_out, *, dA, dD, dR, sus, **_):
    """Plain version of :func:`adsr_clock_scan_bwd`: the machine walked in
    Python floats (the forward's float64 adds) to its first constant value
    (IDLE, SUSTAIN, a hit), then the output's cotangents summed up to that
    sample, and the envelope out's if there is none."""
    st, e = int(stage), float(env)
    cut = trig.shape[0]
    for t, g in enumerate(trig.tolist()):
        if g > 0.0:
            st = _A
        if st in (_I, _S):
            cut = t
            break
        e2 = e + (dA if st == _A else dD if st == _D else dR)
        if (e2 >= 1.0) if st == _A else (e2 <= sus) if st == _D else (e2 <= 0.0):
            cut = t
            break
        e = e2
    total = gy[:cut + 1].to(torch.float64).sum()
    if cut >= trig.shape[0]:
        total = total + genv_out.to(torch.float64)
    return total


def _launch_clock_bwd(trig, stage, env, gy, genv_out, *, dA, dD, dR, sus):
    dev = trig.device
    (T,) = trig.shape
    trig, gy = (_ext.checked(v, n, (T,), dev) for v, n in ((trig, "trig"), (gy, "gy")))
    for name, t, dtype in (("stage", stage, torch.int32), ("env", env, torch.float64),
                           ("genv_out", genv_out, torch.float64)):
        if t.shape != () or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name} must be a {dtype} scalar tensor on trig's device")
    genv_in = torch.empty((), dtype=torch.float64, device=dev)
    lib = _ext.load()
    with torch.cuda.device(dev):
        err = lib.adsr_clock_bwd_launch(
            trig.data_ptr(), stage.data_ptr(), env.data_ptr(), gy.data_ptr(),
            genv_out.data_ptr(), genv_in.data_ptr(), T, float(dA), float(dD), float(dR),
            float(sus), torch.cuda.current_stream(dev).cuda_stream,
        )
    _ext.raise_on_error(err, "adsr_clock_scan_bwd")
    adsr_clock_scan_bwd.launches += 1
    return genv_in


def _backward_clock(args, outs, grads, **kw):
    trig, stage, env, _ = args
    gy, _, genv_out, _ = grads
    return None, None, adsr_clock_scan_bwd(trig, stage, env, gy, genv_out, **kw), None


# the launches as torch.autograd.Functions, their backwards adsr_scan_bwd and
# adsr_clock_scan_bwd; on CPU tensors (a call under torch.func) the clock's
# plain version stands in for its launch
_differentiable = diffable.kernel_function("adsr_scan", _launch, _backward)
_differentiable_clock = diffable.kernel_function(
    "adsr_clock_scan",
    lambda *args, **kw: (lambda env, st: (env, *st))(
        *(_launch_clock if args[0].is_cuda else adsr_clock_scan_ref)(*args, **kw)),
    _backward_clock)
