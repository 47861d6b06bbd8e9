"""PyTorch port: the reverse echo's and the string's backward in their
kernels' order.

``ops/reverse_echo.reverse_echo_scan_bwd_periods`` (the order of
``csrc/reverse_echo_scan_bwd.cu``: the forward's control results as
residuals, the periods in reverse, the pitch line's cotangent gathered row
by row in the order of ``echo_readers``, the channel sums in channel
order) and ``ops/ks.ks_scan_bwd_pipelined`` (the schedule of
``csrc/ks_scan_bwd.cu``: windows of the forward's ``window_length``, a
ring of L + 1 tape slots, a window's chain beside the adjoint of the one
after it and the seeds of the one before it) on the CPU, each against two
references on the same seeded inputs and cotangents: the port's plain
adjoint (``reverse_echo_scan_bwd_ref``, ``ks_scan_bwd_ref``) and
``jax.vjp`` of the JAX package's ``reverse_echo_scan_ref`` /
``ks_scan_ref`` (``ks_blocked`` for the all-active order).

Tolerances: the echo's 1e-5 of the largest cotangent of each output, the
card test's ``BWD_TOL`` (float32 sums in other orders: the kernel's fused
multiply-adds, its channel sums, its ratio's running sum; observed maxima
2.2e-7 against the plain adjoint and 1.2e-6 against ``jax.vjp``); the
string's pipelined order equals its plain adjoint bit for bit, at the new
windows and at the old ones of L - 1, and is within 1e-5 of ``jax.vjp``
(observed 3.8e-7). The kernels themselves are held to these
versions bit for bit on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 16 and 17). ``python
tests/test_torch_bwd_order_fx.py`` prints the observed maxima.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygmu2_tpu.ops.ks_block import ks_blocked as jax_ks_blocked
from pygmu2_tpu.ops.ks_pallas import ks_scan_ref as jax_ks_ref
from pygmu2_tpu.ops.reverse_echo_pallas import reverse_echo_scan_ref as jax_echo_ref
from pygmu2_tpu_torch.ops import diffable, ks
from pygmu2_tpu_torch.ops import reverse_echo as re_

torch.set_num_threads(1)

TOL = 1e-5  # of the largest cotangent of each output


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---- the reverse echo ----

ECHO_KW = dict(sr=8000.0, plen=64, cap=96, min_block=8, max_block=95, smooth_alpha=1.0 / 240)

# (T, C, ratio, alt, a mid-period start): a fifth up, a modulated ratio,
# unity (the pass-through), a ratio within 1e-4 of 1 with a stretch pitched
# up, a ratio below 1; alternating and reversed replay; C = 1 and 3; 40- and
# 25-sample periods (4 to 16 of them); a call entering mid-period
ECHO_CASES = {
    "fifth up, C=1": (400, 1, 1.5, 1.0, False),
    "modulated, C=3, reversed": (301, 3, "mod", 0.0, False),
    "unity, C=3": (200, 3, 1.0, 1.0, False),
    "near unity and pitched, C=3": (300, 3, "near", 1.0, False),
    "below one, C=1, reversed": (150, 1, 0.75, 0.0, False),
    "modulated, C=1, mid-period start": (230, 1, "mod", 1.0, True),
}


def _echo_np(T, C, ratio, alt, mid, seed, kw=ECHO_KW):
    """Seeded numpy arguments of an echo call and cotangents of its outputs."""
    rng = np.random.default_rng(seed)
    cap, plen, sr = kw["cap"], kw["plen"], kw["sr"]

    def n(*s):
        return rng.standard_normal(s).astype(np.float32)

    x, ba, bb, pb = n(T, C), n(cap, C), n(cap, C), n(plen, C)
    fb = rng.uniform(0.2, 0.6, T).astype(np.float32)
    if ratio == "mod":
        r = rng.uniform(0.7, 1.6, T).astype(np.float32)
    elif ratio == "near":
        r = (1.0 + rng.uniform(-5e-5, 5e-5, T)).astype(np.float32)
        r[T // 3:T // 2] = 1.3
    else:
        r = np.full(T, ratio, np.float32)
    blk = np.full(T, 40.0 / sr, np.float32)
    blk[T // 2:] = 25.0 / sr
    w = 10.0 if mid else 0.0
    misc = np.asarray([1, 3, 5.5, w, w, 40.0, 40, 40, 1], np.float32)
    args = [x, blk, r, fb, np.full(T, alt, np.float32), ba, bb, pb, misc]
    cts = [n(T, C), n(cap, C), n(cap, C), n(plen, C), n(9)]
    return args, cts


def _t(a):
    return torch.from_numpy(np.array(a))


def echo_errors(T, C, ratio, alt, mid, seed=0, kw=ECHO_KW, plain=False):
    """The kernel order's largest relative errors per output against the
    plain adjoint and against jax.vjp (``plain``: and the plain adjoint's
    against jax.vjp)."""
    args, cts = _echo_np(T, C, ratio, alt, mid, seed, kw)
    targs = [_t(a) for a in args]
    x, blk, r, fb, al, _, _, pb, misc = targs
    y = re_.reverse_echo_scan_ref(*targs, **kw)[0]
    call = (x, blk, r, fb, al, pb, misc, y, *map(_t, cts))
    got = re_.reverse_echo_scan_bwd_periods(*call, **kw)
    want = re_.reverse_echo_scan_bwd_ref(*call, **kw)

    def f(x, r, fb, ba, bb, pb, misc):
        return jax_echo_ref(x, args[1], r, fb, args[4], ba, bb, pb, misc, **kw)

    _, vjp = jax.vjp(f, *(jnp.asarray(args[i]) for i in (0, 2, 3, 5, 6, 7, 8)))
    want_jax = vjp(tuple(jnp.asarray(c) for c in cts))
    errs = ([_rel(g, w) for g, w in zip(got, want)],
            [_rel(g, w) for g, w in zip(got, want_jax)])
    if plain:
        errs += ([_rel(g, w) for g, w in zip(want, want_jax)],)
    return errs


@pytest.mark.parametrize("case", list(ECHO_CASES))
def test_echo_period_order_matches_plain_and_jax(case):
    plain, jax_ = echo_errors(*ECHO_CASES[case])
    assert max(plain) <= TOL, (case, plain)
    assert max(jax_) <= TOL, (case, jax_)


# a pitch line past the card backward's shared-memory index (20225 rows),
# where its readers' rows move to device memory: the plain adjoint and the
# kernel's order against jax.vjp, a fifth up and modulated, at a small T
ECHO_LONG_KW = dict(ECHO_KW, plen=20480)
ECHO_LONG_CASES = {
    "long line, fifth up, C=1": (200, 1, 1.5, 1.0, False),
    "long line, modulated, C=3, reversed": (170, 3, "mod", 0.0, False),
}


@pytest.mark.parametrize("case", list(ECHO_LONG_CASES))
def test_echo_long_pitch_line_matches_jax(case):
    assert re_.index_in_device_memory(ECHO_LONG_KW["plen"])
    assert not re_.index_in_device_memory(re_.SHARED_INDEX_MAX_PLEN)
    assert re_.index_in_device_memory(re_.SHARED_INDEX_MAX_PLEN + 1)
    order, order_jax, plain_jax = echo_errors(*ECHO_LONG_CASES[case], kw=ECHO_LONG_KW,
                                              plain=True)
    assert max(plain_jax) <= TOL, (case, plain_jax)
    assert max(order) <= TOL, (case, order)
    assert max(order_jax) <= TOL, (case, order_jax)


def test_echo_period_order_joins_across_a_cut():
    """A call cut mid-period into two: the second's backward (in the
    kernel's order) hands the rings', the pitch line's and misc's
    cotangents to the first's; joined, within TOL of the whole call's
    plain adjoint."""
    args, cts = _echo_np(300, 3, "mod", 1.0, False, 7)
    targs = [_t(a) for a in args]
    x, blk, r, fb, al, ba, bb, pb, misc = targs
    y = re_.reverse_echo_scan_ref(*targs, **ECHO_KW)[0]
    gy, gba, gbb, gpb, gm = map(_t, cts)
    want = re_.reverse_echo_scan_bwd_ref(x, blk, r, fb, al, pb, misc, y, gy, gba, gbb, gpb, gm,
                                         **ECHO_KW)
    cut = 117  # inside a 40-sample period
    head = [v[:cut] for v in (x, blk, r, fb, al)]
    tail = [v[cut:] for v in (x, blk, r, fb, al)]
    y1, ba1, bb1, pb1, m1 = re_.reverse_echo_scan_ref(*head, ba, bb, pb, misc, **ECHO_KW)
    assert int(m1[3]) != 0  # the cut is inside a period
    gx2, gr2, gfb2, ga1, gb1, gp1, gm1 = re_.reverse_echo_scan_bwd_periods(
        *tail, pb1, m1, y[cut:], gy[cut:], gba, gbb, gpb, gm, **ECHO_KW)
    gx1, gr1, gfb1, *state = re_.reverse_echo_scan_bwd_periods(
        *head, pb, misc, y1, gy[:cut], ga1, gb1, gp1, gm1, **ECHO_KW)
    got = [torch.cat([gx1, gx2]), torch.cat([gr1, gr2]), torch.cat([gfb1, gfb2]), *state]
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_echo_residual_table_gives_the_same_backward(monkeypatch):
    """The forward's control results, made on the CPU (``echo_control_ref``:
    the kernel's table layout), give the kernel order the backward it gets
    from the table it recomputes, bit for bit; their period bounds and
    write rows are the plain forward's. Through the card's autograd glue,
    its launch returning them as residuals and its backward the kernel
    order reading them (the plain versions standing in on the CPU), the
    gradient equals autograd of the plain forward within TOL."""
    args, cts = _echo_np(260, 2, "mod", 1.0, False, 3)
    targs = [_t(a) for a in args]
    x, blk, r, fb, al, ba, bb, pb, misc = targs
    y = re_.reverse_echo_scan_ref(*targs, **ECHO_KW)[0]
    res = re_.echo_control_ref(blk, r, al, misc, **ECHO_KW)
    tab, bounds, n_periods = res
    assert tab.shape == (260, 16) and tab.dtype == torch.int32
    n = int(n_periods[0])
    starts = bounds[:n + 1].tolist()
    assert starts[0] == 0 and starts[-1] == 260 and n > 4
    steps, _ = re_._control(blk, r, al, misc, **ECHO_KW)
    write_a = [s_[8] for s_ in steps]
    assert starts[1:-1] == [t for t in range(1, 260) if write_a[t] != write_a[t - 1]]
    assert tab[:, 13].tolist() == [s_[7] for s_ in steps]  # the write rows
    call = (x, blk, r, fb, al, pb, misc, y, *map(_t, cts))
    for a, b in zip(re_.reverse_echo_scan_bwd_periods(*call, res, **ECHO_KW),
                    re_.reverse_echo_scan_bwd_periods(*call, **ECHO_KW)):
        assert torch.equal(a, b)

    seen = []

    def recorded(*a, **kw):  # the launch through the Function, on the CPU
        y_, ba_, bb_, pb_, m_ = re_.reverse_echo_scan_ref(*a, **kw)
        with torch.no_grad():
            a[5].copy_(ba_)
            a[6].copy_(bb_)
        return (y_, a[5], a[6], pb_, m_, *re_.echo_control_ref(a[1], a[2], a[4], a[8], **kw))

    def bwd(*a, residuals=None, **kw):
        assert residuals is not None and len(residuals) == 3
        seen.append(residuals)
        return re_.reverse_echo_scan_bwd_periods(*a, residuals, **kw)

    def bwd_positional(*a, **kw):  # _backward hands the residuals positionally
        return bwd(*a[:13], residuals=a[13], **kw)

    monkeypatch.setattr(re_, "reverse_echo_scan_bwd", bwd_positional)
    fn = diffable.kernel_function("reverse_echo_scan", recorded, re_._backward, **re_.LAYOUT)
    ins = [v.clone().requires_grad_() for v in (x, r, fb, pb)]
    out = fn(ins[0], blk, ins[1], ins[2], al, ba.clone(), bb.clone(), ins[3], misc, **ECHO_KW)
    assert len(out) == 8
    got = torch.autograd.grad(out[0], ins, _t(cts[0]))
    assert len(seen) == 1 and torch.equal(seen[0][0], tab)
    plain = [v.clone().requires_grad_() for v in (x, r, fb, pb)]
    want = torch.autograd.grad(re_.reverse_echo_scan_ref(
        plain[0], blk, plain[1], plain[2], al, ba, bb, plain[3], misc, **ECHO_KW)[0], plain,
        _t(cts[0]))
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("ratio", ["mod", "near", 0.6])
def test_echo_reader_index_covers_every_tap_once(ratio):
    """``echo_readers``: every pass-through of a sample near unity and every
    tap of the others appears once, under the row of the input it reads;
    a row's readers come periods last first, then pass-throughs, taps 0 to
    3, each in time order."""
    T, plen = 300, ECHO_KW["plen"]
    args, _ = _echo_np(T, 1, ratio, 1.0, False, 11)
    _, blk, r, _, al, _, _, _, misc = [_t(a) for a in args]
    tab, bounds, n_periods = re_.echo_control_ref(blk, r, al, misc, **ECHO_KW)
    key, t, kind, first, count = re_.echo_readers(tab, bounds, n_periods, plen)
    taps, *_, rows = re_._decode(tab)
    near = (rows[:, 3] & re_.NEAR_UNITY) != 0
    want = {(s, 0) for s in range(T) if near[s]}
    want |= {(s, k) for s in range(T) if not near[s] for k in range(1, 5)}
    items = list(zip(t.tolist(), kind.tolist()))
    assert len(items) == len(set(items)) and set(items) == want
    assert int(count.sum()) == len(items) and count.shape == (T + plen,)
    n = int(n_periods[0])
    period = torch.searchsorted(bounds[1:n + 1].long(), t, right=True)
    for row in range(T + plen):
        a, m = int(first[row]), int(count[row])
        assert bool((key[a:a + m] == row).all())
        order = [(-int(period[i]), int(kind[i]), int(t[i])) for i in range(a, a + m)]
        assert order == sorted(order)
        for i in range(a, a + m):  # the reader reads the input of time row - plen
            s, k = int(t[i]), int(kind[i])
            src = s if k == 0 else s - (int(rows[s, 2]) - int(taps[s, k - 1])) % plen
            assert src == row - plen


# ---- the string ----

C_AP = 0.35
# L, blocked: the one-thread path (3, 8), the shortest windows (9: W = 4),
# the blocked order's shortest string (16), and strings with 2W + 1 = L
# (133, 535), where a window's last tape add lands in the slot a seed of
# the window two before reads
STRING_CASES = [(L, blocked) for L in (3, 8, 9, 16, 133, 535) for blocked in (False, True)]


def _string(L, blocked, seed):
    rng = np.random.default_rng(seed)
    T = 1200 if L > 100 else 400
    rho = rng.uniform(0.95, 0.999, T).astype(np.float32)
    act = np.ones(T, bool)
    if not blocked:  # an inactive head and a gap
        act[:25] = False
        act[T // 3:T // 3 + 20] = False
    buf = rng.standard_normal(L).astype(np.float32)
    r = np.int32(rng.integers(L))
    ai, ao = np.float32(0.1), np.float32(-0.2)
    cts = [rng.standard_normal(T).astype(np.float32), rng.standard_normal(L).astype(np.float32),
           np.float32(rng.standard_normal()), np.float32(rng.standard_normal())]
    return [rho, act, buf, r, ai, ao], cts


def string_errors(L, blocked, seed=0):
    """(the pipelined order and the old windows of L - 1 bit for bit with
    the plain adjoint, the pipelined order's largest relative errors
    against jax.vjp)."""
    args, cts = _string(L, blocked, seed)
    rho, act, buf, r, ai, ao = map(_t, args)
    all_active = blocked and L >= ks.BLOCKED_MIN_L
    y = ks.ks_scan_ref(rho, act, buf, r, ai, ao, L=L, allpass_c=C_AP, all_active=blocked)[0]
    call = (rho, None if all_active else act, buf, r, y, *map(_t, cts))
    kw = dict(L=L, allpass_c=C_AP)
    want = ks.ks_scan_bwd_ref(*call, **kw)
    got = ks.ks_scan_bwd_pipelined(*call, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ks, "bwd_window", lambda L_: L_ - 1)  # the first design's windows
        old = ks.ks_scan_bwd_ref(*call, **kw)
    equal = all(torch.equal(g, w) for g, w in zip(got, want)) and all(
        torch.equal(o, w) for o, w in zip(old, want))

    def f(rho_, buf_, ai_, ao_):
        if all_active:
            out = jax_ks_blocked(rho_, buf_, args[3], ai_, ao_, L=L, allpass_c=C_AP)
        else:
            out = jax_ks_ref(rho_, args[1], buf_, args[3], ai_, ao_, L=L, allpass_c=C_AP)
        return out[0], out[1], out[3], out[4]

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (args[0], args[2], args[4], args[5])))
    want_jax = vjp(tuple(jnp.asarray(c) for c in cts))
    return equal, [_rel(g, w) for g, w in zip(got, want_jax)]


@pytest.mark.parametrize("L,blocked", STRING_CASES)
def test_string_pipelined_order_keeps_the_plain_adjoint(L, blocked):
    equal, jax_ = string_errors(L, blocked)
    assert equal
    assert max(jax_) <= TOL, jax_


def test_string_window_is_the_forwards():
    """The backward's window is the forward's (2W + 1 <= L, at most 1024);
    the strings walked sample by sample keep L - 1."""
    for L in (9, 10, 133, 535, 2049, 2050, 51201):
        W = ks.bwd_window(L)
        assert W == ks.window_length(L) and 2 * W + 1 <= L and W <= ks.MAX_WINDOW
    for L in range(2, ks.SERIAL_MAX_L + 1):
        assert ks.bwd_window(L) == L - 1


if __name__ == "__main__":
    for name, case in ECHO_CASES.items():
        print("echo", name, *echo_errors(*case))
    for name, case in ECHO_LONG_CASES.items():
        print("echo", name, *echo_errors(*case, kw=ECHO_LONG_KW, plain=True))
    for case in STRING_CASES:
        print("string", case, *string_errors(*case))
