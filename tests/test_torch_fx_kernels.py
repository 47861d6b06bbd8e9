"""PyTorch port, the effects chain's serial kernels: each plain version
against the JAX package's reference of its Pallas kernel (the ``lax.scan``
with the kernel's op order, as tests/test_ks_pallas.py,
test_envelope_pallas.py, test_slew_pallas.py and
test_reverse_echo_pallas.py hold the kernels to it), and a state handed
across two calls against one call.

Inputs come from numpy with a seed; JAX stays on the CPU. Tolerances are
the JAX tests' own: Karplus-Strong 1e-5, envelope 1e-5, slew 2e-6,
reverse echo 2e-5. A hand-off equals one call bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygmu2_tpu.ops.envelope_pallas import envelope_ar_scan_ref as jax_envelope_ref
from pygmu2_tpu.ops.ks_block import ks_blocked as jax_ks_blocked
from pygmu2_tpu.ops.ks_pallas import ks_scan_ref as jax_ks_ref
from pygmu2_tpu.ops.reverse_echo_pallas import reverse_echo_scan_ref as jax_echo_ref
from pygmu2_tpu.ops.slew_pallas import slew_scan_ref as jax_slew_ref
from pygmu2_tpu_torch.ops import envelope, ks, reverse_echo, slew
from pygmu2_tpu_torch.ops.linrec import affine_scan_2, affine_scan_2_seg

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _handoff(fn, n_time, args, cut, kw):
    """(two calls across ``cut``, one call): the first ``n_time`` arguments
    run along time, the rest are the state the first call hands on."""
    one = fn(*args, **kw)
    first = fn(*(a[:cut] for a in args[:n_time]), *args[n_time:], **kw)
    second = fn(*(a[cut:] for a in args[:n_time]), *first[1:], **kw)
    return (torch.cat([first[0], second[0]]), *second[1:]), one


# ---- Karplus-Strong --------------------------------------------------------


def _ks_inputs(T, L, seed):
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.95, 0.999, T).astype(np.float32)
    act = np.arange(T) >= 37  # the string starts mid-call
    buf = rng.standard_normal(L).astype(np.float32)
    return rho, act, buf


@pytest.mark.parametrize("L", [7, 171])
@pytest.mark.parametrize("T", [700, 2048])
def test_ks_plain_matches_jax(T, L):
    rho, act, buf = _ks_inputs(T, L, seed=T + L)
    kw = dict(L=L, allpass_c=0.35)
    want = jax.jit(jax_ks_ref, static_argnames=("L", "allpass_c"))(
        jnp.asarray(rho), jnp.asarray(act), jnp.asarray(buf), jnp.int32(3),
        jnp.float32(0.1), jnp.float32(-0.2), **kw,
    )
    got = ks.ks_scan(_t(rho), _t(act), _t(buf), torch.tensor(3, dtype=torch.int32),
                     torch.tensor(0.1), torch.tensor(-0.2), **kw)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    assert got[2].dtype == torch.int32 and int(got[2]) == int(want[2])


# the kernel's windows: the strings of the card's cases (2 and 7: one
# thread per sample; 133 and 535: the chain's highest and lowest; one
# longer than shared memory holds), each with four activity masks
KS_WINDOW_LENGTHS = [2, 7, 133, 535, ks.MAX_KERNEL_L + 1]
KS_MASKS = ["start", "all", "none", "gaps"]


def _ks_window_inputs(L, mask, T=2000):
    rho, act, buf = _ks_inputs(T, L, seed=L)
    act = {"start": act, "all": np.ones(T, bool), "none": np.zeros(T, bool),
           "gaps": np.random.default_rng(L + 1).random(T) < 2 / 3}[mask]
    return rho, act, buf


@pytest.mark.parametrize("mask", KS_MASKS)
@pytest.mark.parametrize("L", KS_WINDOW_LENGTHS)
def test_ks_windows_equal_plain_and_jax(L, mask):
    """The kernel's order (the active samples compacted, a window's
    averages at once, then the allpass's serial chain) equals the plain
    per-sample loop bit for bit, and the JAX reference within 1e-5."""
    rho, act, buf = _ks_window_inputs(L, mask)
    kw = dict(L=L, allpass_c=0.35)
    r = 3 % L
    args = (_t(rho), _t(act), _t(buf), torch.tensor(r, dtype=torch.int32),
            torch.tensor(0.1), torch.tensor(-0.2))
    want = ks.ks_scan_ref(*args, **kw)
    _equal(ks.ks_scan_windows(*args, **kw), want)
    jax_want = jax.jit(jax_ks_ref, static_argnames=("L", "allpass_c"))(
        jnp.asarray(rho), jnp.asarray(act), jnp.asarray(buf), jnp.int32(r),
        jnp.float32(0.1), jnp.float32(-0.2), **kw,
    )
    for g, w in zip(want, jax_want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("L", KS_WINDOW_LENGTHS)
def test_ks_windows_handoff_at_a_window_edge(L):
    """Two calls cut at a window's edge (the string starts at 37) equal one."""
    rho, act, buf = _ks_window_inputs(L, "start")
    args = (_t(rho), _t(act), _t(buf), torch.tensor(0, dtype=torch.int32),
            torch.tensor(0.0), torch.tensor(0.0))
    cut = 37 + 3 * max(1, ks.window_length(L))
    got, _ = _handoff(ks.ks_scan_windows, 2, args, cut, dict(L=L, allpass_c=0.6))
    _equal(got, ks.ks_scan_ref(*args, L=L, allpass_c=0.6))


@pytest.mark.parametrize("L", [7, 171])
def test_ks_state_handoff_matches_one_call(L):
    rho, act, buf = _ks_inputs(900, L, seed=L)
    args = (_t(rho), _t(act), _t(buf), torch.tensor(0, dtype=torch.int32),
            torch.tensor(0.0), torch.tensor(0.0))
    _equal(*_handoff(ks.ks_scan, 2, args, 400, dict(L=L, allpass_c=0.6)))


# the blocked order (every sample active, L >= 16; the JAX KarplusStrongPE's
# ops/ks_block.ks_blocked): B = min(L - 1, 512) with every remainder mod 8
# of B's rows and columns, calls shorter than B and than L, a read head
# inside the string
KS_BLOCKED_CASES = [(16, 100, 5), (133, 1500, 0), (178, 700, 9), (300, 1024, 299),
                    (400, 900, 1), (535, 2000, 17), (600, 300, 4)]


@pytest.mark.parametrize("L, T, r", KS_BLOCKED_CASES)
def test_ks_blocked_equals_jax_bit_for_bit(L, T, r):
    """The plain version of the blocked order equals the JAX package's
    ``ks_blocked`` on the CPU bit for bit: the allpass's matrix-vector
    product in the order of XLA's GEMV (``ks.xla_gemv``) and its fused
    multiply-adds where XLA's program fuses."""
    rng = np.random.default_rng(L + T)
    rho = rng.uniform(0.95, 0.999, T).astype(np.float32)
    buf = rng.standard_normal(L).astype(np.float32)
    kw = dict(L=L, allpass_c=0.35)
    want = jax_ks_blocked(jnp.asarray(rho), jnp.asarray(buf), jnp.int32(r),
                          jnp.float32(0.1), jnp.float32(-0.2), **kw)
    got = ks.ks_scan(_t(rho), torch.ones(T, dtype=torch.bool), _t(buf),
                     torch.tensor(r, dtype=torch.int32), torch.tensor(0.1),
                     torch.tensor(-0.2), all_active=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ks_blocked_diagonals_are_the_matrix():
    """The card kernel reads ``TRIL``'s first column as every diagonal: the
    matrix is Toeplitz, and ``(-c)^(j+1)`` continues the column."""
    B, tril, powv = ks.blocked_tables(535, 0.35)
    jk = np.arange(B)[:, None] - np.arange(B)[None, :]
    np.testing.assert_array_equal(tril, np.where(jk >= 0, tril[np.clip(jk, 0, None), 0], 0.0))
    np.testing.assert_array_equal(powv[:-1], tril[1:, 0])


@pytest.mark.parametrize("L", [7, 171])
def test_ks_scan_all_active_takes_the_blocked_order_from_16(L):
    rho, _act, buf = _ks_inputs(600, L, seed=L)
    args = (_t(rho), torch.ones(600, dtype=torch.bool), _t(buf),
            torch.tensor(2, dtype=torch.int32), torch.tensor(0.0), torch.tensor(0.0))
    kw = dict(L=L, allpass_c=0.6)
    want = (ks.ks_blocked_ref(*args[:1], *args[2:], **kw) if L >= ks.BLOCKED_MIN_L
            else ks.ks_scan_ref(*args, **kw))
    _equal(ks.ks_scan(*args, all_active=True, **kw), want)


# ---- envelope follower ---------------------------------------------------


def _rectified(T, C, seed):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((T, C)) * 0.5).astype(np.float32)
    x[T // 3: T // 2] *= 1e-3  # a quiet stretch: the release branch
    return x


ENV_KW = dict(atk=1.0 - np.exp(-1.0 / (0.002 * 44100)), rel=1.0 - np.exp(-1.0 / (0.05 * 44100)))


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("T", [700, 2048])
def test_envelope_plain_matches_jax(T, C):
    x = _rectified(T, C, seed=T + C)
    env0 = np.linspace(0.0, 0.3, C).astype(np.float32)
    want = jax.jit(jax_envelope_ref, static_argnames=("atk", "rel"))(
        jnp.asarray(x), jnp.asarray(env0), **ENV_KW
    )
    got = envelope.envelope_ar_scan(_t(x), _t(env0), **ENV_KW)
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)


@pytest.mark.parametrize("C", [1, 3])
def test_envelope_plain_equals_jax_bit_for_bit(C):
    """The update is one fused multiply-add, as XLA's program on the CPU
    forms it: the plain version equals the JAX reference bit for bit."""
    x = _rectified(1500, C, seed=C)
    env0 = np.linspace(0.0, 0.3, C).astype(np.float32)
    want = jax.jit(jax_envelope_ref, static_argnames=("atk", "rel"))(
        jnp.asarray(x), jnp.asarray(env0), **ENV_KW
    )
    got = envelope.envelope_ar_scan(_t(x), _t(env0), **ENV_KW)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_envelope_state_handoff_matches_one_call():
    args = (_t(_rectified(900, 3, seed=1)), torch.zeros(3))
    _equal(*_handoff(envelope.envelope_ar_scan, 1, args, 333, ENV_KW))


# ---- slew limiter ------------------------------------------------------------


def _slew_kw(linear):
    if linear:  # units per sample: 2000/s up, 500/s down at 44.1 kHz
        return dict(linear=True, p_rise=2000.0 / 44100, p_fall=500.0 / 44100)
    return dict(linear=False, p_rise=0.05, p_fall=0.002)


def _steps(T, seed):
    rng = np.random.default_rng(seed)
    return np.repeat(rng.uniform(-1.0, 1.0, T // 50 + 1), 50)[:T].astype(np.float32)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "exponential"])
@pytest.mark.parametrize("T", [700, 2048])
def test_slew_plain_matches_jax(T, linear):
    x = _steps(T, seed=T)
    kw = _slew_kw(linear)
    want = jax.jit(jax_slew_ref, static_argnames=("linear", "p_rise", "p_fall"))(
        jnp.asarray(x), jnp.float32(0.25), **kw
    )
    got = slew.slew_scan(_t(x), torch.tensor(0.25), **kw)
    _close(got[0], want[0], 2e-6)
    _close(got[1], want[1], 2e-6)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "exponential"])
def test_slew_state_handoff_matches_one_call(linear):
    args = (_t(_steps(900, seed=2)), torch.tensor(0.0))
    _equal(*_handoff(slew.slew_scan, 1, args, 401, _slew_kw(linear)))


# ---- reverse echo --------------------------------------------------------------

ECHO_SR = 8000  # the JAX tests' rate: short rings, many block swaps
ECHO_PLEN = ECHO_SR // 60
ECHO_CAP = int(0.05 * ECHO_SR)
ECHO_KW = dict(sr=float(ECHO_SR), plen=ECHO_PLEN, cap=ECHO_CAP, min_block=64,
               max_block=ECHO_CAP - 1, smooth_alpha=1 / 2400)


def _echo_inputs(T, C, ratio, alt, seed, modulated=False, block_s=0.02):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, C)) * 0.3).astype(np.float32)
    t = np.arange(T, dtype=np.float32)
    blk = np.full(T, block_s, np.float32)  # 0.02: 160-sample blocks
    if modulated:  # block length, pitch and feedback move per sample
        blk = (0.02 + 0.01 * np.sin(t / 211.0)).astype(np.float32)
        ratio = np.maximum(1.0 + 0.5 * np.sin(t / 97.0), 0.001).astype(np.float32)
        fb = (0.4 + 0.3 * np.sin(t / 131.0)).astype(np.float32)
    else:
        ratio = np.full(T, ratio, np.float32)
        fb = np.full(T, 0.6, np.float32)
    alt = np.full(T, alt, np.float32)
    misc = np.zeros(9, np.float32)
    init_block = float(min(max(block_s * ECHO_SR, 64), ECHO_CAP - 1))
    misc[0], misc[5], misc[6], misc[8] = 1, init_block, int(init_block), 1
    rings = [np.zeros((ECHO_CAP, C), np.float32), np.zeros((ECHO_CAP, C), np.float32),
             np.zeros((ECHO_PLEN, C), np.float32)]
    return [x, blk, ratio, fb, alt, *rings, misc]


ECHO_CASES = {
    "unity": dict(ratio=1.0, alt=0.0),
    "fifth_up": dict(ratio=1.5, alt=0.0),
    "fifth_up_alternating": dict(ratio=1.5, alt=1.0),
    "modulated": dict(ratio=1.0, alt=0.0, modulated=True),
}


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("case", sorted(ECHO_CASES))
def test_reverse_echo_plain_matches_jax(case, C):
    T = 1200 if C == 1 else 700
    args = _echo_inputs(T, C, seed=C, **ECHO_CASES[case])
    want = jax.jit(jax_echo_ref, static_argnames=tuple(ECHO_KW))(
        *(jnp.asarray(a) for a in args), **ECHO_KW
    )
    got = reverse_echo.reverse_echo_scan(*(_t(a) for a in args), **ECHO_KW)
    assert np.abs(np.asarray(want[0])).max() > 1e-3  # the echo fired
    for g, w in zip(got, want):
        _close(g, w, 2e-5)


def test_reverse_echo_state_handoff_matches_one_call():
    args = [_t(a) for a in _echo_inputs(900, 2, ratio=1.5, alt=1.0, seed=4)]
    _equal(*_handoff(reverse_echo.reverse_echo_scan, 5, args, 333, ECHO_KW))


def _mid_period(args, seed):
    """``args`` with a call that starts mid-period: a state part way into a
    block, with the previous block and the pitch line holding audio."""
    rng = np.random.default_rng(seed)
    for k in (5, 6, 7):  # buf_a, buf_b, the pitch line
        args[k] = (rng.standard_normal(args[k].shape) * 0.3).astype(np.float32)
    # cur_is_a, p_wpos, p_rpos, w_idx, r_idx, smoothed, cur_block,
    # prev_block, reverse
    args[8] = np.array([0, 57, 13.7, 40, 40, 160, 160, 150, 0], np.float32)
    return args


# the kernel's period decomposition: (T, C, inputs) beside ECHO_CASES
ECHO_PERIOD_CASES = {
    **{f"{name}_C{C}": (1200 if C == 1 else 700, C, kw, False)
       for name, kw in ECHO_CASES.items() for C in (1, 3)},
    # min_block: 64-sample periods
    "min_block_C1": (1200, 1, dict(ratio=1.5, alt=1.0, block_s=64 / ECHO_SR), False),
    "min_block_C3": (700, 3, dict(ratio=1.0, alt=0.0, block_s=64 / ECHO_SR), False),
    "mid_period_C1": (1200, 1, dict(ratio=1.5, alt=1.0), True),
    "mid_period_C3": (700, 3, dict(ratio=1.0, alt=0.0, modulated=True), True),
    # fewer samples than the pitch line's slots
    "short_C3": (ECHO_PLEN - 33, 3, dict(ratio=0.75, alt=0.0), True),
}


@pytest.mark.parametrize("case", sorted(ECHO_PERIOD_CASES))
def test_reverse_echo_periods_equal_plain(case):
    """The kernel's order (a control table, then each block period's
    samples together, the pitch line gathered from the input) equals the
    plain per-sample loop bit for bit."""
    T, C, kw, mid = ECHO_PERIOD_CASES[case]
    args = _echo_inputs(T, C, seed=C + 7, **kw)
    if mid:
        args = _mid_period(args, seed=C)
    args = [_t(a) for a in args]
    want = reverse_echo.reverse_echo_scan_ref(*args, **ECHO_KW)
    got = reverse_echo.reverse_echo_scan_periods(*args, **ECHO_KW)
    assert want[0].abs().max() > 1e-3  # the echo fired
    _equal(got, want)


# ---- the filters' order-2 scan at near-unit poles ----------------------------


def _resonator_errors(f0, q, T=16384):
    """A band-pass biquad's feedback (float32 coefficients) over T samples
    of noise through the flat doubling scan, the segmented scan and a
    sequential float32 recursion: (the three max abs errors against a
    float64 recursion, the output's peak)."""
    rng = np.random.default_rng(int(f0))
    x = (rng.standard_normal(T) * 0.3).astype(np.float32)
    w = 2 * np.pi * f0 / 44100
    alpha = np.sin(w) / (2 * q)
    a1, a2 = np.float32(-2 * np.cos(w) / (1 + alpha)), np.float32((1 - alpha) / (1 + alpha))
    b = np.float32(alpha / (1 + alpha))
    fir = (b * x - b * np.concatenate([[0, 0], x[:-2]])).astype(np.float32)
    want, seq = np.empty(T), np.empty(T, np.float32)
    y1, y2, s1, s2 = 0.0, 0.0, np.float32(0), np.float32(0)
    for n in range(T):
        y1, y2 = float(fir[n]) - float(a1) * y1 - float(a2) * y2, y1
        s1, s2 = fir[n] - a1 * s1 - a2 * s2, s1
        want[n], seq[n] = y1, s1
    col = lambda v: torch.full((T, 1), float(v))  # noqa: E731
    args = (col(-a1), col(-a2), col(1.0), col(0.0), _t(fir)[:, None], col(0.0))
    errs = [np.abs(scan(*args)[0][:, 0].numpy() - want).max()
            for scan in (affine_scan_2, affine_scan_2_seg)]
    return [*errs, np.abs(seq - want).max()], np.abs(want).max()


# (f0 Hz, Q): the pole radius 0.9929, 0.9965 (the chain's wah), 0.9996
RESONATORS = [(200.0, 2.0), (300.0, 6.0), (100.0, 20.0)]


@pytest.mark.parametrize("f0,q", RESONATORS)
def test_flat_scan_does_not_drift_beyond_the_segmented_scan(f0, q):
    """The flat associative scan of the JAX package drifts on near-unit
    poles (hence its segmented scan); the port's doubling scan does not:
    both sit alike above a sequential float32 recursion."""
    (flat, seg, _seq), peak = _resonator_errors(f0, q)
    assert flat <= 1.5 * seg and seg <= 0.1 * peak


# ---- the wrappers -------------------------------------------------------------

COUNTERS = (ks.ks_scan, envelope.envelope_ar_scan, slew.slew_scan,
            reverse_echo.reverse_echo_scan)


def test_wrappers_take_plain_version_on_cpu():
    before = [fn.launches for fn in COUNTERS]
    y, _ = slew.slew_scan(torch.ones(8), torch.tensor(0.0), **_slew_kw(True))
    env, _ = envelope.envelope_ar_scan(torch.ones((8, 2)), torch.zeros(2), **ENV_KW)
    assert y.device.type == env.device.type == "cpu"
    assert [fn.launches for fn in COUNTERS] == before


def test_wrappers_refuse_other_devices():
    col = torch.zeros(4, device="meta")
    mat = torch.zeros((4, 1), device="meta")
    scalar = torch.zeros((), device="meta")
    calls = [
        lambda: ks.ks_scan(col, col.bool(), col, scalar, scalar, scalar, L=4, allpass_c=0.5),
        lambda: envelope.envelope_ar_scan(mat, torch.zeros(1, device="meta"), **ENV_KW),
        lambda: slew.slew_scan(col, scalar, **_slew_kw(False)),
        lambda: reverse_echo.reverse_echo_scan(mat, col, col, col, col, mat, mat, mat,
                                               col, **ECHO_KW),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device"):
            call()


if __name__ == "__main__":
    # ``python tests/test_torch_fx_kernels.py`` prints the observed maxima:
    # the checks record their errors instead of asserting
    import itertools

    jax.config.update("jax_platforms", "cpu")
    worst, case = {}, [""]

    def _close(got, want, atol):  # noqa: F811
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = float(np.abs(got - want).max()) if got.size else 0.0
        worst[case[0]] = max(worst.get(case[0], 0.0), err)

    for T, L in itertools.product((700, 2048), (7, 171)):
        case[0] = "ks_scan plain vs JAX ks_scan_ref"
        test_ks_plain_matches_jax(T, L)
    for T, C in itertools.product((700, 2048), (1, 3)):
        case[0] = "envelope_ar_scan plain vs JAX envelope_ar_scan_ref"
        test_envelope_plain_matches_jax(T, C)
    for T, linear in itertools.product((700, 2048), (True, False)):
        case[0] = "slew_scan plain vs JAX slew_scan_ref"
        test_slew_plain_matches_jax(T, linear)
    for name, C in itertools.product(sorted(ECHO_CASES), (1, 3)):
        case[0] = "reverse_echo_scan plain vs JAX reverse_echo_scan_ref"
        test_reverse_echo_plain_matches_jax(name, C)
    for name, err in worst.items():
        print(f"{name}: max abs err {err:.3g}")
    for f0, q in RESONATORS:
        (flat, seg, seq), peak = _resonator_errors(f0, q)
        print(f"order-2 scan, f0={f0} Q={q}: flat {flat:.3g}, segmented {seg:.3g}, "
              f"sequential float32 {seq:.3g} against float64 (peak {peak:.3g})")
