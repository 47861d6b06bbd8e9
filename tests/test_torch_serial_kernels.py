"""PyTorch port, serial kernels: each plain version against the JAX
package's Pallas kernel run in interpret mode (as tests/test_ladder_pallas.py,
test_comb_pallas.py and test_adsr_pallas.py run them), plus the port's
prefix sum and first-order scan against the JAX package.

Inputs come from numpy with a seed; JAX stays on the CPU. Tolerances are
the JAX tests' own: ladder 1e-5, comb 1e-5 (smoothed frequency 1e-4),
ADSR 1e-6. The kernels' own orders (``comb_scan_windows``,
``adsr_scan_phases``) are held to the plain loops bit for bit, and the
ADSR's to the JAX package's ``adsr_scan_ref`` and ``adsr_closed_form`` bit
for bit as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygmu2_tpu.ops.adsr_block import adsr_closed_form
from pygmu2_tpu.ops.adsr_pallas import adsr_scan_pallas
from pygmu2_tpu.ops.adsr_pallas import adsr_scan_ref as adsr_scan_ref_jax
from pygmu2_tpu.ops.comb_pallas import comb_scan_pallas
from pygmu2_tpu.ops.ladder_pallas import ladder_scan_pallas
from pygmu2_tpu.ops.linrec import affine_scan_1 as jax_affine_scan_1
from pygmu2_tpu_torch.ops import adsr, comb, ladder
from pygmu2_tpu_torch.ops.linrec import affine_scan_1
from pygmu2_tpu_torch.ops.phase import prefix_sum

torch.set_num_threads(1)

SR = 44100


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# (T, C): a padded T (700 % 256 != 0), one lane, a few lanes, all 128 lanes
SHAPES = [(700, 1), (700, 3), (1024, 128)]


@pytest.mark.parametrize("T,C", SHAPES)
@pytest.mark.parametrize("mode_index", [0, 2, 4])
def test_ladder_plain_matches_pallas(T, C, mode_index):
    rng = np.random.default_rng(3 + C + mode_index)
    x = (rng.standard_normal((T, C)) * 0.5).astype(np.float32)
    x[100:180] = 1e-7  # quiet stretch: the state-decay branch
    al = rng.uniform(0.1, 0.6, T).astype(np.float32)
    qa = rng.uniform(0.9, 1.1, T).astype(np.float32)
    ki = rng.uniform(0.0, 3.0, T).astype(np.float32)
    dsc = rng.uniform(0.5, 1.5, T).astype(np.float32)
    st = (rng.standard_normal((9, C)) * 0.1).astype(np.float32)
    kw = dict(os_n=2, pbg=0.5, mode_index=mode_index, input_threshold=1e-5,
              state_decay=0.95)
    y_j, s_j = ladder_scan_pallas(
        *(jnp.asarray(a) for a in (x, al, qa, ki, dsc, st)), chunk=256,
        interpret=True, **kw,
    )
    y, s = ladder.ladder_scan(*(_t(a) for a in (x, al, qa, ki, dsc, st)), **kw)
    _close(y, y_j, 1e-5)
    _close(s, s_j, 1e-5)


def _comb_inputs(T, C, L, modulated, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, C)) * 0.3).astype(np.float32)
    if modulated:
        freq = rng.uniform(220, 880, T).astype(np.float32)
    else:
        freq = np.full(T, 330.0, np.float32)
    fb = rng.uniform(-0.9, 0.9, T).astype(np.float32)
    buf = (rng.standard_normal((L, C)) * 0.1).astype(np.float32)
    return x, freq, fb, buf


@pytest.mark.parametrize("T,C", SHAPES)
@pytest.mark.parametrize("modulated", [True, False], ids=["modulated", "constant"])
def test_comb_plain_matches_pallas(T, C, modulated):
    L = 201  # short ring: many wraps
    x, freq, fb, buf = _comb_inputs(T, C, L, modulated, seed=1 + C)
    kw = dict(L=L, sr=float(SR), smooth_alpha=1 / 2400)
    y_j, b_j, p_j, s_j = comb_scan_pallas(
        *(jnp.asarray(a) for a in (x, freq, fb, buf)), jnp.int32(5),
        jnp.float32(-1.0), chunk=256, interpret=True, **kw,
    )
    y, b, p, s = comb.comb_scan(
        *(_t(a) for a in (x, freq, fb, buf)), torch.tensor(5, dtype=torch.int32),
        torch.tensor(-1.0), **kw,
    )
    _close(y, y_j, 1e-5)
    _close(b, b_j, 1e-5)
    assert int(p) == int(p_j) and p.dtype == torch.int32
    _close(s, s_j, 1e-4)


def test_comb_state_handoff_matches_one_call():
    T, C, L = 900, 3, 2206
    x, freq, fb, buf = _comb_inputs(T, C, L, True, seed=7)
    kw = dict(L=L, sr=float(SR), smooth_alpha=1 / 2400)
    args = [_t(a) for a in (x, freq, fb)]
    one = comb.comb_scan(*args, _t(buf), torch.tensor(3, dtype=torch.int32),
                         torch.tensor(-1.0), **kw)
    y1, b1, p1, s1 = comb.comb_scan(*(a[:400] for a in args), _t(buf),
                                    torch.tensor(3, dtype=torch.int32),
                                    torch.tensor(-1.0), **kw)
    y2, b2, p2, s2 = comb.comb_scan(*(a[400:] for a in args), b1, p1, s1, **kw)
    assert torch.equal(torch.cat([y1, y2]), one[0])
    assert torch.equal(b2, one[1]) and int(p2) == int(one[2])
    assert torch.equal(s2, one[3])


# the kernel's windows: (frequency kind, smoothing) beside the card's
# cases, each at C = 1, 23 (a partial channel group) and 128
COMB_WINDOW_CASES = {
    "modulated": ("modulated", 1 / 2400),
    "jumping_delay": ("jumps", 0.5),  # the delay halves and doubles mid-window
    "delay_1": (1, 1 / 2400),
    "delay_2": (2, 1 / 2400),
    "delay_7": (7, 1 / 2400),
}


def _comb_window_inputs(case, C, T=1500, L=2206):
    kind, alpha = COMB_WINDOW_CASES[case]
    x, freq, fb, buf = _comb_inputs(T, C, L, True, seed=C + len(case))
    if kind == "modulated":
        freq = np.random.default_rng(C).uniform(200, 240, T).astype(np.float32)
    elif kind == "jumps":
        freq = np.where((np.arange(T) // 300) % 2 == 1, 300.0, 150.0).astype(np.float32)
    else:
        freq = np.full(T, SR / kind, np.float32)
    return (x, freq, fb, buf), dict(L=L, sr=float(SR), smooth_alpha=alpha)


@pytest.mark.parametrize("C", [1, 23, 128])
@pytest.mark.parametrize("case", sorted(COMB_WINDOW_CASES))
def test_comb_windows_equal_plain_and_jax(case, C):
    """The kernel's order (the smoother alone, every delay from it, greedy
    windows, then each window's samples and channels at once) equals the
    plain per-sample loop bit for bit, and the JAX reference within the
    file's tolerances."""
    from pygmu2_tpu.ops.comb_pallas import comb_scan_ref as jax_comb_ref

    arrays, kw = _comb_window_inputs(case, C)
    state = (torch.tensor(2200, dtype=torch.int32), torch.tensor(-1.0))
    args = (*(_t(a) for a in arrays), *state)
    want = comb.comb_scan_ref(*args, **kw)
    got = comb.comb_scan_windows(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    j = jax.jit(jax_comb_ref, static_argnames=("L", "sr", "smooth_alpha"))(
        *(jnp.asarray(a) for a in arrays), jnp.int32(2200), jnp.float32(-1.0), **kw
    )
    _close(want[0], j[0], 1e-5)
    _close(want[1], j[1], 1e-5)
    assert int(want[2]) == int(j[2])
    _close(want[3], j[3], 1e-4)


def test_comb_windows_state_handoff_matches_one_call():
    arrays, kw = _comb_window_inputs("jumping_delay", 23)
    args = [_t(a) for a in arrays]
    state = (torch.tensor(5, dtype=torch.int32), torch.tensor(-1.0))
    one = comb.comb_scan_ref(*args, *state, **kw)
    first = comb.comb_scan_windows(*(a[:700] for a in args[:3]), args[3], *state, **kw)
    second = comb.comb_scan_windows(*(a[700:] for a in args[:3]), *first[1:], **kw)
    assert torch.equal(torch.cat([first[0], second[0]]), one[0])
    for g, w in zip(second[1:], one[1:]):
        assert torch.equal(g, w)


def _adsr_params(A=0.01, D=0.02, S=0.6, R=0.05):
    return dict(dA=1.0 / (A * SR), dD=(S - 1.0) / (D * SR), dR=-S / (R * SR), sus=S)


def _many_edges(T, seed):
    rng = np.random.default_rng(seed)
    gate = np.zeros(T, np.float32)
    edges = np.sort(rng.choice(T, size=40, replace=False))
    for a, b in zip(edges[::2], edges[1::2]):
        gate[a:b] = 1.0
    return gate


@pytest.mark.parametrize("T", [700, 2048])
def test_adsr_gated_plain_matches_pallas(T):
    gate = _many_edges(T, seed=T)
    gate[50:400] = 1.0  # one long note through attack, decay and sustain
    st = np.array([2.0, 0.8, 3.0, 1.0], np.float32)  # mid-decay, gate high
    kw = _adsr_params()
    y_j, s_j = adsr_scan_pallas(jnp.asarray(gate), jnp.asarray(st), chunk=512,
                                interpret=True, **kw)
    y, s, _ = adsr.adsr_scan(_t(gate), _t(st), **kw)
    _close(y, y_j, 1e-6)
    _close(s, s_j, 1e-6)


@pytest.mark.parametrize("T", [700, 2048])
def test_adsr_triggered_plain_matches_pallas(T):
    rng = np.random.default_rng(T + 1)
    trig = np.zeros(T, np.float32)
    trig[rng.choice(T, size=6, replace=False)] = 1.0
    trig[20] = 1.0
    st = np.array([3.0, 0.7, 100.0, 0.0], np.float32)  # in sustain, 100 in
    kw = _adsr_params(A=0.002, D=0.003, S=0.7, R=0.004)
    S = 221
    y_j, s_j = adsr_scan_pallas(jnp.asarray(trig), jnp.asarray(st), chunk=512,
                                sustain_samples=S, interpret=True, **kw)
    y, s, _ = adsr.adsr_scan(_t(trig), _t(st), sustain_samples=S, **kw)
    _close(y, y_j, 1e-6)
    _close(s, s_j, 1e-6)


@pytest.mark.parametrize("S", [1, 1 << 24])
def test_adsr_triggered_count_limits_match_pallas(S):
    """Sustain counts at the float32 count's ends, which the card's kernel
    no longer refuses: the plain version against the JAX kernel."""
    trig = np.zeros(2048, np.float32)
    trig[[20, 700, 705, 1500]] = 1.0
    st = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
    kw = _adsr_params(A=0.002, D=0.003, S=0.7, R=0.004)
    y_j, s_j = adsr_scan_pallas(jnp.asarray(trig), jnp.asarray(st), chunk=512,
                                sustain_samples=S, interpret=True, **kw)
    y, s, _ = adsr.adsr_scan(_t(trig), _t(st), sustain_samples=S, **kw)
    assert np.abs(np.asarray(y_j)).max() > 0.5
    _close(y, y_j, 1e-6)
    _close(s, s_j, 1e-6)


# ---- the ADSR kernel's order: edges, a walk over the edges, every sample ----

_jax_adsr_ref = jax.jit(adsr_scan_ref_jax, static_argnames=("dA", "dD", "dR", "sus",
                                                           "sustain_samples"))
_PHASE_T = 1024
# incoming states [stage, e0, n, prev_gate] as the machine leaves them, with
# parameter overrides: every stage, SUSTAIN 100 samples in, and a release
# so slow that its count reaches 2**24 and stops there
PHASE_STATES = {
    "idle": ([0, 0.0, 0, 0], {}),
    "attack": ([1, 0.3, 5, 1], {}),
    "decay": ([2, 0.9, 10, 1], {}),
    "sustain_n100": ([3, 0.6, 100, 1], {}),
    "release": ([4, 0.5, 7, 0], {}),
    "slow_release_near_2_24": ([4, 0.5, 2**24 - 3, 0], {"dR": -1e-9}),
}


def _phase_gate(kind, triggered, T=_PHASE_T):
    """No edge, one edge, chip_smoke.py's many-edges gate, or an edge every
    sample (gated: alternating levels; triggered: a trigger every sample)."""
    g = np.zeros(T, np.float32)
    if kind == "every_sample":
        return np.ones(T, np.float32) if triggered else (np.arange(T) % 2).astype(np.float32)
    if kind == "one":
        g[57:] = 1.0
    elif kind == "many":
        g[100:T // 3] = 1.0
        g[T // 2:T - 100:37] = 1.0
    return (np.diff(g, prepend=0.0) > 0).astype(np.float32) if triggered else g


def _equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("state", sorted(PHASE_STATES))
@pytest.mark.parametrize("gate", ["none", "one", "many", "every_sample"])
def test_adsr_phases_equal_plain_and_jax(gate, state):
    """The kernel's order equals the plain per-sample loop, the JAX
    package's adsr_scan_ref and its edge-parallel adsr_closed_form bit for
    bit (env and state), gated and at sustain counts 1, 2206, 2**24 and
    2**24 + 1 (which rounds to 2**24 in float32)."""
    st, over = PHASE_STATES[state]
    kw = dict(_adsr_params(), **over)
    st = np.asarray(st, np.float32)
    for S in (None, 1, 2206, 1 << 24, (1 << 24) + 1):
        g = _phase_gate(gate, S is not None)
        want = adsr.adsr_scan_ref(_t(g), _t(st), sustain_samples=S, **kw)
        _equal(adsr.adsr_scan_phases(_t(g), _t(st), sustain_samples=S, **kw), want)
        jax_in = (jnp.asarray(g), jnp.asarray(st))
        _equal(want, _jax_adsr_ref(*jax_in, sustain_samples=S, **kw))
        if state != "slow_release_near_2_24":
            # the closed form counts on past 2**24 (n0 + tau rounds to
            # even where the machine's count stops): outside its domain of
            # segments shorter than 2**24 samples
            _equal(want, adsr_closed_form(*jax_in, sustain_samples=S, K_cap=_PHASE_T, **kw))


@pytest.mark.parametrize("S", [None, 2206], ids=["gated", "triggered"])
@pytest.mark.parametrize("at", ["crossing", "edge"])
def test_adsr_phases_state_handoff(at, S):
    """Two calls cut next to the first attack's crossing (the first DECAY
    sample emits exactly 1) or its edge equal one call of the plain loop."""
    g = _phase_gate("many", S is not None, T=2048)
    kw = dict(_adsr_params(), sustain_samples=S)
    st = torch.zeros(4)
    one = adsr.adsr_scan_ref(_t(g), st, **kw)
    c = int(np.argmax(one[0].numpy() == 1.0)) if at == "crossing" else 100
    assert c > 100 or at == "edge"
    for cut in (c - 1, c, c + 1):
        first = adsr.adsr_scan_phases(_t(g[:cut]), st, **kw)
        second = adsr.adsr_scan_phases(_t(g[cut:]), first[1], **kw)
        _equal((torch.cat([first[0], second[0]]), second[1], second[2]), one)


@pytest.mark.parametrize("T", [1, 3, 6, 1027])
def test_adsr_phases_short_and_odd_calls(T):
    rng = np.random.default_rng(T)
    levels = (rng.random(T) < 0.3).astype(np.float32)
    for S, g in ((None, np.cumsum(levels) % 2), (300, levels)):
        g = g.astype(np.float32)
        for st in ([0, 0.0, 0, 0], [1, 0.7, 3, 1], [4, 0.2, 2, 1]):
            st = torch.tensor(st, dtype=torch.float32)
            kw = dict(_adsr_params(A=0.0002, D=0.0003, R=0.0004), sustain_samples=S)
            _equal(adsr.adsr_scan_phases(_t(g), st, **kw), adsr.adsr_scan_ref(_t(g), st, **kw))


def test_adsr_phases_take_plain_version_outside_machine_states():
    """A stage code the machine does not have, or a count that is not an
    integer in [0, 2**24], runs per sample, in the kernel as here."""
    g = _phase_gate("many", False, T=400)
    for st in ([5, 0.5, 3, 0], [2, 0.9, 2.5, 1], [1, 0.2, -1, 0], [4, 0.5, 2**25, 0]):
        st = torch.tensor(st, dtype=torch.float32)
        assert not adsr.in_closed_form(st)
        _equal(adsr.adsr_scan_phases(_t(g), st, **_adsr_params()),
               adsr.adsr_scan_ref(_t(g), st, **_adsr_params()))
    assert adsr.in_closed_form(torch.tensor([4, 0.5, 2**24, 0], dtype=torch.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adsr_phases_random_machines(seed):
    """Random gates, densities, parameters (sustain 0 and 1 included),
    stages and counts (0, small, at and near 2**24)."""
    rng = np.random.default_rng(seed)
    for it in range(30):
        T = int(rng.integers(1, 300))
        A, D, R = rng.uniform(0.00005, 0.002, 3)
        sus = float(rng.choice([rng.uniform(0.0, 1.0), 0.0, 1.0]))
        kw = dict(dA=1 / (A * SR), dD=(sus - 1) / (D * SR), dR=-max(sus, 0.01) / (R * SR), sus=sus)
        S = None if it % 2 == 0 else int(rng.choice([0, 1, 2, int(rng.integers(1, 300)), 1 << 24]))
        p = [0.02, 0.3, 0.6][it % 3]
        if S is None:
            g = (np.cumsum(rng.random(T) < p) % 2).astype(np.float32)
            g[rng.random(T) < 0.05] = 0.5  # neither level: no edge
        else:
            g = ((rng.random(T) < p) * rng.uniform(0.1, 1.0)).astype(np.float32)
        stage = int(rng.integers(0, 5))
        n0 = float(rng.choice([0, int(rng.integers(0, 200)), 2**24 - int(rng.integers(0, 5))]))
        e0 = {0: 0.0, 1: rng.uniform(0, 1), 2: rng.uniform(sus, 1), 3: sus,
              4: rng.uniform(0, sus)}[stage]
        st = torch.tensor([stage, e0, n0, float(rng.integers(0, 2))], dtype=torch.float32)
        _equal(adsr.adsr_scan_phases(_t(g), st, sustain_samples=S, **kw),
               adsr.adsr_scan_ref(_t(g), st, sustain_samples=S, **kw))


def test_adsr_env_of_state_matches_jax():
    """The carried envelope: ``env_of_state`` and every wrapper's
    ``env_next`` equal the JAX PE's ``env_of_state`` bit for bit (XLA
    rounds ``e0 + n * d`` once), mid-ramp as at a block's end."""
    from pygmu2_tpu.ops.adsr_pallas import env_of_state as jax_env_of_state

    kw = _adsr_params()
    jax_env = jax.jit(jax_env_of_state, static_argnames=("dA", "dD", "dR", "sus"))
    states = [[0, 0.3, 5, 0], [1, 0.1, 40, 1], [2, 1.0, 30, 1], [3, 0.6, 9, 1], [4, 0.6, 70, 0]]
    rng = np.random.default_rng(7)
    states += [[st, rng.uniform(0, 1), int(rng.integers(0, 4000)), 0]
               for st in (1, 2, 4) for _ in range(30)]
    for st in states:
        st = np.asarray(st, np.float32)
        _equal([adsr.env_of_state(_t(st), **kw)], [jax_env(jnp.asarray(st), **kw)])
    g = _phase_gate("many", False, T=2048)
    for cut in range(1, 2048, 97):  # ends of calls in every stage
        _, st, nxt = adsr.adsr_scan_ref(_t(g[:cut]), torch.zeros(4), **kw)
        want = jax_env(jnp.asarray(st.numpy()), **kw)
        _equal([nxt], [want])
        _equal([adsr.adsr_scan_phases(_t(g[:cut]), torch.zeros(4), **kw)[2]], [want])


@pytest.mark.parametrize("pe", ["gated", "triggered"])
def test_adsr_pe_blocks_equal_jax(pe):
    """Both ADSR PEs rendered in short blocks, each block ending mid-ramp
    somewhere, equal the JAX PEs bit for bit: the carried envelope is
    rounded as the JAX PE rounds it."""
    import pygmu2_tpu as jpg
    import pygmu2_tpu_torch as tpg

    def build(pg):
        pg.set_sample_rate(SR)
        if pe == "gated":
            env = pg.AdsrGatedPE(pg.PeriodicGate(60.0, duty_cycle=0.4), 0.003, 0.004, 0.6, 0.005)
        else:
            env = pg.AdsrTriggeredPE(pg.PeriodicTrigger(hz=45.0), 0.003, 0.004, 0.003, 0.6,
                                     0.005)
        return pg.CropPE(env, 0, 3000)

    want = np.asarray(jpg.render_to_array(build(jpg), block=500))
    got = tpg.render_to_array(build(tpg), block=500, device="cpu")
    assert np.abs(want).max() > 0.5
    _equal([got], [want])


def _clock_state(device="cpu"):
    return (torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.float64, device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def test_wrappers_take_plain_version_on_cpu():
    counters = (ladder.ladder_scan, comb.comb_scan, adsr.adsr_scan, adsr.adsr_clock_scan)
    before = [fn.launches for fn in counters]
    y, _, _ = adsr.adsr_scan(torch.ones(8), torch.zeros(4), **_adsr_params())
    y2, _ = adsr.adsr_clock_scan(torch.ones(8), *_clock_state(), t0=0, sustain_samples=0,
                                 **_adsr_params())
    assert y.device.type == y2.device.type == "cpu"
    assert [fn.launches for fn in counters] == before


def test_wrappers_refuse_other_devices():
    meta = torch.zeros((4, 1), device="meta")
    col = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ladder.ladder_scan(meta, col, col, col, col, torch.zeros((9, 1), device="meta"),
                           os_n=2, pbg=0.5, mode_index=0, input_threshold=1e-5,
                           state_decay=0.95)
    with pytest.raises(ValueError, match="no kernel for device"):
        comb.comb_scan(meta, col, col, meta, None, None, L=4, sr=44100.0,
                       smooth_alpha=0.1)
    with pytest.raises(ValueError, match="no kernel for device"):
        adsr.adsr_scan(col, col, **_adsr_params())
    with pytest.raises(ValueError, match="no kernel for device"):
        adsr.adsr_clock_scan(col, *_clock_state("meta"), t0=0, sustain_samples=0,
                             **_adsr_params())


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 4410, 16384])
def test_prefix_sum_equals_jax_cumsum_bitwise(n):
    rng = np.random.default_rng(n)
    for a in (rng.random(n) * 1e-2, np.full(n, 220.0 / SR)):
        want = np.asarray(jnp.cumsum(jnp.asarray(a)))
        assert np.array_equal(prefix_sum(_t(a)).numpy(), want)
    a2 = rng.random((3, n)).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(a2), axis=1))
    assert np.array_equal(prefix_sum(_t(a2), dim=1).numpy(), want)


@pytest.mark.parametrize("T", [1000, 16384])
def test_affine_scan_1_at_leak_0999(T):
    """The leaky integrator's scan: a near-unit-radius map (leak 0.999)
    over a full block, against the JAX scan and a float64 sequential
    oracle."""
    rng = np.random.default_rng(T)
    u = (rng.standard_normal(T) * 0.05).astype(np.float32)
    a = np.full(T, 0.999, np.float32)
    s0 = np.float32(0.3)
    got = affine_scan_1(_t(a), _t(u), torch.tensor(s0)).numpy()
    want = np.asarray(
        jax.jit(jax_affine_scan_1)(jnp.asarray(a), jnp.asarray(u), jnp.float32(s0))
    )
    seq = np.empty(T)
    acc, leak = float(s0), float(a[0])  # the float32 leak, in float64
    for i in range(T):
        acc = leak * acc + float(u[i])
        seq[i] = acc
    _close(got, want, 1e-5)
    # float32 against float64: relative 1e-5 of the output's peak
    _close(got, seq, 1e-5 * max(1.0, np.abs(seq).max()))
