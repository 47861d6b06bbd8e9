"""PyTorch port: the comb's and the echo's block-order functions
(``ops/comb_block.comb_const_delay``, ``ops/reverse_echo_block.
reverse_echo_aligned``) against the JAX package's on the CPU, and against
the port's sequential plain versions on the same inputs.

Tolerances: bit for bit with the JAX functions (every output, the state
too). XLA's CPU program of each contracts ``x + fb * delayed`` into one
rounding, where the port's sequential plain versions (and the card
kernels) round the product and the sum apart. So against the sequential
versions: the comb within 1e-5 (an ulp a sample, carried through the
feedback, |fb| < 0.95; observed 4.8e-7), the echo's wet output and
written blocks within 1e-6 (its window also differs by an ulp in a few
percent of the rows: glibc's ``cosf`` against ``torch.cos``), their
integer state equal.
"""

import numpy as np
import pytest
import torch

from pygmu2_tpu.ops.comb_block import comb_const_delay as jax_comb
from pygmu2_tpu.ops.reverse_echo_block import reverse_echo_aligned as jax_echo
from pygmu2_tpu_torch.ops import comb, reverse_echo
from pygmu2_tpu_torch.ops.comb_block import comb_const_delay
from pygmu2_tpu_torch.ops.reverse_echo_block import reverse_echo_aligned

torch.set_num_threads(1)
SR = 44100.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.astype(np.float64), want.astype(np.float64)), \
        float(np.abs(got.astype(np.float64) - want).max())


# (T, C, L, d, pos): d = 8, a d that does not divide T, d = L - 1, short calls
COMB_CASES = {
    "d8": (1000, 2, 64, 8, 5),
    "d_not_dividing_T": (1000, 3, 400, 37, 390),
    "d_L_minus_1": (700, 1, 150, 149, 0),
    "T_below_L": (90, 2, 300, 41, 250),
}


def _comb_inputs(T, C, L, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, C)).astype(np.float32)
    fb = rng.uniform(-0.95, 0.95, T).astype(np.float32)
    buf = rng.standard_normal((L, C)).astype(np.float32)
    return x, fb, buf


@pytest.mark.parametrize("case", sorted(COMB_CASES))
def test_comb_const_delay_equals_jax(case):
    T, C, L, d, pos = COMB_CASES[case]
    x, fb, buf = _comb_inputs(T, C, L, seed=len(case))
    want = jax_comb(x, fb, buf, np.int32(pos), d=d, L=L)
    got = comb_const_delay(_t(x), _t(fb), _t(buf), pos, d=d, L=L)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("case", sorted(COMB_CASES))
def test_comb_const_delay_equals_sequential_comb(case):
    """The port's plain comb at the constant frequency sr / d, from the
    smoother's fixed point (sf = f), computes the same recurrence."""
    T, C, L, d, pos = COMB_CASES[case]
    x, fb, buf = _comb_inputs(T, C, L, seed=len(case))
    f = np.float32(SR / d)
    assert int(np.rint(np.float32(SR) / f)) == d
    y, buf2, pos2 = comb_const_delay(_t(x), _t(fb), _t(buf), pos, d=d, L=L)
    want = comb.comb_scan_ref(_t(x), torch.full((T,), float(f)), _t(fb), _t(buf),
                              torch.tensor(pos, dtype=torch.int32),
                              torch.tensor(float(f)), L=L, sr=SR, smooth_alpha=0.01)
    assert float((y - want[0]).abs().max()) <= 1e-5
    assert float((buf2 - want[1]).abs().max()) <= 1e-5
    assert int(pos2) == int(want[2])


# (T, C, Lb, alternate, w_idx, prev_block, cur_is_a, reverse)
ECHO_CASES = {
    "alternate": (2000, 2, 256, True, 0, 256, 1, 1),
    "one_direction": (2000, 2, 256, False, 0, 256, 0, 1),
    "Lb_not_dividing_T_mid_block": (1500, 3, 333, True, 120, 333, 0, 0),
    "fresh_state": (900, 1, 200, False, 0, 0, 1, 1),
    "T_below_Lb": (150, 2, 400, True, 390, 400, 1, 0),
}
PLEN, CAP = 128, 512


def _echo_inputs(T, C, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, C)).astype(np.float32)
    fb = rng.uniform(0.0, 0.9, T).astype(np.float32)
    buf_a = rng.standard_normal((CAP, C)).astype(np.float32)
    buf_b = rng.standard_normal((CAP, C)).astype(np.float32)
    pitch = rng.standard_normal((PLEN, C)).astype(np.float32)
    return x, fb, buf_a, buf_b, pitch


def _echo_state(case):
    _, _, Lb, _, w_idx, prev_block, cur_is_a, rev = ECHO_CASES[case]
    return dict(cur_is_a=cur_is_a, p_wpos=17, p_rpos=np.float32(40.25), w_idx=w_idx,
                prev_block=prev_block, reverse=rev)


@pytest.mark.parametrize("case", sorted(ECHO_CASES))
def test_reverse_echo_aligned_equals_jax(case):
    T, C, Lb, alternate, *_ = ECHO_CASES[case]
    x, fb, buf_a, buf_b, pitch = _echo_inputs(T, C, seed=len(case))
    st = _echo_state(case)
    want = jax_echo(x, fb, buf_a, buf_b, pitch, np.int32(st["cur_is_a"]),
                    np.int32(st["p_wpos"]), st["p_rpos"], np.int32(st["w_idx"]),
                    np.int32(st["prev_block"]), np.int32(st["reverse"]),
                    Lb=Lb, plen=PLEN, ratio=1.0, alternate=alternate)
    got = reverse_echo_aligned(_t(x), _t(fb), _t(buf_a), _t(buf_b), _t(pitch),
                               st["cur_is_a"], st["p_wpos"], st["p_rpos"], st["w_idx"],
                               st["prev_block"], st["reverse"], Lb=Lb, plen=PLEN,
                               ratio=1.0, alternate=alternate)
    assert np.abs(np.asarray(want[0])).max() > 0.1
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("case", sorted(ECHO_CASES))
def test_reverse_echo_aligned_against_sequential_echo(case):
    T, C, Lb, alternate, *_ = ECHO_CASES[case]
    x, fb, buf_a, buf_b, pitch = _echo_inputs(T, C, seed=len(case))
    st = _echo_state(case)
    got = reverse_echo_aligned(_t(x), _t(fb), _t(buf_a), _t(buf_b), _t(pitch),
                               st["cur_is_a"], st["p_wpos"], st["p_rpos"], st["w_idx"],
                               st["prev_block"], st["reverse"], Lb=Lb, plen=PLEN,
                               ratio=1.0, alternate=alternate)
    misc = torch.tensor([st["cur_is_a"], st["p_wpos"], st["p_rpos"], st["w_idx"],
                         st["w_idx"], Lb, Lb, st["prev_block"], st["reverse"]],
                        dtype=torch.float32)
    blk = torch.full((T,), Lb / SR)
    assert float(torch.round(blk[0].float() * SR)) == Lb
    y, ba, bb, pb, misc2 = reverse_echo.reverse_echo_scan_ref(
        _t(x), blk, torch.ones(T), _t(fb), torch.full((T,), float(alternate)),
        _t(buf_a), _t(buf_b), _t(pitch), misc, sr=SR, plen=PLEN, cap=CAP, min_block=64,
        max_block=CAP - 1, smooth_alpha=0.001)
    for g, w in ((got[0], y), (got[1], ba), (got[2], bb)):
        assert float((g - w).abs().max()) <= 1e-6
    _equal(got[3], pb.numpy())
    # cur_is_a, p_wpos, w_idx, prev_block, reverse; r_idx == w_idx
    for i, k in ((4, 0), (5, 1), (7, 3), (7, 4), (8, 7), (9, 8)):
        assert int(got[i]) == int(misc2[k]), (i, k)
    assert abs(float(got[6]) - float(misc2[2])) <= 1e-2  # the read position, closed form
