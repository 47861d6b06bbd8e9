"""PyTorch port on the card: the CUDA kernels against their plain versions.

Marked ``cuda``; every test skips where no CUDA device is present. On a
machine with the card and nvcc:
``python -m pytest tests/test_torch_cuda.py --noconftest`` (no JAX needed).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_osc_rows import synthetic_rows
from pygmu2_tpu_torch import bench_workload
from pygmu2_tpu_torch.soundfont import filter_kernels as fk
from pygmu2_tpu_torch.soundfont import offline as off

pytestmark = pytest.mark.cuda

SECONDS = 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(large, device):
    synth, midi = bench_workload.build_workload(large)
    return bench_workload.audio_pass_rows(synth, midi, SECONDS, device)


@pytest.mark.parametrize("large", [False, True], ids=["small_font", "large_font"])
def test_kernel_matches_plain(cuda, large):
    rows, wave, N = _rows(large, cuda)
    before = fk.osc_filter_gain_mix.launches
    got, st = fk.osc_filter_gain_mix(rows, wave, N)
    torch.cuda.synchronize()
    assert fk.osc_filter_gain_mix.launches == before + 1
    ref, st_ref = fk.osc_filter_gain_mix_ref(rows, wave, N)
    assert ref.abs().max() > 1.0
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=0, atol=1e-4)


def test_kernel_state_handoff(cuda):
    rows, wave, N = _rows(False, cuda)
    cut = rows["ratio"].shape[0] // 2
    one, st_one = fk.osc_filter_gain_mix(rows, wave, N)
    o1, st1 = fk.osc_filter_gain_mix({k: v[:cut] for k, v in rows.items()}, wave, N)
    o2, st2 = fk.osc_filter_gain_mix(
        {k: v[cut:] for k, v in rows.items()}, wave, N, st1
    )
    torch.testing.assert_close(torch.cat([o1, o2]), one, rtol=0, atol=1e-5)
    torch.testing.assert_close(st2, st_one, rtol=0, atol=1e-5)


def _synthetic(device, B, P, fresh_blocks, seed):
    rows, wave, state = synthetic_rows(B, P, 4096, seed, fresh_blocks)
    return ({k: torch.from_numpy(v).to(device) for k, v in rows.items()},
            torch.from_numpy(wave).to(device), torch.from_numpy(state).to(device))


@pytest.mark.parametrize("P", [1, 33, 256])
@pytest.mark.parametrize("B,fresh", [(1, (0,)), (5, (2,))], ids=["B1_fresh0", "B5_fresh2"])
def test_kernel_odd_shapes_match_plain_and_cut(cuda, P, B, fresh):
    """N = 1000: two segments of a block, the second a part one, not a
    multiple of the 32-sample tile; P = 1, 33 (a part block of voices) and
    256 (eight blocks of voices); a fresh epoch at block 0 or mid-call.
    Within 3e-5 x scale of the plain version (the kernel-level bound of
    tests/test_torch_filter_kernel.py) and 1e-5 x scale of its own order in
    torch ops (the same cut, other roundings: fused multiply-adds)."""
    n = 1000
    rows, wave, state = _synthetic(cuda, B, P, fresh, seed=P + B)
    got, st = fk.osc_filter_gain_mix(rows, wave, n, state)
    torch.cuda.synchronize()
    ref, st_ref = fk.osc_filter_gain_mix_ref(rows, wave, n, state)
    cut, st_cut = fk.osc_filter_gain_mix_cut(rows, wave, n, state)
    scale = max(float(ref.abs().max()), 1.0)
    assert float(ref.abs().max()) > 0.1
    torch.testing.assert_close(got, ref, rtol=0, atol=3e-5 * scale)
    torch.testing.assert_close(st, st_ref, rtol=0, atol=3e-5 * scale)
    torch.testing.assert_close(got, cut, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(st, st_cut, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("case", ["bench large font", "B=70 P=256 N=1000"])
def test_kernel_two_calls_equal_bits(cuda, case):
    """The entering states and the mix are summed in a fixed order: two calls
    return the same bits (70 blocks of two segments: five groups of
    entering states, eight blocks of voices)."""
    if case == "bench large font":
        rows, wave, n = _rows(True, cuda)
        state = None
    else:
        n = 1000
        rows, wave, state = _synthetic(cuda, 70, 256, (9, 40), seed=7)
    first = fk.osc_filter_gain_mix(rows, wave, n, state)
    second = fk.osc_filter_gain_mix(rows, wave, n, state)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_render_on_card_matches_cpu(cuda):
    synth, midi = bench_workload.build_workload(True)
    on_cpu = off.render_midi_offline(synth, midi, SECONDS, device="cpu")
    on_card = off.render_midi_offline(synth, midi, SECONDS, device=cuda)
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-4)
    streamed = off.render_midi_offline_streamed(
        synth, midi, SECONDS, seg_blocks=5, device=cuda
    )
    np.testing.assert_allclose(streamed, on_card, rtol=0, atol=1e-5)


# ---- the PE-graph slice: serial kernels and the subtractive patch ----


def _seeded(device, seed, *shapes, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(lo, hi, s).astype(np.float32)).to(device)
            for s in shapes]


@pytest.mark.parametrize("C", [1, 128])
def test_ladder_kernel_matches_plain(cuda, C):
    from pygmu2_tpu_torch.ops import ladder

    T = 2048
    x, al, qa, ki, dsc, st = _seeded(cuda, C, (T, C), (T,), (T,), (T,), (T,), (9, C))
    al, ki = al.abs() * 0.5 + 0.05, ki.abs() * 3.0
    kw = dict(os_n=2, pbg=0.5, mode_index=0, input_threshold=1e-5, state_decay=0.95)
    before = ladder.ladder_scan.launches
    y, s = ladder.ladder_scan(x, al, qa, ki, dsc, st, **kw)
    torch.cuda.synchronize()
    assert ladder.ladder_scan.launches == before + 1
    y_ref, s_ref = ladder.ladder_scan_ref(x, al, qa, ki, dsc, st, **kw)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(s, s_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("os_n", [1, 3, 4])
def test_ladder_kernel_instantiations_match_plain(cuda, os_n):
    """os_n 1 and 4 take their own instantiations, 3 the generic one; C = 33
    leaves a partial warp. Bit for bit."""
    from pygmu2_tpu_torch.ops import ladder

    T, C = 1024, 33
    x, al, qa, ki, dsc, st = _seeded(cuda, os_n, (T, C), (T,), (T,), (T,), (T,), (9, C))
    al, ki = al.abs() * 0.5 + 0.05, ki.abs() * 3.0
    kw = dict(os_n=os_n, pbg=0.5, mode_index=os_n, input_threshold=1e-5, state_decay=0.95)
    got = ladder.ladder_scan(x, al, qa, ki, dsc, st, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ladder.ladder_scan_ref(x, al, qa, ki, dsc, st, **kw)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("C", [1, 128])
def test_comb_kernel_matches_plain(cuda, C):
    from pygmu2_tpu_torch.ops import comb

    T, L = 2048, 2206
    x, fb, buf = _seeded(cuda, C, (T, C), (T,), (L, C))
    (freq,) = _seeded(cuda, C + 1, (T,), lo=200.0, hi=240.0)
    pos = torch.tensor(7, dtype=torch.int32, device=cuda)
    sf = torch.tensor(-1.0, device=cuda)
    kw = dict(L=L, sr=44100.0, smooth_alpha=1 / 2400)
    got = comb.comb_scan(x, freq, fb * 0.9, buf, pos, sf, **kw)
    torch.cuda.synchronize()
    ref = comb.comb_scan_ref(x, freq, fb * 0.9, buf, pos, sf, **kw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("delay,C", [(1, 1), (1, 23), (2, 23), (220, 23)])
def test_comb_kernel_short_delays_and_odd_width(cuda, delay, C):
    """Delay 1 (every window one sample: the serial walk) and C = 23 (a
    partial channel group); bit for bit."""
    from pygmu2_tpu_torch.ops import comb

    T, L = 2048, 2206
    x, fb, buf = _seeded(cuda, delay + C, (T, C), (T,), (L, C))
    freq = torch.full((T,), 44100.0 / delay, device=cuda)
    state = (torch.tensor(2200, dtype=torch.int32, device=cuda), torch.tensor(-1.0, device=cuda))
    kw = dict(L=L, sr=44100.0, smooth_alpha=1 / 2400)
    before = comb.comb_scan.launches
    got = comb.comb_scan(x, freq, fb * 0.9, buf, *state, **kw)
    torch.cuda.synchronize()
    assert comb.comb_scan.launches == before + 1
    for g, r in zip(got, comb.comb_scan_ref(x, freq, fb * 0.9, buf, *state, **kw)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def _adsr_switch():
    """The kernel's kSerialAbove: the most edges a tile takes on the edge
    walk; past it, the per-sample walk."""
    src = Path(__file__).resolve().parents[1] / "pygmu2_tpu_torch" / "csrc" / "adsr_scan.cu"
    return int(re.search(r"constexpr int kSerialAbove = (\d+);", src.read_text())[1])


def _adsr_gate(kind, T, triggered):
    """One edge, many, one every sample, or the first kSerialAbove (or 2
    more) samples an edge each."""
    g = np.zeros(T, np.float32)
    if kind == "every_sample":
        return np.ones(T, np.float32) if triggered else (np.arange(T) % 2).astype(np.float32)
    if kind in ("edges_at_switch", "edges_past_switch"):
        n = _adsr_switch() + (2 if kind == "edges_past_switch" else 0)  # even: n edges
        g[:n] = 1.0 if triggered else (np.arange(n) + 1) % 2
        return g
    g[100:700] = 1.0
    if kind == "many_edges":
        g[1500:3000:7] = 1.0
    return (np.diff(g, prepend=0.0) > 0).astype(np.float32) if triggered else g


_ADSR_KW = dict(dA=1 / 441.0, dD=-0.4 / 882.0, dR=-0.6 / 2205.0, sus=0.6)


def _adsr_equals_plain(gate, state, **kw):
    """One kernel call, env, state and env_next bit for bit against the
    plain version on the CPU."""
    from pygmu2_tpu_torch.ops import adsr

    want = adsr.adsr_scan_ref(gate.cpu(), state.cpu(), **kw)
    before = adsr.adsr_scan.launches
    got = adsr.adsr_scan(gate, state, **kw)
    torch.cuda.synchronize()
    assert adsr.adsr_scan.launches == before + 1
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("gate", ["one_edge", "many_edges", "edges_at_switch",
                                  "edges_past_switch", "every_sample"])
@pytest.mark.parametrize("sustain_samples", [None, 300], ids=["gated", "triggered"])
def test_adsr_kernel_matches_plain(cuda, sustain_samples, gate):
    """The edge walk (up to kSerialAbove edges a tile) and the per-sample
    walk (2 more, an edge every sample)."""
    g = torch.from_numpy(_adsr_gate(gate, 4096, sustain_samples is not None)).to(cuda)
    _adsr_equals_plain(g, torch.zeros(4, device=cuda), sustain_samples=sustain_samples,
                       **_ADSR_KW)


@pytest.mark.parametrize("sustain_samples", [None, 1, 300, 2**24, 2**24 + 1])
def test_adsr_kernel_states_and_call_shapes(cuda, sustain_samples):
    """Every incoming stage, SUSTAIN 100 samples in, a slow release near the
    count's 2**24 and states the machine does not produce (the per-sample
    walk); calls of 1, 3 and 5 samples, an unaligned gate, three tiles
    (20000 samples), and an edge every sample from each state."""
    trig = sustain_samples is not None
    g = torch.from_numpy(_adsr_gate("many_edges", 4096, trig)).to(cuda)
    every = torch.from_numpy(_adsr_gate("every_sample", 2500, trig)).to(cuda)
    for st, dR in (([0, 0.0, 0, 0], None), ([1, 0.3, 5, 1], None), ([2, 0.9, 10, 1], None),
                   ([3, 0.6, 100, 1], None), ([4, 0.5, 7, 0], None),
                   ([4, 0.5, 2**24 - 3, 0], -1e-9), ([5, 0.5, 3, 0], None),
                   ([2, 0.9, 2.5, 1], None)):
        kw = dict(_ADSR_KW, sustain_samples=sustain_samples)
        if dR is not None:
            kw["dR"] = dR
        state = torch.tensor(st, dtype=torch.float32, device=cuda)
        _adsr_equals_plain(g[:700], state, **kw)
        _adsr_equals_plain(every, state, **kw)
    kw = dict(_ADSR_KW, sustain_samples=sustain_samples)
    for n in (1, 3, 5):
        _adsr_equals_plain(g[99:99 + n], torch.zeros(4, device=cuda), **kw)
    _adsr_equals_plain(g[3:], torch.zeros(4, device=cuda), **kw)
    long = torch.from_numpy(np.tile(_adsr_gate("many_edges", 4000, trig), 5)).to(cuda)
    _adsr_equals_plain(long, torch.zeros(4, device=cuda), **kw)


@pytest.mark.parametrize("sustain_samples", [None, 300], ids=["gated", "triggered"])
def test_adsr_kernel_state_handoffs(cuda, sustain_samples):
    """Two kernel calls cut at the first attack's crossing (the first DECAY
    sample emits exactly 1), next to it, and at an edge equal one plain
    call."""
    from pygmu2_tpu_torch.ops import adsr

    kw = dict(_ADSR_KW, sustain_samples=sustain_samples)
    g = torch.from_numpy(_adsr_gate("many_edges", 4096, sustain_samples is not None))
    want = adsr.adsr_scan_ref(g, torch.zeros(4), **kw)
    c = int(np.argmax(want[0].numpy() == 1.0))
    g = g.to(cuda)
    for cut in (c - 1, c, c + 1, 100, 101, 1500):
        first = adsr.adsr_scan(g[:cut], torch.zeros(4, device=cuda), **kw)
        second = adsr.adsr_scan(g[cut:], first[1], **kw)
        assert torch.equal(torch.cat([first[0], second[0]]).cpu(), want[0])
        assert torch.equal(second[1].cpu(), want[1])
        assert torch.equal(second[2].cpu(), want[2])


@pytest.mark.parametrize("sustain_samples", [0, 2**24 - 1])
def test_adsr_clock_kernel_matches_plain(cuda, sustain_samples):
    from pygmu2_tpu_torch.ops import adsr

    trig = torch.zeros(4096, device=cuda)
    trig[[10, 900, 905, 3000]] = 1.0
    state = (torch.tensor(3, dtype=torch.int32, device=cuda),
             torch.tensor(0.6, dtype=torch.float64, device=cuda),
             torch.tensor(12345 + 5, dtype=torch.int64, device=cuda))
    kw = dict(t0=12345, dA=1 / 441.0, dD=-0.4 / 882.0, dR=-0.6 / 2205.0, sus=0.6,
              sustain_samples=sustain_samples)
    before = adsr.adsr_clock_scan.launches
    y, st = adsr.adsr_clock_scan(trig, *state, **kw)
    torch.cuda.synchronize()
    assert adsr.adsr_clock_scan.launches == before + 1
    y_ref, st_ref = adsr.adsr_clock_scan_ref(trig, *state, **kw)
    assert torch.equal(y, y_ref) and all(torch.equal(a, b) for a, b in zip(st, st_ref))


def test_patch_render_on_card_matches_cpu(cuda):
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import patch_workload
    from pygmu2_tpu_torch.ops import adsr, comb, ladder

    counters = (ladder.ladder_scan, comb.comb_scan, adsr.adsr_scan)
    before = [fn.launches for fn in counters]
    on_card = pg.render_to_array(patch_workload.build_patch(pg, 0.1), block=2048, device=cuda)
    assert all(fn.launches > b for fn, b in zip(counters, before))
    on_cpu = pg.render_to_array(patch_workload.build_patch(pg, 0.1), block=2048, device="cpu")
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-4)


# ---- the effects-chain slice: four serial kernels and the chain ----


def _rectified(device, seed, T, C):
    (x,) = _seeded(device, seed, (T, C))
    return x.abs()


def test_ks_kernel_matches_plain(cuda):
    from pygmu2_tpu_torch.ops import ks

    T = 2048
    for L in (7, 535):
        (rho,) = _seeded(cuda, L, (T,), lo=0.99, hi=0.9999)
        (buf,) = _seeded(cuda, L + 1, (L,))
        act = torch.arange(T, device=cuda) >= 100
        state = (torch.tensor(3, dtype=torch.int32, device=cuda),
                 torch.tensor(0.1, device=cuda), torch.tensor(-0.2, device=cuda))
        kw = dict(L=L, allpass_c=0.35)
        before = ks.ks_scan.launches
        got = ks.ks_scan(rho, act, buf, *state, **kw)
        torch.cuda.synchronize()
        assert ks.ks_scan.launches == before + 1
        ref = ks.ks_scan_ref(rho, act, buf, *state, **kw)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    # a string too long for shared memory runs from global memory, bit for bit
    L = ks.MAX_KERNEL_L + 1
    (buf,) = _seeded(cuda, 5, (L,))
    got = ks.ks_scan(rho, act, buf, *state, L=L, allpass_c=0.35)
    for g, r in zip(got, ks.ks_scan_ref(rho, act, buf, *state, L=L, allpass_c=0.35)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("C", [1, 33, 128])
def test_envelope_kernel_matches_plain(cuda, C):
    """Bit for bit, T not a multiple of 8, with two-call hand-offs (one cut
    leaves the second call's x unaligned: C = 1 then takes the staged path)."""
    from pygmu2_tpu_torch.ops import envelope

    T = 2045
    x = _rectified(cuda, C, T, C)
    x[T // 3:T // 2] *= 1e-3  # a quiet stretch: the release coefficient
    env0 = torch.full((C,), 0.1, device=cuda)
    kw = dict(atk=1 - np.exp(-1 / 220.5), rel=1 - np.exp(-1 / 3528.0))
    before = envelope.envelope_ar_scan.launches
    got = envelope.envelope_ar_scan(x, env0, **kw)
    torch.cuda.synchronize()
    assert envelope.envelope_ar_scan.launches == before + 1
    want = envelope.envelope_ar_scan_ref(x, env0, **kw)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    for cut in (T // 3, 1024):
        first = envelope.envelope_ar_scan(x[:cut], env0, **kw)
        second = envelope.envelope_ar_scan(x[cut:], first[1], **kw)
        torch.testing.assert_close(torch.cat([first[0], second[0]]), want[0], rtol=0, atol=0)
        torch.testing.assert_close(second[1], want[1], rtol=0, atol=0)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "exponential"])
def test_slew_kernel_matches_plain(cuda, linear):
    from pygmu2_tpu_torch.ops import slew

    (x,) = _seeded(cuda, 3, (2048,), lo=0.0, hi=3000.0)
    kw = dict(linear=linear, p_rise=40000 / 44100 if linear else 0.05,
              p_fall=8000 / 44100 if linear else 0.002)
    cur = torch.tensor(300.0, device=cuda)
    before = slew.slew_scan.launches
    got = slew.slew_scan(x, cur, **kw)
    torch.cuda.synchronize()
    assert slew.slew_scan.launches == before + 1
    for g, r in zip(got, slew.slew_scan_ref(x, cur, **kw)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "exponential"])
@pytest.mark.parametrize("T", [1, 5, 4096 + 3])
def test_slew_kernel_odd_lengths_and_handoff(cuda, linear, T):
    """T = 1 and 5 (one part stage), 4099 (a part last stage); two calls
    with the value handed on, the second's x not 16-byte aligned. Bit for
    bit."""
    from pygmu2_tpu_torch.ops import slew

    (x,) = _seeded(cuda, T, (T,), lo=0.0, hi=3000.0)
    kw = dict(linear=linear, p_rise=40000 / 44100 if linear else 0.05,
              p_fall=8000 / 44100 if linear else 0.002)
    cur = torch.tensor(300.0, device=cuda)
    want = slew.slew_scan_ref(x, cur, **kw)
    for g, r in zip(slew.slew_scan(x, cur, **kw), want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    if T > 1:
        cut = max(1, T // 3)
        first = slew.slew_scan(x[:cut], cur, **kw)
        second = slew.slew_scan(x[cut:], first[1], **kw)
        torch.testing.assert_close(torch.cat([first[0], second[0]]), want[0], rtol=0, atol=0)
        torch.testing.assert_close(second[1], want[1], rtol=0, atol=0)


@pytest.mark.parametrize("C", [1, 128])
def test_reverse_echo_kernel_matches_plain(cuda, C):
    from pygmu2_tpu_torch.ops import reverse_echo

    T, cap, plen = 2048, 22050, 735
    (x,) = _seeded(cuda, C, (T, C))
    cols = [torch.full((T,), v, device=cuda) for v in (0.01, 1.5, 0.6, 1.0)]
    rings = [torch.zeros((cap, C), device=cuda), torch.zeros((cap, C), device=cuda),
             torch.zeros((plen, C), device=cuda)]
    misc = torch.tensor([1, 0, 0, 0, 0, 441, 441, 0, 1], dtype=torch.float32, device=cuda)
    kw = dict(sr=44100.0, plen=plen, cap=cap, min_block=64, max_block=cap - 1,
              smooth_alpha=1 / 2400)
    # the plain version first: the kernel consumes the block buffers
    ref = reverse_echo.reverse_echo_scan_ref(x, *cols, *rings, misc, **kw)
    before = reverse_echo.reverse_echo_scan.launches
    got = reverse_echo.reverse_echo_scan(x, *cols, *rings, misc, **kw)
    torch.cuda.synchronize()
    assert reverse_echo.reverse_echo_scan.launches == before + 1
    assert got[1] is rings[0] and got[2] is rings[1]  # updated in place
    assert ref[0].abs().max() > 1e-3
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


def test_chain_on_card_launches_kernels_and_matches_cpu(cuda, monkeypatch):
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import fx_workload
    from pygmu2_tpu_torch.ops import envelope, ks, reverse_echo, slew

    mods = {ks: "ks_scan", envelope: "envelope_ar_scan", slew: "slew_scan",
            reverse_echo: "reverse_echo_scan"}
    plain_on_card = []
    for mod, name in mods.items():  # a plain version must never see a card tensor
        ref = getattr(mod, name + "_ref")

        def guarded(*args, _ref=ref, _name=name, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                plain_on_card.append(_name)
            return _ref(*args, **kw)

        monkeypatch.setattr(mod, name + "_ref", guarded)
    before = {name: getattr(mod, name).launches for mod, name in mods.items()}
    on_card = pg.render_to_array(fx_workload.build_chain(pg, 0.1), block=2048, device=cuda)
    assert all(getattr(mod, name).launches > before[name] for mod, name in mods.items())
    assert not plain_on_card
    on_cpu = pg.render_to_array(fx_workload.build_chain(pg, 0.1), block=2048, device="cpu")
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shared", [False, True], ids=["full_planes", "shared_planes"])
@pytest.mark.parametrize("chunk", [128, 1024])
def test_affine_scan_2_kernel_matches_plain(cuda, shared, chunk):
    from pygmu2_tpu_torch.ops import linrec_kernel as lk

    T, C = 16384 + 37, 128
    mats = _seeded(cuda, 31, *[(T, 1 if shared else C)] * 4, lo=-0.7, hi=0.7)
    planes = [m.expand(T, C) for m in mats] + _seeded(cuda, 32, (T, C), (T, C))
    s0 = tuple(_seeded(cuda, 33, (C,), (C,)))
    before = lk.affine_scan_2_kernel.launches
    got = lk.affine_scan_2_kernel(*planes, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert lk.affine_scan_2_kernel.launches == before + 1
    for g, r in zip(got, lk.affine_scan_2_chunked_ref(*planes, s0, chunk=chunk)):
        assert torch.isfinite(g).all() and torch.equal(g, r)  # bit for bit


def test_filter_gain_mix_kernel_matches_plain(cuda):
    from pygmu2_tpu_torch.soundfont import MidiFile

    synth, _ = bench_workload.build_workload(True)
    midi = MidiFile(bench_workload.build_high_midi_bytes(SECONDS))
    par, ch, _snap, _nb = synth.build_schedule(midi, SECONDS)
    assert off._out_of_window(synth, par, ch)
    rows, wave, _n = bench_workload.audio_pass_rows(synth, midi, SECONDS, cuda)
    xt = fk._oscillator(rows, wave, synth.block_size)
    before = fk.filter_gain_mix.launches
    got = fk.filter_gain_mix(xt, rows, synth.block_size)
    torch.cuda.synchronize()
    assert fk.filter_gain_mix.launches == before + 1
    ref = fk.filter_gain_mix_ref(xt, rows, synth.block_size)
    peak = ref.abs().max().item()
    assert peak > 0.05
    assert (got - ref).abs().max().item() <= 2e-5 * max(1.0, peak)


def test_filter_bank_on_card_launches_kernel_and_matches_cpu(cuda):
    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch import filter_workload
    from pygmu2_tpu_torch.ops import linrec_kernel as lk

    before = lk.affine_scan_2_kernel.launches
    on_card = pg.render_to_array(filter_workload.build_filter_bank(pg, 0.2), block=4096,
                                 device=cuda)
    assert lk.affine_scan_2_kernel.launches == before + 2 * 3  # 3 blocks, two filters
    on_cpu = pg.render_to_array(filter_workload.build_filter_bank(pg, 0.2), block=4096,
                                device="cpu")
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-4)


def _scan_planes(device, T, C, shared, seed):
    """Stable 2x2 maps (the four matrix planes one column for every channel
    where ``shared``, the SVFilterPE layout), inputs, a state."""
    mats = _seeded(device, seed, *[(T, 1 if shared else C)] * 4, lo=-0.7, hi=0.7)
    planes = [m.expand(T, C) for m in mats] + _seeded(device, seed + 1, (T, C), (T, C))
    return planes, tuple(_seeded(device, seed + 2, (C,), (C,)))


@pytest.mark.parametrize("with_s0", [False, True], ids=["zero_state", "s0"])
@pytest.mark.parametrize("shared", [False, True], ids=["full_planes", "shared_planes"])
@pytest.mark.parametrize("chunk", [128, 1024])
@pytest.mark.parametrize("C", [4, 5, 33, 128])
@pytest.mark.parametrize("T", [1, 1023, 1025, 4099, 16384])
def test_affine_scan_2_kernel_shapes_bit_for_bit(cuda, T, C, chunk, shared, with_s0):
    """Odd lengths (one row, a part chunk, one row past a chunk) and widths
    (a part tile of channels, widths not a multiple of 4: the kernel's
    scalar loads), both chunk sizes, both matrix layouts, with and without
    an initial state: bit for bit against the plain version."""
    from pygmu2_tpu_torch.ops import linrec_kernel as lk

    planes, s0 = _scan_planes(cuda, T, C, shared, seed=T + C + chunk)
    s0 = s0 if with_s0 else None
    got = lk.affine_scan_2_kernel(*planes, s0, chunk=chunk)
    torch.cuda.synchronize()
    for g, r in zip(got, lk.affine_scan_2_chunked_ref(*planes, s0, chunk=chunk)):
        assert torch.isfinite(g).all() and torch.equal(g, r)


@pytest.mark.parametrize("shared", [False, True], ids=["full_planes", "shared_planes"])
@pytest.mark.parametrize("chunk", [128, 1024])
def test_affine_scan_2_kernel_handoff_and_two_calls(cuda, shared, chunk):
    """Two calls handing the state on through ``s0`` equal the plain
    version's two calls bit for bit, and two identical calls give the same
    bits (the chunks' carry has a fixed order: no atomics)."""
    from pygmu2_tpu_torch.ops import linrec_kernel as lk

    T, C = 4099, 33
    planes, s0 = _scan_planes(cuda, T, C, shared, seed=chunk + shared)
    cut = 1500
    first = lk.affine_scan_2_kernel(*(p[:cut] for p in planes), s0, chunk=chunk)
    second = lk.affine_scan_2_kernel(*(p[cut:] for p in planes),
                                     (first[0][-1], first[1][-1]), chunk=chunk)
    r1 = lk.affine_scan_2_chunked_ref(*(p[:cut] for p in planes), s0, chunk=chunk)
    r2 = lk.affine_scan_2_chunked_ref(*(p[cut:] for p in planes), (r1[0][-1], r1[1][-1]),
                                      chunk=chunk)
    for g, r in zip((*first, *second), (*r1, *r2)):
        assert torch.equal(g, r)
    again = lk.affine_scan_2_kernel(*planes, s0, chunk=chunk)
    once = lk.affine_scan_2_kernel(*planes, s0, chunk=chunk)
    for a, b in zip(again, once):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P", [1, 33, 128, 256])
def test_filter_gain_mix_kernel_voices_and_epochs(cuda, P):
    """The unfused pass at 1, 33 (a part block of voices, not a multiple of
    4: the copy's scalar loads), 128 and 256 voices, fresh epochs at block 0
    and mid-score, on the oscillator of seeded rows: within 2e-5 * max(1,
    peak) of the plain version, 1e-5 * max(1, peak) of its own order in
    torch ops (the same cut, other roundings: fused multiply-adds), and two
    calls bit for bit."""
    B, N = 6, 1024
    rows, wave, _state = _synthetic(cuda, B, P, (2, 5), seed=P)
    xt = fk._oscillator(rows, wave, N)  # the unfused route's input
    before = fk.filter_gain_mix.launches
    got = fk.filter_gain_mix(xt, rows, N)
    again = fk.filter_gain_mix(xt, rows, N)
    torch.cuda.synchronize()
    assert fk.filter_gain_mix.launches == before + 2
    assert torch.equal(got, again)
    ref = fk.filter_gain_mix_ref(xt, rows, N)
    cut = fk.filter_gain_mix_cut(xt, rows, N)
    scale = max(1.0, float(ref.abs().max()))
    assert float(ref.abs().max()) > 0.5 and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-5 * scale)
    torch.testing.assert_close(got, cut, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("L", [16, 133, 535, 51201])
def test_ks_blocked_kernel_matches_plain(cuda, L):
    """The all-active order (the JAX KarplusStrongPE's ks_blocked) bit for
    bit, T not a multiple of the block, and a two-call hand-off against two
    calls of the plain version; 51201 (past ``MAX_KERNEL_L``) runs from
    global memory."""
    from pygmu2_tpu_torch.ops import ks

    T = 2045
    (rho,) = _seeded(cuda, L, (T,), lo=0.99, hi=0.9999)
    (buf,) = _seeded(cuda, L + 1, (L,))
    act = torch.ones(T, dtype=torch.bool, device=cuda)
    state = (torch.tensor(3, dtype=torch.int32, device=cuda),
             torch.tensor(0.1, device=cuda), torch.tensor(-0.2, device=cuda))
    kw = dict(L=L, allpass_c=0.35, all_active=True)
    before = ks.ks_scan.launches
    got = ks.ks_scan(rho, act, buf, *state, **kw)
    torch.cuda.synchronize()
    assert ks.ks_scan.launches == before + 1
    ref = ks.ks_blocked_ref(rho, buf, *state, L=L, allpass_c=0.35)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    # blocks start at each call's first sample (as in the JAX package), so
    # two calls are held to two calls of the plain version
    cut = 700
    first = ks.ks_scan(rho[:cut], act[:cut], buf, *state, **kw)
    second = ks.ks_scan(rho[cut:], act[cut:], *first[1:], **kw)
    ref1 = ks.ks_blocked_ref(rho[:cut], buf, *state, L=L, allpass_c=0.35)
    ref2 = ks.ks_blocked_ref(rho[cut:], *ref1[1:], L=L, allpass_c=0.35)
    torch.testing.assert_close(torch.cat([first[0], second[0]]),
                               torch.cat([ref1[0], ref2[0]]), rtol=0, atol=0)
    for g, r in zip(second[1:], ref2[1:]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.fixture
def plain_scan(monkeypatch):
    """A context in which the streaming engine takes the scan's plain
    version on the card."""
    import contextlib

    from pygmu2_tpu_torch.ops import linrec_kernel
    from pygmu2_tpu_torch.soundfont import synthesizer

    @contextlib.contextmanager
    def ctx():
        with monkeypatch.context() as m:
            m.setattr(synthesizer, "affine_scan_2_kernel",
                      linrec_kernel.affine_scan_2_chunked_ref)
            yield

    return ctx


def test_block_engine_scan_once_a_block(cuda, plain_scan):
    """render_midi_schedule launches the scan kernel once a block and
    matches the same render through the scan's plain version on the card."""
    from pygmu2_tpu_torch.ops import linrec_kernel

    seconds = 0.2
    synth, midi = bench_workload.build_workload(False, device=cuda)
    n_blocks = int(np.ceil(seconds * 44100 / synth.block_size))
    before = linrec_kernel.affine_scan_2_kernel.launches
    got = synth.render_midi_schedule(midi, seconds)
    assert linrec_kernel.affine_scan_2_kernel.launches == before + n_blocks
    with plain_scan():
        ref = synth.render_midi_schedule(midi, seconds)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_sequencer_matches_plain_on_card(cuda, plain_scan):
    """MidiFileSequencer.render in uneven counts on the card against the
    same render through the scan's plain version."""
    from pygmu2_tpu_torch.soundfont import MidiFileSequencer

    def render():
        synth, midi = bench_workload.build_workload(False, device=cuda)
        seq = MidiFileSequencer(synth)
        seq.play(midi)
        left, right = np.zeros(8192, np.float32), np.zeros(8192, np.float32)
        at = 0
        for n in (1000, 4096, 3096):
            seq.render(left, right, at, n)
            at += n
        return np.stack([left, right], axis=1)

    got = render()
    with plain_scan():
        ref = render()
    assert np.isfinite(got).all() and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# ---- the backward kernels (the training path) ----


def _bwd_close(got, want, what, tol=1e-4):
    """Each cotangent within ``tol`` of the largest of its plain version's
    (autograd of the plain version, or the plain adjoint; the kernels sum
    in other orders)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol * scale, f"{what}: output {i} off by {err} (largest {scale})"


@pytest.mark.parametrize("os_n,mode,C", [(2, 0, 1), (2, 2, 33), (1, 4, 33), (3, 5, 1),
                                          (4, 3, 33)])
def test_ladder_backward_kernel_matches_plain(cuda, os_n, mode, C):
    """os_n 1, 2 and 4 their own instantiations, 3 the generic one; C = 33
    a partial block; quiet samples take the decay."""
    from pygmu2_tpu_torch.ops import ladder

    T = 300
    x, al, qa, ki, dsc, st, gy, gs = _seeded(cuda, 40 + os_n, (T, C), (T,), (T,), (T,),
                                             (T,), (9, C), (T, C), (9, C))
    x = x * 0.3
    x[20:24] = 1e-7
    al, qa, ki, dsc = al.abs() * 0.5 + 0.05, qa * 0.1 + 1.0, ki.abs() * 3.0, dsc + 1.5
    kw = dict(os_n=os_n, pbg=0.3, mode_index=mode, input_threshold=1e-5, state_decay=0.95)
    ckpt = ladder._launch(x, al, qa, ki, dsc, st * 0.1, **kw, checkpoints=True)[2]
    before = ladder.ladder_scan_bwd.launches
    got = ladder.ladder_scan_bwd(x, al, qa, ki, dsc, st * 0.1, gy, gs, ckpt, **kw)
    torch.cuda.synchronize()
    assert ladder.ladder_scan_bwd.launches == before + 1
    _bwd_close(got, ladder.ladder_scan_bwd_ref(x, al, qa, ki, dsc, st * 0.1, gy, gs, **kw),
               f"ladder os_n={os_n} mode={mode} C={C}")


def _ladder_bwd_case(device, T, C, os_n, mode, seed):
    x, al, qa, ki, dsc, st, gy, gs = _seeded(device, seed, (T, C), (T,), (T,), (T,), (T,),
                                             (9, C), (T, C), (9, C))
    x = x * 0.3
    x[T // 3:T // 3 + 4] = 1e-7
    cols = (al.abs() * 0.5 + 0.05, qa * 0.1 + 1.0, ki.abs() * 3.0, dsc + 1.5)
    kw = dict(os_n=os_n, pbg=0.3, mode_index=mode, input_threshold=1e-5, state_decay=0.95)
    return (x, *cols, st * 0.1), gy, gs, kw


@pytest.mark.parametrize("T,C,os_n,mode", [(1024, 1, 2, 0), (16384, 1, 2, 0), (1000, 33, 2, 2),
                                           (70, 3, 3, 5), (20, 1, 1, 4), (333, 33, 4, 3)])
def test_ladder_backward_kernel_equals_chunked_order(cuda, T, C, os_n, mode):
    """The kernel against its order in torch ops (ops/ladder
    .ladder_scan_bwd_chunked, on the card: torch's tanh is tanhf) bit for
    bit: T a multiple of the checkpoint interval and not, below it, the
    fit patch's T = 16384; os_n 1, 2, 4 and 3; C = 33 a partial group of
    chunks. Two launches give the same bits; the forward's y and state are
    the same bits with and without checkpoints, and the checkpoints are the
    plain forward's entering states."""
    from pygmu2_tpu_torch.ops import ladder

    args, gy, gs, kw = _ladder_bwd_case(cuda, T, C, os_n, mode, T + C)
    y0, s0 = ladder.ladder_scan(*args, **kw)
    y1, s1, ckpt = ladder._launch(*args, **kw, checkpoints=True)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    if T <= 1024:
        assert torch.equal(ckpt, ladder.ladder_checkpoints_ref(*args, **kw))
    got = ladder.ladder_scan_bwd(*args, gy, gs, ckpt, **kw)
    again = ladder.ladder_scan_bwd(*args, gy, gs, ckpt, **kw)
    want = ladder.ladder_scan_bwd_chunked(*args, gy, gs, ckpt, **kw)
    torch.cuda.synchronize()
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a), f"output {i}: two launches differ"
        assert torch.equal(g, w), f"output {i} off by {float((g - w).abs().max())}"


@pytest.mark.parametrize("T,C,os_n,layout", [
    (1024, 1, 99, None), (1024, 4, 100, None), (1024, 1, 128, None), (256, 4, 320, None),
    (256, 4, 320, (1, True, False)), (96, 3, 320, (1, True, True)),
    (200, 33, 100, (3, True, False)), (70, 2, 7, (1, False, False))])
def test_ladder_backward_past_shared_memory_equals_chunked_order(cuda, T, C, os_n, layout):
    """Past os_n = 99 a chunk's steps do not fit three to a CUDA block:
    one chunk a block keeps them to os_n = 301, then each sample's steps
    are re-walked from its entering state, in shared memory or (forced
    here, past ~9600 by default) in device memory. Every layout bit for bit
    with ``ladder_scan_bwd_chunked``, two launches the same bits."""
    from pygmu2_tpu_torch.ops import ladder

    args, gy, gs, kw = _ladder_bwd_case(cuda, T, C, os_n, os_n % 6, T + os_n)
    ckpt = ladder._launch(*args, **kw, checkpoints=True)[2]
    before = ladder.ladder_scan_bwd.launches
    got = (ladder.ladder_scan_bwd(*args, gy, gs, ckpt, **kw) if layout is None
           else ladder._launch_bwd(*args[:5], ckpt, gy, gs, **kw, layout=layout))
    again = ladder._launch_bwd(*args[:5], ckpt, gy, gs, **kw, layout=layout)
    want = ladder.ladder_scan_bwd_chunked(*args, gy, gs, ckpt, **kw)
    torch.cuda.synchronize()
    assert ladder.ladder_scan_bwd.launches == before + 2
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a), f"output {i}: two launches differ"
        assert torch.equal(g, w), f"output {i} off by {float((g - w).abs().max())}"


@pytest.mark.parametrize("T,C,freq,sf", [(300, 23, 220.0, -1.0), (300, 1, "sweep", 230.0),
                                         (40, 23, "sweep", 230.0), (300, 23, 8000.0, 8000.0)])
def test_comb_backward_kernel_matches_plain(cuda, T, C, freq, sf):
    """A ring longer and shorter than the call, a sweep, delay 1 (8 kHz at
    an 8 kHz rate), a smoothed frequency handed in, C = 23."""
    from pygmu2_tpu_torch.ops import comb

    L, sr = 97, 8000.0
    x, fb, buf, gy, gb = _seeded(cuda, T + C, (T, C), (T,), (L, C), (T, C), (L, C))
    if freq == "sweep":
        (f,) = _seeded(cuda, 3, (T,), lo=200.0, hi=400.0)
    else:
        f = torch.full((T,), freq, device=cuda)
    pos = torch.tensor(11, dtype=torch.int32, device=cuda)
    sf = torch.tensor(sf, device=cuda)
    kw = dict(L=L, sr=sr, smooth_alpha=0.1)
    out = comb._launch(x, f, fb * 0.9, buf, pos, sf, **kw)  # the recorded launch
    y, residuals = out[0], out[4:]
    gsf = torch.tensor(0.7, device=cuda)
    args = (x, f, fb * 0.9, buf, pos, sf, y, gy, gb, gsf)
    got = comb.comb_scan_bwd(*args, residuals, **kw)
    torch.cuda.synchronize()
    _bwd_close(got, comb.comb_scan_bwd_ref(*args, **kw), f"comb T={T} C={C} freq={freq}")


@pytest.mark.parametrize("T,C,L,delays", [
    (16384, 1, 2206, "sweep"), (16384, 128, 2206, "sweep"), (1024, 1, 2206, "sweep"),
    (300, 23, 97, 37), (40, 2, 97, 1), (400, 9, 97, "step"), (400, 3, 97, "jump"),
    (60, 3, 97, 50), (3000, 2, 40000, "sweep")])
def test_comb_backward_kernel_equals_window_order(cuda, T, C, L, delays):
    """The kernel against its order in torch ops (ops/comb
    .comb_scan_bwd_windows) bit for bit: the fit patch's 200-240 Hz sweep
    at T = 16384 (C = 1 and 128: the channel tiling), the probe's T =
    1024, a constant delay, delay 1 (one-sample windows), a delay stepping
    up by one (runs of two samples reading one row) and jumping up by
    four (the serial fallback), reads into the ring handed in with the
    position wrapping, a ring past the shared memory (L = 40000, in device
    memory). Two launches give the same bits."""
    from pygmu2_tpu_torch.ops import comb

    sr = 44100.0
    x, fb, buf, gy, gb = _seeded(cuda, T + C, (T, C), (T,), (L, C), (T, C), (L, C))
    t = torch.arange(T, device=cuda)
    if delays == "sweep":
        freq, alpha = 200.0 + 40.0 * t / T, 1 / 2400
    else:
        d = {"step": torch.where(t < 150, 20, 21), "jump": torch.where(t < 150, 20, 24)}.get(
            delays, torch.full((T,), delays if isinstance(delays, int) else 1, device=cuda))
        freq, alpha = sr / d.float(), 1.0
    pos = torch.tensor(L - 3, dtype=torch.int32, device=cuda)
    sf = torch.tensor(-1.0, device=cuda)
    kw = dict(L=L, sr=sr, smooth_alpha=alpha)
    out = comb._launch(x, freq.float(), fb * 0.9, buf, pos, sf, **kw)  # the recorded launch
    y, res = out[0], out[4:]
    args = (x, freq.float(), fb * 0.9, buf, pos, sf, y, gy, gb, torch.tensor(0.7, device=cuda))
    got = comb.comb_scan_bwd(*args, res, **kw)
    again = comb.comb_scan_bwd(*args, res, **kw)
    want = comb.comb_scan_bwd_windows(*args, **kw)
    torch.cuda.synchronize()
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a), f"output {i}: two launches differ"
        assert torch.equal(g, w), f"output {i} off by {float((g - w).abs().max())}"


@pytest.mark.parametrize("shared,C", [(True, 128), (False, 4), (True, 5)])
def test_affine_scan_backward_launch_matches_plain(cuda, shared, C):
    """The adjoint scan's launch on the reversed planes (the matrices
    shared or not), then gu, gA, gs0: against autograd of the plain
    chunked scan; T not a multiple of the chunk."""
    from pygmu2_tpu_torch.ops import linrec_kernel

    T = 4096 + 5
    w = 1 if shared else C
    a11, a12, a21, a22 = _seeded(cuda, C, (T, w), (T, w), (T, w), (T, w))
    a = [a11 * 0.1 + 0.88, a12 * 0.1, a21 * 0.1, a22 * 0.1 + 0.88]
    a = [m.expand(T, C) for m in a]
    u1, u2, g1, g2 = _seeded(cuda, C + 1, (T, C), (T, C), (T, C), (T, C))
    s01, s02 = _seeded(cuda, C + 2, (C,), (C,))
    s1, s2 = linrec_kernel.affine_scan_2_kernel(*a, u1, u2, (s01, s02), chunk=1024)
    before = linrec_kernel.affine_scan_2_bwd.launches
    args = (*a, u1, u2, s01, s02, s1, s2, g1, g2)
    got = linrec_kernel.affine_scan_2_bwd(*args, chunk=1024)
    torch.cuda.synchronize()
    assert linrec_kernel.affine_scan_2_bwd.launches == before + 1
    _bwd_close(got, linrec_kernel.affine_scan_2_bwd_ref(*args, chunk=1024),
               f"scan shared={shared} C={C}")


@pytest.mark.parametrize("T,C,planes,with_s0,chunk", [
    (16384, 128, "columns", True, 1024), (4096 + 3, 128, "columns", False, 1024),
    (1025, 1, "columns", True, 128), (777, 5, "full", True, 128),
    (4096 + 5, 4, "a12_column", True, 1024), (300, 33, "full", False, 128),
    (4099, 12, "expanded", True, 1024)])
def test_affine_scan_backward_kernel_equals_plain_order(cuda, T, C, planes, with_s0, chunk):
    """The scan's adjoint launch bit for bit with its plain version's
    order on the card (``affine_scan_2_bwd_plain``): the fit bank's shape,
    T past a chunk, C = 1, 4, 5, 12, 33 and 128; the matrix planes (T, 1)
    columns (their cotangents the declared channel sums), full, one column
    of four, or columns expanded along the channels (read once a row, their
    cotangents full); with and without s0. A second launch gives the same
    bits; the launch counter moves by one a call."""
    from pygmu2_tpu_torch.ops import linrec_kernel as lk

    w = C if planes == "full" else 1
    a = _seeded(cuda, T + C, (T, w), (T, w), (T, w), (T, w))
    a = [a[0] * 0.1 + 0.88, a[1] * 0.1, a[2] * 0.1, a[3] * 0.1 + 0.88]
    if planes == "expanded":
        a = [m.expand(T, C) for m in a]
    elif planes == "a12_column":
        a = [m if i == 1 else m.expand(T, C).contiguous() for i, m in enumerate(a)]
    u1, u2, g1, g2 = _seeded(cuda, T + C + 1, (T, C), (T, C), (T, C), (T, C))
    s0 = tuple(_seeded(cuda, T + C + 2, (C,), (C,))) if with_s0 else (None, None)
    s1, s2 = lk.affine_scan_2_kernel(*a, u1, u2, s0 if with_s0 else None, chunk=chunk)
    args = (*a, u1, u2, *s0, s1, s2, g1, g2)
    before = lk.affine_scan_2_bwd.launches
    got = lk.affine_scan_2_bwd(*args, chunk=chunk)
    again = lk.affine_scan_2_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert lk.affine_scan_2_bwd.launches == before + 2
    want = lk.affine_scan_2_bwd_plain(*args, chunk=chunk)
    for i, (g, r, w2) in enumerate(zip(got, again, want)):
        if w2 is None:
            assert g is None and r is None
            continue
        assert g.shape == w2.shape, f"output {i}: {tuple(g.shape)} vs {tuple(w2.shape)}"
        assert torch.equal(g, r), f"output {i}: two launches differ"
        assert torch.equal(g, w2), f"output {i} off by {float((g - w2).abs().max())}"


@pytest.mark.parametrize("T,C", [(16384, 1), (16384, 128), (16385, 128), (1001, 1), (5, 2),
                                  (300, 3), (777, 33), (4097, 64)])
def test_envelope_backward_kernel_equals_grid_order(cuda, T, C):
    """The follower's adjoint launch (csrc/order1_grid.cuh) bit for bit
    with its order in torch ops on the card
    (``envelope_ar_scan_bwd_chunked``): the fits' shapes (C = 1 and 128 at
    T = 16384), T not a multiple of the 256-sample chunk, tile widths 1, 2,
    4, 32 and a part tile; ties x == env_{t-1} on some rows. A second launch
    gives the same bits; the launch counter moves by one a call."""
    from pygmu2_tpu_torch.ops import envelope

    x, e0, g, gf = _seeded(cuda, 7 * T + C, (T, C), (C,), (T, C), (C,))
    x, e0 = x.abs(), e0.abs()
    kw = dict(atk=0.05, rel=0.002)
    env, _ = envelope.envelope_ar_scan(x, e0, **kw)
    for t in (t for t in (1, 255, 256, 3000) if t < T):  # x equal to the envelope before it
        x[t] = env[t - 1]
        env, _ = envelope.envelope_ar_scan(x, e0, **kw)
    before = envelope.envelope_ar_scan_bwd.launches
    got = envelope.envelope_ar_scan_bwd(x, e0, env, g, gf, **kw)
    again = envelope.envelope_ar_scan_bwd(x, e0, env, g, gf, **kw)
    torch.cuda.synchronize()
    assert envelope.envelope_ar_scan_bwd.launches == before + 2
    want = envelope.envelope_ar_scan_bwd_chunked(x, e0, env, g, gf, **kw)
    for i, (o, r, w) in enumerate(zip(got, again, want)):
        assert torch.equal(o, r), f"output {i}: two launches differ"
        assert torch.equal(o, w), f"output {i} off by {float((o - w).abs().max())}"


def test_probe_gradient_on_card_matches_cpu(cuda):
    """bench.py's gradient probe at 1024 samples: the card's gradients
    (forward and backward kernels, 4 launches each a render) against the
    CPU's (plain versions), and a render with no gradient launching no
    backward kernel and leaving no graph."""
    import pygmu2_tpu_torch as pt
    from pygmu2_tpu_torch import fit_workload
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.ops import comb, ladder

    graph = fit_workload.build_probe(pt, 1024)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        theta = {k: torch.tensor(v, device=dev, requires_grad=True)
                 for k, v in (("cutoff", 1500.0), ("fb", 0.6))}
        before = (ladder.ladder_scan_bwd.launches, comb.comb_scan_bwd.launches)
        out = engine.render_functional(graph, 0, 1024, 256, theta, device=dev)
        grads[dev.type] = torch.autograd.grad((out ** 2).mean(), list(theta.values()))
        after = (ladder.ladder_scan_bwd.launches, comb.comb_scan_bwd.launches)
        if dev.type == "cuda":
            assert after == (before[0] + 4, before[1] + 4)
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert abs(float(g) - float(w)) <= 1e-3 * abs(float(w))
    before = (ladder.ladder_scan.launches, ladder.ladder_scan_bwd.launches)
    out = engine.render_functional(graph, 0, 1024, 256, {"cutoff": 1500.0, "fb": 0.6},
                                   device=cuda)
    assert out.grad_fn is None
    assert (ladder.ladder_scan.launches, ladder.ladder_scan_bwd.launches) == (before[0] + 4,
                                                                              before[1])


@pytest.mark.parametrize("kernel", ["ks", "ks_blocked"])
def test_backward_without_kernel_raises_on_card(cuda, kernel):
    """A launch given no backward kernel (here the string's two launches,
    wrapped without theirs) raises NotImplementedError when a gradient is
    asked for; no plain version runs as a backward."""
    from pygmu2_tpu_torch.ops import diffable, ks

    T, L = 256, 40
    (x,) = _seeded(cuda, 5, (T, 2))
    x = x.abs().requires_grad_()
    (buf,) = _seeded(cuda, 6, (L,))
    rho = torch.full((T,), 0.99, device=cuda) * x[:, 0]
    state = (torch.tensor(0, dtype=torch.int32, device=cuda), torch.zeros((), device=cuda),
             torch.zeros((), device=cuda))
    if kernel == "ks":
        fn = diffable.kernel_function("ks_scan", ks._launch)
        out = fn(rho, torch.ones(T, dtype=torch.bool, device=cuda), buf, *state, L=L,
                 allpass_c=0.3)[0]
    else:
        fn = diffable.kernel_function("ks_scan (blocked)", ks._launch_blocked)
        out = fn(rho, buf, *state, L=L, allpass_c=0.3)[0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.sum().backward()


# ---- the string's backward kernel: against its plain adjoint ----

@pytest.mark.parametrize("L,T,head,blocked", [(2, 700, 3, False), (3, 1001, 10, False),
                                              (9, 4097, 0, False), (83, 4096, 100, False),
                                              (535, 4096, 0, True), (133, 16384, 0, True),
                                              (51201, 2048, 10, False),
                                              (51201, 2048, 0, True)])
def test_string_backward_kernel_matches_plain(cuda, L, T, head, blocked):
    """ks_scan's gradient on the card (rho, the string, the allpass state)
    is a launch of csrc/ks_scan_bwd.cu, in either order, within 1e-5 of the
    plain adjoint (measured bit for bit); a string past MAX_KERNEL_L keeps
    its tape's cotangent in global memory."""
    from pygmu2_tpu_torch.ops import ks

    rho, buf, ai, ao = _seeded(cuda, L + T, (T,), (L,), (), (), lo=-1.0, hi=1.0)
    rho = 0.97 + 0.029 * rho.abs()
    act = torch.arange(T, device=cuda) >= head
    if not blocked:
        act[T // 3:T // 3 + 40] = False
    r = torch.tensor(L // 3, dtype=torch.int32, device=cuda)
    ins = [t.clone().requires_grad_() for t in (rho, buf, ai, ao)]
    before = ks.ks_scan_bwd.launches
    y, buf2, _, ai2, ao2 = ks.ks_scan(ins[0], act, ins[1], r, ins[2], ins[3], L=L,
                                      allpass_c=0.35, all_active=blocked)
    cts = _seeded(cuda, L + T + 1, (T,), (L,), (), ())
    got = torch.autograd.grad((y, buf2, ai2, ao2), ins, cts)
    torch.cuda.synchronize()
    assert ks.ks_scan_bwd.launches == before + 1
    want = ks.ks_scan_bwd_ref(rho, None if blocked else act, buf, r, y.detach(), *cts, L=L,
                              allpass_c=0.35)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= BWD_TOL * float(w.abs().max()), (g, w)


@pytest.mark.parametrize("L,T,blocked", [(3, 1001, False), (9, 4097, False), (133, 16384, False),
                                         (133, 16384, True), (535, 16384, False),
                                         (535, 16384, True), (51201, 2048, False),
                                         (51201, 2048, True)])
def test_string_backward_kernel_equals_plain_bit_for_bit(cuda, L, T, blocked):
    """The pipelined backward kernel equals ``ks_scan_bwd_ref`` and its
    schedule in torch ops (``ks_scan_bwd_pipelined``) bit for bit, in both
    orders: L = 3 (one thread), 9 (windows of 4), 133 and 535 (2W + 1 = L:
    a window's last tape add and a seed two windows before share a slot)
    at T = 16384, and a string past MAX_KERNEL_L (the ring in device
    memory); a second launch gives the same bits."""
    from pygmu2_tpu_torch.ops import ks

    rho, buf, ai, ao = _seeded(cuda, 5 * L + T, (T,), (L,), (), ())
    rho = 0.97 + 0.029 * rho.abs()
    act = torch.ones(T, dtype=torch.bool, device=cuda)
    if not blocked:
        act[:30] = False
        act[T // 3:T // 3 + 40] = False
    r = torch.tensor(L // 3, dtype=torch.int32, device=cuda)
    all_active = blocked and L >= ks.BLOCKED_MIN_L
    y = ks.ks_scan(rho, act, buf, r, ai, ao, L=L, allpass_c=0.35, all_active=blocked)[0]
    cts = _seeded(cuda, L + T + 2, (T,), (L,), (), ())
    call = (rho, None if all_active else act, buf, r, y, *cts)
    got = ks.ks_scan_bwd(*call, L=L, allpass_c=0.35)
    again = ks.ks_scan_bwd(*call, L=L, allpass_c=0.35)
    want = ks.ks_scan_bwd_ref(*call, L=L, allpass_c=0.35)
    pipelined = ks.ks_scan_bwd_pipelined(*call, L=L, allpass_c=0.35)
    for i, (g, a, w, p_) in enumerate(zip(got, again, want, pipelined)):
        assert torch.equal(g, a), f"output {i}: two launches differ"
        assert torch.equal(g, w), f"output {i}: off the plain adjoint by {(g - w).abs().max()}"
        assert torch.equal(p_, w)


def test_string_fit_gradient_on_card_matches_cpu(cuda):
    """fit_workload's string render, four blocks of 512 (the first per
    sample, the rest blocked): the card's gradients within 1e-3 relative
    of the CPU's (the plain versions under autograd)."""
    from pygmu2_tpu_torch import fit_workload as fw
    from pygmu2_tpu_torch.ops import ks

    L, c = fw.string_shape()
    exc = torch.from_numpy(fw.string_excitation(L, 0))
    n = 4 * 512 - fw.STRING_HEAD

    def grads(device):
        e = exc.to(device).requires_grad_()
        rho = torch.tensor(0.997, device=device, requires_grad=True)
        out = fw.render_string(e, rho, n, 512, allpass_c=c)
        return torch.autograd.grad((out ** 2).mean(), [e, rho])

    before = ks.ks_scan_bwd.launches
    got = grads(cuda)
    assert ks.ks_scan_bwd.launches == before + 4
    for g, w in zip(got, grads("cpu")):
        assert float((g.cpu() - w).abs().max()) <= 1e-3 * float(w.abs().max())


# ---- batched bindings: torch.func.vmap over render_functional on the card ----

@pytest.mark.parametrize("graph", ["probe", "bank"])
def test_vmap_render_on_card_matches_loop(cuda, graph):
    """torch.func.vmap over render_functional on the card equals the loop
    of renders bit for bit: the probe's ladder and comb (batched columns:
    one launch per member) and the 8-channel bank's scan (batched planes:
    folded into 16 channels, one launch). The summed loss's gradient gives
    each candidate's within 1e-5 relative."""
    import pygmu2_tpu_torch as pt
    from pygmu2_tpu_torch import fit_workload as fw
    from pygmu2_tpu_torch import patch_workload
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.ops import comb, ladder, linrec_kernel

    pt.set_sample_rate(44100)
    if graph == "probe":
        g, n, block = fw.build_probe(pt, 2048), 2048, 512
        batch = {"cutoff": [900.0, 2500.0], "fb": [0.3, 0.6]}
        fns, per_block = (ladder.ladder_scan, comb.comb_scan), 2
    else:
        saws = pt.ArrayPE(patch_workload.detuned_saws(8192, 0, channels=8))
        low = pt.BiquadPE(saws, fw._swept_around(pt, pt.ParamPE("low_hz"), 0.25, 1200.0), 4.0,
                          mode=pt.BiquadMode.LOWPASS)
        g, n, block = pt.CropPE(pt.GainPE(low, 0.5), 0, 8192), 8192, 4096
        batch = {"low_hz": [900.0, 1500.0]}
        fns, per_block = (linrec_kernel.affine_scan_2_kernel,), 1
    keys = list(batch)

    def render(b):
        return engine.render_functional(g, 0, n, block, b, device=cuda)

    before = [f.launches for f in fns]
    out = torch.func.vmap(render)({k: torch.tensor(v, device=cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [per_block * (n // block)] * len(fns)
    loop = [render({k: torch.tensor(v[i], device=cuda) for k, v in batch.items()})
            for i in range(2)]
    assert torch.equal(out, torch.stack(loop))
    vals = {k: torch.tensor(v, device=cuda, requires_grad=True) for k, v in batch.items()}
    summed = torch.autograd.grad(
        torch.func.vmap(lambda b: (render(b) ** 2).mean())(vals).sum(), list(vals.values()))
    for i in range(2):
        one = {k: torch.tensor(v[i], device=cuda, requires_grad=True) for k, v in batch.items()}
        want = torch.autograd.grad((render(one) ** 2).mean(), list(one.values()))
        for s_, w in zip(summed, want):
            assert abs(float(s_[i]) - float(w)) <= 1e-5 * abs(float(w))


def test_vmap_fold_keeps_rings_on_card(cuda):
    """The echo vmapped over its input with fresh, unbatched rings: one
    launch on the folded channels, equal to the loop bit for bit, and the
    rings handed in are not written."""
    from pygmu2_tpu_torch.ops import reverse_echo

    T, C, cap, plen = 2048, 2, 400, 133
    kw = dict(sr=8000.0, plen=plen, cap=cap, min_block=64, max_block=cap - 1,
              smooth_alpha=1 / 2400)
    (x,) = _seeded(cuda, 9, (3, T, C))
    col = lambda v: torch.full((T,), v, device=cuda)  # noqa: E731
    misc = torch.zeros(9, device=cuda)
    misc[0], misc[5], misc[6], misc[8] = 1, 160.0, 160.0, 1
    rings = [torch.zeros(cap, C, device=cuda), torch.zeros(cap, C, device=cuda),
             torch.zeros(plen, C, device=cuda)]

    def call(xb):
        return reverse_echo.reverse_echo_scan(xb, col(0.02), col(1.5), col(0.6), col(1.0),
                                              *rings, misc, **kw)

    before = reverse_echo.reverse_echo_scan.launches
    out = torch.func.vmap(call)(x)
    torch.cuda.synchronize()
    assert reverse_echo.reverse_echo_scan.launches == before + 1
    assert all(float(r.abs().max()) == 0.0 for r in rings)
    for i in range(3):
        want = reverse_echo.reverse_echo_scan(x[i], col(0.02), col(1.5), col(0.6), col(1.0),
                                              *(r.clone() for r in rings), misc, **kw)
        for o, w in zip(out, want):
            assert torch.equal(o[i], w)


# ---- the effects chain's backward kernels: against their plain adjoints ----

BWD_TOL = 1e-5  # of the largest plain cotangent of each output


@pytest.mark.parametrize("T,C", [(1001, 1), (4097, 2), (16385, 128), (333, 33)])
def test_envelope_backward_kernel_matches_plain(cuda, T, C):
    """The chunked reverse scan against the plain adjoint's serial walk:
    odd T (a part tile), C = 1, 2, 33 (a part group) and 128, and the state
    handed across a cut: the first part's backward from the second's
    cotangent of its entering envelope equals the whole call's."""
    from pygmu2_tpu_torch.ops import envelope

    x, e0, g, gf = _seeded(cuda, T + C, (T, C), (C,), (T, C), (C,))
    x = x.abs()
    kw = dict(atk=0.05, rel=0.002)
    env, _ = envelope.envelope_ar_scan(x, e0.abs(), **kw)
    before = envelope.envelope_ar_scan_bwd.launches
    got = envelope.envelope_ar_scan_bwd(x, e0.abs(), env, g, gf, **kw)
    torch.cuda.synchronize()
    assert envelope.envelope_ar_scan_bwd.launches == before + 1
    want = envelope.envelope_ar_scan_bwd_ref(x, e0.abs(), env, g, gf, **kw)
    _bwd_close(got, want, f"envelope T={T} C={C}", BWD_TOL)
    cut = T // 3
    gx2, g_mid = envelope.envelope_ar_scan_bwd(x[cut:], env[cut - 1], env[cut:], g[cut:], gf, **kw)
    gx1, g0 = envelope.envelope_ar_scan_bwd(x[:cut], e0.abs(), env[:cut], g[:cut], g_mid, **kw)
    _bwd_close((torch.cat([gx1, gx2]), g0), want, f"envelope T={T} C={C} cut", BWD_TOL)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "exponential"])
@pytest.mark.parametrize("T", [777, 16385])
def test_slew_backward_kernel_matches_plain(cuda, linear, T):
    """Steps that hit the limits exactly (ties: the gradient split), noise,
    odd T; and the value handed across a cut."""
    from pygmu2_tpu_torch.ops import slew

    (noise,) = _seeded(cuda, T, (T,))
    x = torch.where(torch.arange(T, device=cuda) % 200 < 100, 1.0, 0.0) + 0.25 * noise * (
        torch.arange(T, device=cuda) > T // 2)
    g, gc = _seeded(cuda, T + 1, (T,), ())
    kw = dict(linear=linear, p_rise=0.25 if linear else 0.05, p_fall=0.125 if linear else 0.01)
    c0 = torch.zeros((), device=cuda)
    y, _ = slew.slew_scan(x, c0, **kw)
    before = slew.slew_scan_bwd.launches
    got = slew.slew_scan_bwd(x, c0, y, g, gc, **kw)
    torch.cuda.synchronize()
    assert slew.slew_scan_bwd.launches == before + 1
    want = slew.slew_scan_bwd_ref(x, c0, y, g, gc, **kw)
    _bwd_close(got, want, f"slew linear={linear} T={T}", BWD_TOL)
    cut = T // 2 + 1
    gx2, g_mid = slew.slew_scan_bwd(x[cut:], y[cut - 1], y[cut:], g[cut:], gc, **kw)
    gx1, g0 = slew.slew_scan_bwd(x[:cut], c0, y[:cut], g[:cut], g_mid, **kw)
    _bwd_close((torch.cat([gx1, gx2]), g0), want, f"slew linear={linear} cut", BWD_TOL)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "exponential"])
@pytest.mark.parametrize("T", [16384, 16385, 777, 5])
def test_slew_backward_kernel_equals_grid_order(cuda, linear, T):
    """The slew limiter's adjoint launch (csrc/order1_grid.cuh at one
    channel) bit for bit with its order in torch ops on the card
    (``slew_scan_bwd_chunked``): the fit chain's T = 16384, T not a multiple
    of the 256-sample chunk, one short chunk; steps that hit the limits
    exactly (ties: the coefficient 1/2). A second launch gives the same
    bits; the launch counter moves by one a call."""
    from pygmu2_tpu_torch.ops import slew

    (noise,) = _seeded(cuda, 3 * T, (T,))
    t = torch.arange(T, device=cuda)
    x = torch.where(t % 200 < 100, 1.0, 0.0) + 0.25 * noise * (t > T // 2)
    g, gc = _seeded(cuda, 3 * T + 1, (T,), ())
    kw = dict(linear=linear, p_rise=0.25 if linear else 0.05, p_fall=0.125 if linear else 0.01)
    c0 = torch.zeros((), device=cuda)
    y, _ = slew.slew_scan(x, c0, **kw)
    before = slew.slew_scan_bwd.launches
    got = slew.slew_scan_bwd(x, c0, y, g, gc, **kw)
    again = slew.slew_scan_bwd(x, c0, y, g, gc, **kw)
    torch.cuda.synchronize()
    assert slew.slew_scan_bwd.launches == before + 2
    want = slew.slew_scan_bwd_chunked(x, c0, y, g, gc, **kw)
    for i, (o, r, w) in enumerate(zip(got, again, want)):
        assert torch.equal(o, r), f"output {i}: two launches differ"
        assert torch.equal(o, w), f"output {i} off by {float((o - w).abs().max())}"


def test_slew_backward_source_is_the_grid():
    """The slew limiter's and the comb's backward run order1_grid.cuh; the
    first design's header is gone."""
    csrc = Path(__file__).resolve().parents[1] / "pygmu2_tpu_torch/csrc"
    assert not (csrc / "order1_adjoint.cuh").exists()
    for name in ("slew_scan_bwd.cu", "comb_scan_bwd.cu"):
        text = (csrc / name).read_text()
        assert '#include "order1_grid.cuh"' in text and "order1_grid::launch" in text


@pytest.mark.parametrize("C,ratio,alt,T", [(1, 1.5, 1.0, 4097), (2, "mod", 0.0, 1001),
                                           (128, 1.5, 1.0, 4097), (3, 1.0, 1.0, 999)])
def test_reverse_echo_backward_kernel_matches_plain(cuda, C, ratio, alt, T):
    """The echo's backward launch (on the forward launch's control
    results: the readers' index, the periods in reverse over the card, the
    gather) against the plain adjoint: a fifth up, a modulated ratio, unity
    (the pass-through), reversed and alternating replay, C = 1, 2, 3 and
    128, rings and a pitch line handed in; then the state handed across a
    cut: the two calls' backward, the rings' cotangents passed from the
    second to the first, equals the whole call's."""
    from pygmu2_tpu_torch.ops import reverse_echo as re_

    args, kw, fwd = _echo_case(cuda, C, ratio, alt, T)
    x, blk, r, fb, al, pb, misc, y, gy, gba, gbb, gpb, gm = args
    res = fwd(x, blk, r, fb, al, pb, misc)[5:]
    before = re_.reverse_echo_scan_bwd.launches
    got = re_.reverse_echo_scan_bwd(*args, res, **kw)
    torch.cuda.synchronize()
    assert re_.reverse_echo_scan_bwd.launches == before + 1
    want = re_.reverse_echo_scan_bwd_ref(*args, **kw)
    _bwd_close(got, want, f"echo C={C} ratio={ratio} alt={alt}", BWD_TOL)
    cut = T // 3
    head = [v[:cut] if v.dim() and v.shape[0] == T else v for v in (x, blk, r, fb, al)]
    tail = [v[cut:] if v.dim() and v.shape[0] == T else v for v in (x, blk, r, fb, al)]
    y1, ba1, bb1, pb1, m1, *res1 = fwd(*head, pb, misc)
    res2 = fwd(*tail, pb1, m1, rings=(ba1, bb1))[5:]
    gx2, gr2, gfb2, ga1, gb1, gp1, gm1 = re_.reverse_echo_scan_bwd(
        *tail, pb1, m1, y[cut:], gy[cut:], gba, gbb, gpb, gm, res2, **kw)
    gx1, gr1, gfb1, ga0, gb0, gp0, gm0 = re_.reverse_echo_scan_bwd(
        *head, pb, misc, y1, gy[:cut], ga1, gb1, gp1, gm1, tuple(res1), **kw)
    joined = (torch.cat([gx1, gx2]), torch.cat([gr1, gr2]), torch.cat([gfb1, gfb2]), ga0, gb0,
              gp0, gm0)
    _bwd_close(joined, want, f"echo C={C} ratio={ratio} cut", BWD_TOL)


def _echo_case(device, C, ratio, alt, T, seed_shift=0):
    """A seeded echo call on the card: the backward's arguments (the
    forward's, its output, the cotangents), the keywords, and the recorded
    forward launch (its control results after its five outputs)."""
    from pygmu2_tpu_torch.ops import reverse_echo as re_

    cap, plen, sr = 400, 64, 8000.0
    x, fb, ba, bb, pb = _seeded(device, C + T + seed_shift, (T, C), (T,), (cap, C), (cap, C),
                                (plen, C))
    if ratio == "mod":
        (r,) = _seeded(device, 9, (T,), lo=0.7, hi=1.6)
    else:
        r = torch.full((T,), ratio, device=device)
    blk = torch.full((T,), 150.0 / sr, device=device)
    blk[T // 2:] = 90.0 / sr
    al = torch.full((T,), alt, device=device)
    misc = torch.tensor([1, 3, 5.5, 10, 10, 150.0, 150, 150, 1], device=device)
    kw = dict(sr=sr, plen=plen, cap=cap, min_block=8, max_block=cap - 1, smooth_alpha=1 / 240)
    fb = fb * 0.3 + 0.4

    def fwd(x, blk, r, fb, al, pb, misc, rings=(ba, bb)):
        return re_._launch(x, blk, r, fb, al, *(v.clone() for v in rings), pb, misc, **kw,
                           residuals=True)

    y = fwd(x, blk, r, fb, al, pb, misc)[0]
    gy, gba, gbb, gpb, gm = _seeded(device, 3 * C, (T, C), (cap, C), (cap, C), (plen, C), (9,))
    return (x, blk, r, fb, al, pb, misc, y, gy, gba, gbb, gpb, gm), kw, fwd


@pytest.mark.parametrize("C,ratio,alt,T", [(1, 1.5, 1.0, 4097), (2, "mod", 0.0, 1001),
                                           (128, "mod", 1.0, 4097), (3, 1.0, 1.0, 999),
                                           (4, "mod", 1.0, 2500), (1, 0.6, 0.0, 16384)])
def test_reverse_echo_backward_kernel_equals_period_order(cuda, C, ratio, alt, T):
    """The echo's backward kernel equals its order in torch ops
    (``reverse_echo_scan_bwd_periods`` on the same control results) bit for
    bit, and a second launch gives the same bits (no atomics): C = 1 (a
    lane a channel), 4 and 128 (16-byte pieces), 2 and 3; T = 16384 one
    launch of the fit fx bank's length."""
    from pygmu2_tpu_torch.ops import reverse_echo as re_

    args, kw, fwd = _echo_case(cuda, C, ratio, alt, T, seed_shift=1)
    res = fwd(*args[:7])[5:]
    got = re_.reverse_echo_scan_bwd(*args, res, **kw)
    again = re_.reverse_echo_scan_bwd(*args, res, **kw)
    want = re_.reverse_echo_scan_bwd_periods(*args, res, **kw)
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a), f"output {i}: two launches differ"
        assert torch.equal(g, w), f"output {i}: off the period order by {(g - w).abs().max()}"


def test_reverse_echo_backward_source_has_no_atomics():
    src = Path(__file__).resolve().parents[1] / "pygmu2_tpu_torch/csrc/reverse_echo_scan_bwd.cu"
    text = src.read_text()
    assert text.count("atomicAdd") == 0
    assert "echo_control<<<" not in text


def test_reverse_echo_residual_and_untracked_forward(cuda):
    """The forward launch with and without its control results gives the
    same bits; through the autograd Function (the recorded launch, its
    results kept as residuals) the gradient equals the plain adjoint's; an
    untracked call (no gradient) keeps none and launches once."""
    from pygmu2_tpu_torch.ops import reverse_echo as re_

    args, kw, fwd = _echo_case(cuda, 3, "mod", 1.0, 3001, seed_shift=2)
    x, blk, r, fb, al, pb, misc, y, gy, *_ = args
    cap = kw["cap"]
    ba, bb = _seeded(cuda, 77, (cap, 3), (cap, 3))
    plain = re_._launch(x, blk, r, fb, al, ba.clone(), bb.clone(), pb, misc, **kw)
    recorded = re_._launch(x, blk, r, fb, al, ba.clone(), bb.clone(), pb, misc, **kw,
                           residuals=True)
    assert len(plain) == 5 and len(recorded) == 8
    for a, b in zip(plain, recorded):
        assert torch.equal(a, b)
    before = re_.reverse_echo_scan.launches
    with torch.no_grad():
        out = re_.reverse_echo_scan(x, blk, r, fb, al, ba.clone(), bb.clone(), pb, misc, **kw)
    assert len(out) == 5 and re_.reverse_echo_scan.launches == before + 1
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    ins = [v.clone().requires_grad_() for v in (x, r, fb, pb)]
    n_bwd = re_.reverse_echo_scan_bwd.launches
    out = re_.reverse_echo_scan(ins[0], blk, ins[1], ins[2], al, ba.clone(), bb.clone(), ins[3],
                                misc, **kw)
    assert len(out) == 5
    got = torch.autograd.grad(out[0], ins, gy)
    torch.cuda.synchronize()
    assert re_.reverse_echo_scan_bwd.launches == n_bwd + 1
    zeros = [torch.zeros_like(v) for v in (ba, bb, pb)] + [torch.zeros(9, device=cuda)]
    want = re_.reverse_echo_scan_bwd_ref(x, blk, r, fb, al, pb, misc, out[0].detach(), gy,
                                         *zeros, **kw)
    _bwd_close(got, [want[i] for i in (0, 1, 2, 5)], "echo through the Function", BWD_TOL)


def _gate(T, kind):
    g = np.zeros(T, np.float32)
    if kind == "gated":
        g[100:1200] = 1.0
        g[1500:1501] = 1.0
        g[1700:T - 50] = 1.0
    else:  # triggers
        g[[50, 300, 301, 1500, T - 3]] = 1.0
    return g


@pytest.mark.parametrize("kind,state", [
    ("gated", [4.0, 0.5, 3.0, 1.0]), ("gated", [1.0, 0.2, 3.0, 0.0]),
    ("gated", [3.0, 0.6, 0.0, 1.0]), ("gated", [2.5, 0.3, 0.5, 1.0]),
    ("triggered", [1.0, 0.2, 3.0, 0.0]), ("triggered", [3.0, 0.6, 30.0, 0.0]),
    ("triggered", [4.0, 0.6, 3.0, 0.0])])
def test_adsr_backward_kernel_matches_plain(cuda, kind, state):
    """The edge-walk branch's backward (every sample's cut test at once, the
    cotangents summed to the first cut) against the plain adjoint: a state
    in every stage, one outside the closed form (the per-sample walk),
    gated and triggered; and against autograd of the plain forward on the
    card."""
    from pygmu2_tpu_torch.ops import adsr

    T = 2049
    gate = torch.from_numpy(_gate(T, kind)).to(cuda)
    st = torch.tensor(state, device=cuda)
    kw = dict(dA=1.0 / 80, dD=-0.4 / 200, dR=-0.6 / 300, sus=0.6,
              sustain_samples=None if kind == "gated" else 100)
    env, ns, en = adsr.adsr_scan(gate, st, **kw)
    g, gs, gn = _seeded(cuda, 11, (T,), (4,), ())
    before = adsr.adsr_scan_bwd.launches
    got = adsr.adsr_scan_bwd(gate, st, env, g, gs, gn, **kw)
    torch.cuda.synchronize()
    assert adsr.adsr_scan_bwd.launches == before + 1
    want = adsr.adsr_scan_bwd_ref(gate, st, env, g, gs, gn, **kw)
    _bwd_close((got,), (want,), f"adsr {kind} {state}", BWD_TOL)
    sg = st.clone().requires_grad_()
    outs = adsr.adsr_scan_ref(gate, sg, **kw)
    pairs = [(o, c) for o, c in zip(outs, (g, gs, gn)) if o.requires_grad]
    (auto,) = torch.autograd.grad([o for o, _ in pairs], [sg], [c for _, c in pairs])
    _bwd_close((got,), (auto,), f"adsr {kind} {state} vs autograd", BWD_TOL)


@pytest.mark.parametrize("kind,state,T", [
    ("gated", [4.0, 0.5, 3.0, 1.0], 2049), ("gated", [1.0, 0.2, 3.0, 0.0], 2049),
    ("gated", [3.0, 0.6, 0.0, 1.0], 2049), ("gated", [2.5, 0.3, 0.5, 1.0], 2049),
    ("triggered", [1.0, 0.2, 3.0, 0.0], 2049), ("triggered", [3.0, 0.6, 30.0, 0.0], 2049),
    ("triggered", [4.0, 0.6, 3.0, 0.0], 2049), ("gated", [4.0, 0.5, 3.0, 0.0], 40000),
    ("gated", [4.0, 0.9, 1.0, 0.0], 16384 + 700), ("gated", [4.0, 0.9, 1.0, 0.0], 1024)])
def test_adsr_backward_kernel_equals_tiled_order(cuda, kind, state, T):
    """The ADSR's adjoint launch bit for bit with its order in torch ops on
    the card (``adsr_scan_bwd_tiled``): the seven states of
    test_adsr_backward_kernel_matches_plain; T past one tile of 16384
    samples, with no cut (slow ramps, edges in the first and the last of
    three tiles) and with the cut in the second tile (an edge at 16380);
    the probe's T = 1024 (a block of two warps).
    A second launch gives the same bits."""
    from pygmu2_tpu_torch.ops import adsr

    gate = torch.from_numpy(_gate(T, kind)).to(cuda)
    kw = dict(dA=1.0 / 80, dD=-0.4 / 200, dR=-0.6 / 300, sus=0.6,
              sustain_samples=None if kind == "gated" else 100)
    if T == 40000:  # slow ramps: nothing cuts
        kw.update(dA=1.0 / 80000, dR=-0.1 / 300000)
    elif T != 2049:  # the attack from an edge at 16380 (or past T) hits in the next tile
        gate = torch.zeros(T, device=cuda)
        gate[16380:16500] = 1.0
        kw.update(dR=-0.6 / 300000)
    st = torch.tensor(state, device=cuda)
    env, _, _ = adsr.adsr_scan(gate, st, **kw)
    g, gs, gn = _seeded(cuda, T + 13, (T,), (4,), ())
    before = adsr.adsr_scan_bwd.launches
    got = adsr.adsr_scan_bwd(gate, st, env, g, gs, gn, **kw)
    again = adsr.adsr_scan_bwd(gate, st, env, g, gs, gn, **kw)
    torch.cuda.synchronize()
    assert adsr.adsr_scan_bwd.launches == before + 2
    want = adsr.adsr_scan_bwd_tiled(gate, st, env, g, gs, gn, **kw)
    assert torch.equal(got, again), "two launches differ"
    assert torch.equal(got, want), f"off the tiled order by {float((got - want).abs().max())}"
    plain = adsr.adsr_scan_bwd_ref(gate, st, env, g, gs, gn, **kw)
    _bwd_close((got,), (plain,), f"adsr {kind} {state} T={T}", BWD_TOL)


@pytest.mark.parametrize("stage,env", [(0, 0.0), (1, 0.3), (4, 0.5), (2, 0.9)])
def test_adsr_clock_backward_kernel_matches_plain(cuda, stage, env):
    """The clock branch's backward (one thread walking to the first
    constant value, the block summing the cotangents before it) against
    the plain adjoint, a trigger in the call."""
    from pygmu2_tpu_torch.ops import adsr

    T = 3001
    trig = torch.from_numpy(_gate(T, "triggered")).to(cuda)
    kw = dict(dA=1.0 / 400, dD=-0.4 / 200, dR=-0.6 / 3000, sus=0.6)
    st = torch.tensor(stage, dtype=torch.int32, device=cuda)
    e = torch.tensor(env, dtype=torch.float64, device=cuda)
    (g,) = _seeded(cuda, 12, (T,))
    gout = torch.tensor(0.7, dtype=torch.float64, device=cuda)
    before = adsr.adsr_clock_scan_bwd.launches
    got = adsr.adsr_clock_scan_bwd(trig, st, e, g, gout, **kw)
    torch.cuda.synchronize()
    assert adsr.adsr_clock_scan_bwd.launches == before + 1
    want = adsr.adsr_clock_scan_bwd_ref(trig, st, e, g, gout, **kw)
    assert abs(float(got) - float(want)) <= 1e-9 * max(abs(float(want)), 1.0), (got, want)


def test_effects_gradients_on_card_match_cpu(cuda):
    """The fit chain (1024 samples, block 256) and the ADSR probe: the
    card's gradients (the four backward kernels) within 1e-3 relative of
    the CPU's (plain versions), each backward kernel launched once a block
    (the feedback's gradient is zero in both: no replay yet)."""
    import pygmu2_tpu_torch as pt
    from pygmu2_tpu_torch import fit_workload as fw
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.ops import adsr, envelope, reverse_echo, slew

    bwd = (envelope.envelope_ar_scan_bwd, slew.slew_scan_bwd,
           reverse_echo.reverse_echo_scan_bwd, adsr.adsr_scan_bwd)
    for graph, theta, n, block, want_counts in (
            (fw.build_fit_chain(pt, 1024 / 44100), {"depth": 2500.0, "fb": 0.6}, 1024, 256,
             (4, 4, 4, 0)),
            (fw.build_adsr_probe(pt, 1024), {"g": 1.0}, 1024, 256, (0, 0, 0, 4))):
        grads = {}
        for dev in (cuda, torch.device("cpu")):
            th = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in theta.items()}
            before = [f.launches for f in bwd]
            out = engine.render_functional(graph, 0, n, block, th, device=dev)
            grads[dev.type] = torch.autograd.grad((out ** 2).mean(), list(th.values()),
                                                  allow_unused=True, materialize_grads=True)
            if dev.type == "cuda":
                assert tuple(f.launches - b for f, b in zip(bwd, before)) == want_counts
        for g, w in zip(grads["cuda"], grads["cpu"]):
            assert abs(float(g) - float(w)) <= 1e-3 * abs(float(w)) + 1e-12, (grads,)


# ---- multi-device rendering (parallel/render.py) on 2 shards of one card ----


def _two_shards(cuda):
    from pygmu2_tpu_torch.parallel import render as par

    return par.Mesh([cuda, cuda])


def _chain(pt):
    src = pt.SinePE(frequency=220.0, amplitude=0.7)
    return pt.BiquadPE(pt.BiquadPE(src, 3000.0, 1.2), 800.0, 0.9)


def test_sharded_pure_equals_render_scan(cuda):
    import pygmu2_tpu_torch as pt
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.parallel import render as par

    pt.set_sample_rate(44100)
    total = 3 * 4096 + 100
    graph = pt.GainPE(pt.SinePE(frequency=441.0), 0.5)
    got = par.render_time_sharded(graph, 300, total, _two_shards(cuda), block=4096)
    want = engine.render_scan(graph, 300, total, 4096, device=cuda).cpu().numpy()
    np.testing.assert_array_equal(got, want)


def test_sharded_relay_equals_render_scan_on_kernels(cuda):
    """The patch's ladder, comb and ADSR kernels: the relay renders
    render_scan's blocks from the same states (same bits, same launches)
    and leaves the instances' states as they were."""
    import pygmu2_tpu_torch as pt
    from pygmu2_tpu_torch import patch_workload
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.ops import adsr, comb, ladder
    from pygmu2_tpu_torch.parallel import render as par

    kernels = (ladder.ladder_scan, comb.comb_scan, adsr.adsr_scan)
    total = int(0.5 * 44100)
    patch = patch_workload.build_patch(pt, 0.5)
    before = [f.launches for f in kernels]
    want = engine.render_scan(patch, 0, total, 4096, device=cuda).cpu().numpy()
    one = [f.launches - b for f, b in zip(kernels, before)]
    snap = engine.checkpoint_state(patch)
    before = [f.launches for f in kernels]
    got = par.render_time_sharded_stateful(patch, 0, total, _two_shards(cuda), block=4096)
    assert [f.launches - b for f, b in zip(kernels, before)] == one and min(one) > 0
    np.testing.assert_array_equal(got, want)
    after = engine.checkpoint_state(patch)
    assert snap.keys() == after.keys()
    for key in snap:
        assert int(snap[key]["next"]) == int(after[key]["next"])
        for a, b in zip(torch.utils._pytree.tree_leaves(snap[key]["user"]),
                        torch.utils._pytree.tree_leaves(after[key]["user"])):
            np.testing.assert_array_equal(a, b)


def test_sharded_halo_on_the_filter_bank(cuda):
    """The 128-channel bank's scans on the kernel: past the first span
    within 1e-5 of render_scan; the gate raises on the patch."""
    import pygmu2_tpu_torch as pt
    from pygmu2_tpu_torch import filter_workload, patch_workload
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.ops import linrec_kernel
    from pygmu2_tpu_torch.parallel import render as par

    total = int(0.5 * 44100)
    bank = filter_workload.build_filter_bank(pt, 0.5)
    want = engine.render_scan(bank, 0, total, 4096, device=cuda).cpu().numpy()
    before = linrec_kernel.affine_scan_2_kernel.launches
    got = par.render_time_sharded_stateful(bank, 0, total, _two_shards(cuda), block=4096,
                                           halo=4096)
    assert linrec_kernel.affine_scan_2_kernel.launches > before
    span = par._spans(total, 2, 4096)[0]
    np.testing.assert_allclose(got[span:], want[span:], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="non-decaying"):
        par.render_time_sharded_stateful(patch_workload.build_patch(pt, 0.5), 0, total,
                                         _two_shards(cuda), block=4096, halo=4096)


def test_sharded_affine_and_auto(cuda):
    import pygmu2_tpu_torch as pt
    from pygmu2_tpu_torch.core import engine
    from pygmu2_tpu_torch.parallel import render as par

    pt.set_sample_rate(44100)
    mesh, total = _two_shards(cuda), 44100
    want = engine.render_scan(_chain(pt), 0, total, 4096, device=cuda).cpu().numpy()
    got = par.render_time_sharded_affine(_chain(pt), 0, total, mesh, block=4096)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert par.select_time_sharding(_chain(pt), mesh, block=4096) == ("relay", 8)
    assert par.select_time_sharding(_chain(pt), mesh, block=4096,
                                    affine_max_basis=16) == ("affine", 8)
    auto = par.render_time_sharded_auto(_chain(pt), 0, total, mesh, block=4096,
                                        affine_max_basis=16)
    np.testing.assert_array_equal(auto, got)
    auto = par.render_time_sharded_auto(_chain(pt), 0, total, mesh, block=4096)
    np.testing.assert_array_equal(auto, want)


def test_midi_sharded_matches_schedule(cuda):
    from pygmu2_tpu_torch.ops import linrec_kernel
    from pygmu2_tpu_torch.parallel import render as par

    synth, midi = bench_workload.build_workload(False, device=cuda)
    want = synth.render_midi_schedule(midi, SECONDS)
    before = linrec_kernel.affine_scan_2_kernel.launches
    got = par.render_midi_sharded(synth, midi, SECONDS, _two_shards(cuda))
    n_blocks = -(-int(SECONDS * 44100) // 1024)
    assert linrec_kernel.affine_scan_2_kernel.launches - before == 2 * n_blocks
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("large", [False, True], ids=["small_font", "large_font"])
def test_midi_offline_sharded_bit_for_bit(cuda, large):
    """Shards of 32 voices (one CUDA block of voices each): the shards'
    mixes summed in mesh order are the kernel's own sum, so 64 voices on
    two shards equal the one-device render bit for bit (f32 and int16);
    128 voices (64 a shard) within 1e-6."""
    from pygmu2_tpu_torch.parallel import render as par
    from pygmu2_tpu_torch.soundfont import SoundFont, Synthesizer, SynthesizerSettings

    _, midi = bench_workload.build_workload(large, device=cuda)
    for poly, bits in ((64, True), (128, False)):
        synth = Synthesizer(SoundFont(bench_workload.build_font_bytes(large=large)),
                            SynthesizerSettings(sample_rate=44100, block_size=1024,
                                                maximum_polyphony=poly), device=cuda)
        want = off.render_midi_offline(synth, midi, SECONDS, device=cuda)
        want16 = off.render_midi_offline(synth, midi, SECONDS, wire="int16", device=cuda)
        before = fk.osc_filter_gain_mix.launches
        got = par.render_midi_offline_sharded(synth, midi, SECONDS, _two_shards(cuda))
        assert fk.osc_filter_gain_mix.launches - before == 2
        assert np.abs(want).max() > 0.01
        if bits:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                off._to_wire(torch.from_numpy(got), "int16").numpy(), want16)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
