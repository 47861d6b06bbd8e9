"""The order-2 affine scan's (forward and backward), the follower's, the
slew limiter's, the ADSR's and the comb's backward and the unfused SoundFont
pass's kernels timed alone on one CUDA card, at the main path's shapes:
``python pygmu2_tpu_torch/kernel_times.py [--tree DIR] [PART ...]``.

``--tree`` names the checkout whose ``pygmu2_tpu_torch`` is timed (default:
this one), so that two trees are timed by the same script in turns (parent,
change, change, parent: unpack the parent with ``git archive`` into a
directory that ``.gitignore`` lists). ``PART`` picks sections (``scan``,
``follower``, ``slew``, ``adsr``, ``comb``, ``unfused``; all by default).
The calls are the same in both trees: ``ops.linrec_kernel.affine_scan_2_kernel``
and ``_backward`` (the scan's backward as its autograd Function calls it,
the channel sums of the shared columns included),
``ops.envelope.envelope_ar_scan_bwd``, ``ops.slew.slew_scan_bwd``,
``ops.adsr.adsr_scan_bwd``, ``ops.comb.comb_scan_bwd`` (on the control
results of a forward launch) and ``soundfont.filter_kernels.filter_gain_mix``.

Inputs: the scan at T = 16384, C = 128, chunk 1024, once with the four
matrix planes one column shared by the channels (the filter bank's
BiquadPE and SVFilterPE) and once with six full planes; its backward on
the shared columns as (T, 1) planes (the fit bank's SVFilterPE), with an
entering state; the follower's backward at T = 16384, C = 1 (the fit
chain's) and C = 128 (the fit fx bank's); the slew limiter's at T = 16384
(the fit chain's), both modes; the ADSR's with the ADSR probe's times
(attack 5 ms, decay and release 10 ms, sustain 0.6) at the probe's
T = 1024 and at T = 16384 on ``chip_smoke.py`` phase 16's gate (each cut
by the attack's hit after ~500 samples), and at T = 16384 on slow ramps
(no cut: the whole call walked); the comb's at T = 16384, C = 1, L = 2206
(the fit patch's); the unfused pass on the high-register score's rows (3
s, large font: T = 133,120, P = 128, N = 1024). For each: CUDA events
around 10 back-to-back calls after a warm-up (these also count the
wrapper's host enqueue), and torch.profiler's device events of 10 calls:
the kernel alone, every kernel of a call summed (the unfused pass was
three kernels before its redesign, each launched once a call), and every
device item of a call by name. Prints the card's name and power limit,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

SCAN_T, SCAN_C, SCAN_CHUNK = 16384, 128, 1024
# the kernels' names (this tree's and the parent's) in the profiler's events
KERNEL_KEYS = {
    "affine_scan_2": ("affine_scan_2",),
    "affine_scan_2_bwd": ("affine_scan_2", "channel_sum"),
    "envelope_ar_scan_bwd": ("adjoint",),
    "slew_scan_bwd": ("adjoint",),
    "adsr_scan_bwd": ("adsr_bwd",),
    "comb_scan_bwd": ("adjoint", "comb_bwd_windows", "channel_sum"),
    "filter_gain_mix": ("XtSource", "zero_state", "carry", "render"),
}
FOLLOWER_KW = dict(atk=0.05, rel=0.002)
SLEW_KW = {"linear": dict(linear=True, p_rise=40000.0 / 44100, p_fall=8000.0 / 44100),
           "exponential": dict(linear=False, p_rise=0.05, p_fall=0.01)}
ADSR_KW = dict(dA=1.0 / 220.5, dD=-0.4 / 441.0, dR=-0.6 / 441.0, sus=0.6)
COMB_L = 2206
PARTS = ("scan", "follower", "slew", "adsr", "comb", "unfused")


def _seeded(dev, seed, *shapes, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(lo, hi, s).astype(np.float32)).to(dev)
            for s in shapes]


def events_ms(fn, reps: int = 10) -> float:
    """Mean ms a call by CUDA events around ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_items(fn, keys, reps: int = 10) -> tuple[float, dict]:
    """(ms a call of the kernels whose names hold one of ``keys``, every
    kernel of a call summed; {item name: ms a call}) from torch.profiler's
    device events of ``reps`` calls. Some sessions drop events or trace
    some twice: a session that traced such a kernel other than ``reps``
    times is run again, at most twice more, and past that each kernel
    counts at its median event (each kernel here launches once a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = defaultdict(list)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                times[e.name].append((e.time_range.end - e.time_range.start) / 1e3)
        ours = [name for name in times if any(k in name for k in keys)]
        items = {name: sum(ts) / reps for name, ts in times.items()}
        if ours and all(len(times[name]) == reps for name in ours):
            return sum(items[name] for name in ours), items
    if not ours:
        raise RuntimeError(f"no device event named like {keys} in three sessions")
    return sum(statistics.median(times[name]) for name in ours), items


def _timed(call, keys, ref=None, **info) -> dict:
    """A call's entry: its largest difference from ``ref`` (outputs in
    order), CUDA events, the kernels alone and every device item."""
    got = call()
    if ref is not None:
        got = [got] if torch.is_tensor(got) else got
        ref = [ref] if torch.is_tensor(ref) else ref
        info["max_abs_err"] = max((a - b.sum_to_size(a.shape)).abs().max().item()
                                  for a, b in zip(got, ref))
    alone, items = device_items(call, keys)
    return {**info, "events_ms": events_ms(call), "alone_ms": alone, "items_ms": items}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("parts", nargs="*", help=f"any of {', '.join(PARTS)} (default: all)")
    opts = parser.parse_args()
    tree, parts = Path(opts.tree).resolve(), set(opts.parts or PARTS)
    if parts - set(PARTS):
        parser.error(f"unknown parts {sorted(parts - set(PARTS))}")
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(tree))
    from pygmu2_tpu_torch import bench_workload
    from pygmu2_tpu_torch.ops import adsr, comb, envelope, slew
    from pygmu2_tpu_torch.ops import linrec_kernel as lk
    from pygmu2_tpu_torch.soundfont import MidiFile
    from pygmu2_tpu_torch.soundfont import filter_kernels as fk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    print(smi.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    result = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}

    T, C = SCAN_T, SCAN_C
    if "scan" in parts:
        for name, shared in (("scan, matrix planes shared", True),
                             ("scan, six full planes", False)):
            mats = _seeded(dev, 11, *[(T, 1 if shared else C)] * 4, lo=-0.7, hi=0.7)
            planes = [m.expand(T, C) for m in mats] + _seeded(dev, 12, (T, C), (T, C))
            s0 = tuple(_seeded(dev, 13, (C,), (C,)))
            result[name] = _timed(
                lambda: lk.affine_scan_2_kernel(*planes, s0, chunk=SCAN_CHUNK),
                KERNEL_KEYS["affine_scan_2"],
                lk.affine_scan_2_chunked_ref(*planes, s0, chunk=SCAN_CHUNK),
                shape=f"T={T} C={C} chunk={SCAN_CHUNK}")

        mats = _seeded(dev, 14, *[(T, 1)] * 4, lo=-0.7, hi=0.7)
        u1, u2, g1, g2 = _seeded(dev, 15, (T, C), (T, C), (T, C), (T, C))
        s0 = tuple(_seeded(dev, 16, (C,), (C,)))
        args = (*mats, u1, u2, *s0)
        outs = lk.affine_scan_2_kernel(*mats, u1, u2, s0, chunk=SCAN_CHUNK)
        ref = lk.affine_scan_2_bwd_ref(*args, *outs, g1, g2, chunk=SCAN_CHUNK)
        result["scan backward, matrix planes (T, 1) columns"] = _timed(
            lambda: lk._backward(args, outs, (g1, g2), chunk=SCAN_CHUNK),
            KERNEL_KEYS["affine_scan_2_bwd"], ref, shape=f"T={T} C={C} chunk={SCAN_CHUNK}")

    if "follower" in parts:
        for C in (1, 128):
            x, e0, g, gf = _seeded(dev, 17 + C, (T, C), (C,), (T, C), (C,))
            x, e0 = x.abs(), e0.abs()
            env, _ = envelope.envelope_ar_scan(x, e0, **FOLLOWER_KW)
            result[f"follower backward, C={C}"] = _timed(
                lambda: envelope.envelope_ar_scan_bwd(x, e0, env, g, gf, **FOLLOWER_KW),
                KERNEL_KEYS["envelope_ar_scan_bwd"],
                envelope.envelope_ar_scan_bwd_ref(x, e0, env, g, gf, **FOLLOWER_KW),
                shape=f"T={T} C={C}")

    if "slew" in parts:
        (noise,) = _seeded(dev, 30, (T,), lo=0.0, hi=1.0)
        x = 300.0 + 2500.0 * noise  # the wah's centre: 300 Hz + depth x envelope
        g, gc = _seeded(dev, 31, (T,), ())
        c0 = torch.full((), 300.0, device=dev)
        for mode, kw in SLEW_KW.items():
            y, _ = slew.slew_scan(x, c0, **kw)
            result[f"slew backward, {mode}"] = _timed(
                lambda: slew.slew_scan_bwd(x, c0, y, g, gc, **kw),
                KERNEL_KEYS["slew_scan_bwd"], slew.slew_scan_bwd_ref(x, c0, y, g, gc, **kw),
                shape=f"T={T} C=1")

    if "adsr" in parts:
        for label, n, slow in (("probe's T", 1024, False), ("phase 16's gate", T, False),
                               ("slow ramps, no cut", T, True)):
            gate = torch.zeros(n, device=dev)
            for a, b in ((300, 2500), (4000, 4001), (5000, 9000), (12000, T - 100)):
                gate[a:b] = 1.0
            kw = dict(ADSR_KW, sustain_samples=None)
            if slow:
                kw.update(dA=1.0 / 80000, dR=-0.1 / 300000)
            state = torch.tensor([4.0, 0.5, 0.0, 1.0], device=dev)
            env, _, _ = adsr.adsr_scan(gate, state, **kw)
            g, gs, gn = _seeded(dev, 32, (n,), (4,), ())
            args = (gate, state, env, g, gs, gn)
            _, walked = adsr.adsr_scan_bwd_ref(*args, **kw, with_walked=True)
            result[f"adsr backward, {label}"] = _timed(
                lambda: adsr.adsr_scan_bwd(*args, **kw), KERNEL_KEYS["adsr_scan_bwd"],
                adsr.adsr_scan_bwd_ref(*args, **kw), shape=f"T={n}", walked=walked)

    if "comb" in parts:
        x, gy = _seeded(dev, 33, (T, 1), (T, 1))
        (freq,) = _seeded(dev, 34, (T,), lo=200.0, hi=240.0)
        (fb,) = _seeded(dev, 35, (T,), lo=0.5, hi=0.7)
        buf, gbuf = _seeded(dev, 36, (COMB_L, 1), (COMB_L, 1))
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        sf = torch.full((), 220.0, device=dev)
        gsf = torch.full((), 0.7, device=dev)
        kw = dict(L=COMB_L, sr=44100.0, smooth_alpha=1.0 / 240)
        y, _, _, _, *residuals = comb._launch(x, freq, fb, buf, pos, sf, **kw)
        args = (x, freq, fb, buf, pos, sf, y, gy, gbuf, gsf)
        result["comb backward, C=1"] = _timed(
            lambda: comb.comb_scan_bwd(*args, tuple(residuals), **kw),
            KERNEL_KEYS["comb_scan_bwd"], comb.comb_scan_bwd_windows(*args, **kw),
            shape=f"T={T} C=1 L={COMB_L}")

    if "unfused" in parts:
        seconds = 3.0
        synth, _ = bench_workload.build_workload(True)
        midi = MidiFile(bench_workload.build_high_midi_bytes(seconds))
        rows, wave, N = bench_workload.audio_pass_rows(synth, midi, seconds, dev)
        xt = fk._oscillator(rows, wave, N)
        ref = fk.filter_gain_mix_ref(xt, rows, N)
        result["unfused pass, high score"] = _timed(
            lambda: fk.filter_gain_mix(xt, rows, N), KERNEL_KEYS["filter_gain_mix"], ref,
            shape=f"T={xt.shape[0]} P={xt.shape[1]} N={N}", peak=ref.abs().max().item())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
