"""The order-2 affine scan's (forward and backward), the follower's
backward and the unfused SoundFont pass's kernels timed alone on one CUDA
card, at the main path's shapes:
``python pygmu2_tpu_torch/kernel_times.py [--tree DIR]``.

``--tree`` names the checkout whose ``pygmu2_tpu_torch`` is timed (default:
this one), so that two trees are timed by the same script in turns (parent,
change, change, parent: unpack the parent with ``git archive`` into a
directory that ``.gitignore`` lists). The calls are the same in both:
``ops.linrec_kernel.affine_scan_2_kernel`` and ``_backward`` (the scan's
backward as its autograd Function calls it, the channel sums of the shared
columns included), ``ops.envelope.envelope_ar_scan_bwd`` and
``soundfont.filter_kernels.filter_gain_mix``.

Inputs: the scan at T = 16384, C = 128, chunk 1024, once with the four
matrix planes one column shared by the channels (the filter bank's
BiquadPE and SVFilterPE) and once with six full planes; its backward on
the shared columns as (T, 1) planes (the fit bank's SVFilterPE), with an
entering state; the follower's backward at T = 16384, C = 1 (the fit
chain's) and C = 128 (the fit fx bank's); the unfused pass on the
high-register score's rows (3 s, large font: T = 133,120, P = 128,
N = 1024). For each: CUDA events around 10 back-to-back calls after a
warm-up (these also count the wrapper's host enqueue), and torch.profiler's
device events of 10 calls: the kernel alone, every kernel of a call summed
(the unfused pass was three kernels before its redesign, each launched
once a call), and every device item of a call by name. Prints the card's
name and power limit, then one JSON line.
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
    "filter_gain_mix": ("XtSource", "zero_state", "carry", "render"),
}
FOLLOWER_KW = dict(atk=0.05, rel=0.002)


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    tree = Path(parser.parse_args().tree).resolve()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(tree))
    from pygmu2_tpu_torch import bench_workload
    from pygmu2_tpu_torch.ops import linrec_kernel as lk
    from pygmu2_tpu_torch.soundfont import MidiFile
    from pygmu2_tpu_torch.soundfont import filter_kernels as fk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    print(smi.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    result = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}

    T, C = SCAN_T, SCAN_C
    for name, shared in (("scan, matrix planes shared", True), ("scan, six full planes", False)):
        mats = _seeded(dev, 11, *[(T, 1 if shared else C)] * 4, lo=-0.7, hi=0.7)
        planes = [m.expand(T, C) for m in mats] + _seeded(dev, 12, (T, C), (T, C))
        s0 = tuple(_seeded(dev, 13, (C,), (C,)))

        def call():
            return lk.affine_scan_2_kernel(*planes, s0, chunk=SCAN_CHUNK)
        got = call()
        ref = lk.affine_scan_2_chunked_ref(*planes, s0, chunk=SCAN_CHUNK)
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        alone, items = device_items(call, KERNEL_KEYS["affine_scan_2"])
        result[name] = {"shape": f"T={T} C={C} chunk={SCAN_CHUNK}", "max_abs_err": err,
                        "events_ms": events_ms(call), "alone_ms": alone, "items_ms": items}

    mats = _seeded(dev, 14, *[(T, 1)] * 4, lo=-0.7, hi=0.7)
    u1, u2, g1, g2 = _seeded(dev, 15, (T, C), (T, C), (T, C), (T, C))
    s0 = tuple(_seeded(dev, 16, (C,), (C,)))
    args = (*mats, u1, u2, *s0)
    outs = lk.affine_scan_2_kernel(*mats, u1, u2, s0, chunk=SCAN_CHUNK)

    def backward():
        return lk._backward(args, outs, (g1, g2), chunk=SCAN_CHUNK)
    got = backward()
    ref = lk.affine_scan_2_bwd_ref(*args, *outs, g1, g2, chunk=SCAN_CHUNK)
    err = max((g - r.sum_to_size(g.shape)).abs().max().item() for g, r in zip(got, ref))
    alone, items = device_items(backward, KERNEL_KEYS["affine_scan_2_bwd"])
    result["scan backward, matrix planes (T, 1) columns"] = {
        "shape": f"T={T} C={C} chunk={SCAN_CHUNK}", "max_abs_err": err,
        "events_ms": events_ms(backward), "alone_ms": alone, "items_ms": items}

    from pygmu2_tpu_torch.ops import envelope
    for C in (1, 128):
        x, e0, g, gf = _seeded(dev, 17 + C, (T, C), (C,), (T, C), (C,))
        x, e0 = x.abs(), e0.abs()
        env, _ = envelope.envelope_ar_scan(x, e0, **FOLLOWER_KW)

        def follower():
            return envelope.envelope_ar_scan_bwd(x, e0, env, g, gf, **FOLLOWER_KW)
        got = follower()
        ref = envelope.envelope_ar_scan_bwd_ref(x, e0, env, g, gf, **FOLLOWER_KW)
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        alone, items = device_items(follower, KERNEL_KEYS["envelope_ar_scan_bwd"])
        result[f"follower backward, C={C}"] = {
            "shape": f"T={T} C={C}", "max_abs_err": err, "events_ms": events_ms(follower),
            "alone_ms": alone, "items_ms": items}

    seconds = 3.0
    synth, _ = bench_workload.build_workload(True)
    midi = MidiFile(bench_workload.build_high_midi_bytes(seconds))
    rows, wave, N = bench_workload.audio_pass_rows(synth, midi, seconds, dev)
    xt = fk._oscillator(rows, wave, N)

    def unfused():
        return fk.filter_gain_mix(xt, rows, N)
    ref = fk.filter_gain_mix_ref(xt, rows, N)
    peak = ref.abs().max().item()
    err = (unfused() - ref).abs().max().item()
    alone, items = device_items(unfused, KERNEL_KEYS["filter_gain_mix"])
    result["unfused pass, high score"] = {
        "shape": f"T={xt.shape[0]} P={xt.shape[1]} N={N}", "max_abs_err": err, "peak": peak,
        "events_ms": events_ms(unfused), "alone_ms": alone, "items_ms": items}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
