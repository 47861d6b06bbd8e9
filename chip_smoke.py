#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port's main path, the offline SoundFont render of the bench
workload (a 128-voice chord, 44.1 kHz, block 1024; see
``pygmu2_tpu_torch/bench_workload.py``), through its user entry points:

1. the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernel from ``pygmu2_tpu_torch/csrc`` (build seconds);
3. the kernel against its plain PyTorch version on the card, at the main
   path's shapes (P=128, N=1024, B=130): rows of the small-font and the
   large-font 3 s schedules, and a two-segment hand-off of the (4, P)
   state; max abs error <= 1e-4 (peaks are ~11);
4. end to end, ``wire="int16"``: the 3 s chord through the small and the
   large font (``render_midi_offline``) and the 60 s piece through the
   large font (``render_midi_offline_streamed``). Each must launch the
   kernel, come out finite and not silent, and match the same render with
   the plain version on the card within 1e-4 (f32 wire). Realtime factors
   after warm-up, by wall clock and by CUDA events, beside the plain
   version's.

Prints a JSON line of per-kernel results, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, before any result, on
any failure or where no CUDA device is present. Imports no JAX.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

SR = 44100
TOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from pygmu2_tpu_torch import _ext, bench_workload
    from pygmu2_tpu_torch.soundfont import MidiFile
    from pygmu2_tpu_torch.soundfont import filter_kernels as fk
    from pygmu2_tpu_torch.soundfont import offline as off
    from pygmu2_tpu_torch.soundfont.convert import schedule_to_torch, to_torch

    kernel = fk.osc_filter_gain_mix
    dev = torch.device("cuda", 0)

    @contextlib.contextmanager
    def plain_audio_pass():
        """Renders inside take the kernel's plain version, on the card."""
        fk.osc_filter_gain_mix = fk.osc_filter_gain_mix_ref
        try:
            yield
        finally:
            fk.osc_filter_gain_mix = kernel

    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    _ext.load()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernel vs plain at the main path's shapes ----
    def bench_rows(large: bool):
        synth, midi = bench_workload.build_workload(large)
        par, ch, snap, _nb = synth.build_schedule(midi, 3.0)
        planes, flags = schedule_to_torch(par, ch, snap, dev)
        ctrl = off._control_device(
            *planes, synth.block_size, flags,
            int(synth._minimum_voice_duration), float(synth.sample_rate),
        )
        wave = to_torch(synth._wave, dev)
        rows = dict(
            off._gain_rows(ctrl, synth.master_volume), **off._osc_rows(ctrl, wave)
        )
        synth.reset()
        return rows, wave, synth.block_size

    def device_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    max_err = 0.0
    timings = {}
    for large in (False, True):
        name = "large" if large else "small"
        rows, wave, N = bench_rows(large)
        B, P = rows["ratio"].shape
        out, st = kernel(rows, wave, N)
        torch.cuda.synchronize()
        ref, st_ref = fk.osc_filter_gain_mix_ref(rows, wave, N)
        err = max((out - ref).abs().max().item(), (st - st_ref).abs().max().item())
        peak = ref.abs().max().item()
        print(f"kernel vs plain, {name} font (B={B} P={P} N={N}): "
              f"max abs err {err:.3g} (peak {peak:.3g})")
        check(torch.isfinite(out).all().item() and peak > 1.0, f"{name}: degenerate")
        check(err <= TOL, f"{name} font: kernel disagrees with plain ({err})")
        max_err = max(max_err, err)
        k_ms = device_ms(lambda: kernel(rows, wave, N), 20)
        p_ms = device_ms(lambda: fk.osc_filter_gain_mix_ref(rows, wave, N), 5)
        timings[name] = (k_ms, p_ms)
        print(f"  {name} font: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"per 3 s call [{card}]")
        if large:  # streamed hand-off of the (4, P) state
            cut = B // 2
            o1, s1 = kernel({k: v[:cut] for k, v in rows.items()}, wave, N)
            o2, s2 = kernel({k: v[cut:] for k, v in rows.items()}, wave, N, s1)
            torch.cuda.synchronize()
            err = max((torch.cat([o1, o2]) - ref).abs().max().item(),
                      (s2 - st_ref).abs().max().item())
            print(f"  two-segment state hand-off vs plain one call: {err:.3g}")
            check(err <= TOL, f"state hand-off disagrees ({err})")
            max_err = max(max_err, err)

    # ---- 4. end to end through the entry points ----
    def workload(large: bool, repeats: int):
        synth, _midi = bench_workload.build_workload(large)
        return synth, MidiFile(bench_workload.build_midi_bytes(repeats=repeats))

    cases = [
        ("3 s chord, small font", False, 1, 3.0, off.render_midi_offline),
        ("3 s chord, large font", True, 1, 3.0, off.render_midi_offline),
        ("60 s piece, large font, streamed", True, 15, 60.0,
         off.render_midi_offline_streamed),
    ]
    kernel.launches = 0  # the main path's run starts here
    per_case = []
    for label, large, repeats, seconds, render in cases:
        synth, midi = workload(large, repeats)
        before = kernel.launches
        pcm = render(synth, midi, seconds, wire="int16", device=dev)
        torch.cuda.synchronize()
        per_case.append(kernel.launches - before)
        check(pcm.dtype == np.int16 and pcm.shape == (int(round(seconds * SR)), 2),
              f"{label}: output {pcm.dtype} {pcm.shape}")
        check(np.abs(pcm.astype(np.int32)).max() > 0, f"{label}: silent")
        check(per_case[-1] > 0, f"{label}: the kernel was not launched")
    launches = kernel.launches

    for (label, large, repeats, seconds, render), n in zip(cases, per_case):
        synth, midi = workload(large, repeats)
        got = render(synth, midi, seconds, wire="f32", device=dev)
        with plain_audio_pass():
            ref = render(synth, midi, seconds, wire="f32", device=dev)
        check(np.isfinite(got).all() and np.abs(got).max() > 0.01,
              f"{label}: not finite or silent")
        err = float(np.abs(got - ref).max())
        check(err <= TOL, f"{label}: kernel render vs plain render {err}")
        max_err = max(max_err, err)

        def timed(plain: bool):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            ctx = plain_audio_pass() if plain else contextlib.nullcontext()
            with ctx:
                t = time.perf_counter()
                start.record()
                render(synth, midi, seconds, wire="int16", device=dev)
                end.record()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            return wall, start.elapsed_time(end) / 1e3

        timed(False)  # warm-up
        k_wall, k_ev = min((timed(False) for _ in range(3)), key=lambda x: x[0])
        p_wall, p_ev = timed(True)
        print(f"{label}: {n} kernel launches; max abs err vs plain {err:.3g}; "
              f"realtime x{seconds / k_wall:.1f} wall ({k_wall * 1e3:.1f} ms), "
              f"x{seconds / k_ev:.1f} by CUDA events ({k_ev * 1e3:.1f} ms); "
              f"plain x{seconds / p_wall:.1f} wall ({p_wall * 1e3:.1f} ms), "
              f"x{seconds / p_ev:.1f} events [{card}]")

    k_ms, p_ms = timings["large"]
    print(json.dumps({"kernels": [{
        "name": "osc_filter_gain_mix",
        "route": "cuda",
        "source": "pygmu2_tpu_torch/csrc/osc_filter_gain_mix.cu",
        "replaces": "pygmu2_tpu/soundfont/filter_pallas.py:725 "
                    "(and the windowed variant at :624)",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
