"""Where a render's time goes on one CUDA card:
``python -m pygmu2_tpu_torch.profile_pe [name ...]``.

Renders the workloads of ``patch_workload`` (the patch for 60 s, the bank
for 10 s), ``fx_workload`` (the chain for 60 s, the fx bank for 10 s) and
``filter_workload`` (the filter bank for 10 s) through ``render_to_array``,
and the SoundFont workloads of ``bench_workload`` (``sf_small``,
``sf_large``: the 3 s chord through ``render_midi_offline``; ``sf_60``: the
60 s piece through the large font, ``render_midi_offline_streamed``), or
the ones named, on the card, after a warm-up render of the same workload:
the untraced wall time (median of 3, host clock around a render that ends
in a synchronize), then one render under ``torch.profiler``. Prints one
JSON line per workload with the device busy time (device-side events
only: kernels and copies), the idle share against the traced wall, and
the largest device items by name.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import pygmu2_tpu_torch as pg
from pygmu2_tpu_torch import bench_workload, filter_workload, fx_workload, patch_workload


def _graph(build):
    """A PE-graph workload: (seconds) -> a render function."""
    def make(seconds, dev):
        graph = build(seconds)
        return lambda: pg.render_to_array(graph, device=dev)
    return make


def _soundfont(large, repeats, streamed):
    """A SoundFont workload: (seconds) -> a render function."""
    def make(seconds, dev):
        from pygmu2_tpu_torch.soundfont import MidiFile
        from pygmu2_tpu_torch.soundfont import offline as off

        synth, _ = bench_workload.build_workload(large)
        data = bench_workload.build_midi_bytes(repeats=repeats)
        render = off.render_midi_offline_streamed if streamed else off.render_midi_offline
        return lambda: render(synth, MidiFile(data), seconds, wire="int16", device=dev)
    return make


def _timed(render) -> float:
    t = time.perf_counter()
    render()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_pe: needs a CUDA device")
    dev = torch.device("cuda", 0)
    workloads = {
        "patch": (60.0, _graph(lambda s: patch_workload.build_patch(pg, s))),
        "bank": (10.0, _graph(lambda s: patch_workload.build_bank(pg, s, seed=0))),
        "chain": (60.0, _graph(lambda s: fx_workload.build_chain(pg, s))),
        "fx_bank": (10.0, _graph(lambda s: fx_workload.build_fx_bank(pg, s, seed=0))),
        "filter_bank": (10.0, _graph(lambda s: filter_workload.build_filter_bank(pg, s, seed=0))),
        "sf_small": (3.0, _soundfont(False, 1, streamed=False)),
        "sf_large": (3.0, _soundfont(True, 1, streamed=False)),
        "sf_60": (60.0, _soundfont(True, 15, streamed=True)),
    }
    for label in sys.argv[1:] or workloads:
        seconds, make = workloads[label]
        render = make(seconds, dev)
        _timed(render)  # warm-up: kernel build, table upload
        wall = statistics.median(_timed(render) for _ in range(3))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = _timed(render)
        by_name = defaultdict(lambda: [0.0, 0])
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                item = by_name[evt.name]
                item[0] += (evt.time_range.end - evt.time_range.start) / 1e3
                item[1] += 1
        busy = sum(ms for ms, _n in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        print(json.dumps({
            "workload": label,
            "card": torch.cuda.get_device_name(0),
            "audio_s": seconds,
            "wall_ms_median": wall * 1e3,
            "realtime": seconds / wall,
            "traced_wall_ms": traced * 1e3,
            "device_busy_ms": busy,
            "device_ops": sum(n for _ms, n in by_name.values()),
            "idle_share": 1.0 - busy / (traced * 1e3),
            "top": [[name[:60], round(ms, 3), n] for name, (ms, n) in top],
        }))


if __name__ == "__main__":
    main()
