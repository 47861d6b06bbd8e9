"""Where the PE-graph render's time goes on one CUDA card:
``python -m pygmu2_tpu_torch.profile_pe [name ...]``.

Renders the workloads of ``patch_workload`` (the patch for 60 s, the bank
for 10 s), ``fx_workload`` (the chain for 60 s, the fx bank for 10 s) and
``filter_workload`` (the filter bank for 10 s), or the ones named, through
``render_to_array`` on the card, after a warm-up render of the same graph:
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
from pygmu2_tpu_torch import filter_workload, fx_workload, patch_workload


def _render(graph, dev) -> float:
    t = time.perf_counter()
    pg.render_to_array(graph, device=dev)
    torch.cuda.synchronize()
    return time.perf_counter() - t


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_pe: needs a CUDA device")
    dev = torch.device("cuda", 0)
    workloads = {
        "patch": (60.0, lambda s: patch_workload.build_patch(pg, s)),
        "bank": (10.0, lambda s: patch_workload.build_bank(pg, s, seed=0)),
        "chain": (60.0, lambda s: fx_workload.build_chain(pg, s)),
        "fx_bank": (10.0, lambda s: fx_workload.build_fx_bank(pg, s, seed=0)),
        "filter_bank": (10.0, lambda s: filter_workload.build_filter_bank(pg, s, seed=0)),
    }
    for label in sys.argv[1:] or workloads:
        seconds, build = workloads[label]
        graph = build(seconds)
        _render(graph, dev)  # warm-up: kernel build, table upload
        wall = statistics.median(_render(graph, dev) for _ in range(3))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = _render(graph, dev)
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
