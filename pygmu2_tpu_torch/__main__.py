"""CLI entry: quick environment / speed check.

Usage: python -m pygmu2_tpu_torch [seconds] [--device DEVICE]

Renders the hello-sine graph (a 440 Hz sine at half amplitude) on the
card (``--device cpu`` for the CPU) and reports the realtime factor of a
warm render, with the card's name and power limit beside it.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else "nvidia-smi: no card"


def main(argv=None) -> int:
    import numpy as np
    import torch

    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch.core import engine

    parser = argparse.ArgumentParser(prog="python -m pygmu2_tpu_torch")
    parser.add_argument("seconds", nargs="?", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to render on the CPU", file=sys.stderr)
        return 1
    pg.set_sample_rate(44100)
    total = int(args.seconds * 44100)
    graph = pg.CropPE(pg.GainPE(pg.SinePE(frequency=440.0), 0.5), 0, total)

    def render():
        out = engine.render_scan(graph, 0, total, 16384, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out

    render()  # warm-up: programs built, kernels loaded
    engine.reset_graph_states(graph)
    t0 = time.perf_counter()
    out = render()
    wall = time.perf_counter() - t0
    peak = float(np.abs(out.cpu().numpy()).max())
    card = card_name_and_power_limit() if device.type == "cuda" else "cpu"
    print(
        f"pygmu2_tpu_torch {pg.__version__} | torch {torch.__version__} | "
        f"device={device} ({card}) | {args.seconds:.1f}s rendered in "
        f"{wall * 1e3:.2f} ms ({args.seconds / wall:.0f}x realtime) | peak={peak:.3f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
