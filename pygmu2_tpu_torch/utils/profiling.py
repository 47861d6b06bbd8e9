"""Device-level profiling helpers (``torch.profiler`` wrappers).

Counterpart of ``pygmu2_tpu.utils.profiling``. Three layers of profiling
exist in the port, coarsest to finest:

1. ``Renderer.enable_profiling()`` — whole-graph wall time, realtime
   ratio (host-side; ``core/renderer.py``).
2. ``pygmu2_tpu_torch.core.diagnostics`` — host-level pull counts and
   per-program timings.
3. This module — kernel-level device traces via ``torch.profiler``,
   written as a Chrome trace (``chrome://tracing`` or
   ``ui.perfetto.dev``).

Typical use::

    import pygmu2_tpu_torch as pg
    from pygmu2_tpu_torch.utils.profiling import trace

    graph = pg.CropPE(pg.BiquadPE(pg.NoisePE(seed=1), 2000.0), 0, 44100)
    with trace("/tmp/pygmu2_trace"):
        pg.render_to_array(graph)

or, for a quick wall-time breakdown without a trace viewer::

    from pygmu2_tpu_torch.utils.profiling import timed
    with timed("render"):
        pg.render_to_array(graph)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from pygmu2_tpu_torch.core.logger import get_logger

logger = get_logger(__name__)

__all__ = ["trace", "timed", "annotate", "block_until_done"]


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_trace: bool = True) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the block (host and, where a
    card is present, its kernels) and write it to ``log_dir`` as
    ``trace.json`` (Chrome trace format; ``create_perfetto_trace=False``
    keeps it in memory only). Yields the profiler, whose
    ``key_averages()`` summarizes the block. Wrap the steady-state part of
    a render: the first render of a graph builds its programs and, on the
    card, loads the kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        block_until_done()
        prof.stop()
        if create_perfetto_trace:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, "trace.json")
            prof.export_chrome_trace(path)
            logger.info("torch.profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label a region so it shows up named in the trace."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def timed(label: str = "region") -> Iterator[None]:
    """Log the wall time of a block, synchronizing the card first.

    The card runs asynchronously: a time taken before its queue drains
    measures the host's enqueue, not the work, so the block is bracketed
    by synchronizations.
    """
    block_until_done()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        block_until_done()
        dt = time.perf_counter() - t0
        logger.info("%s: %.3f ms", label, dt * 1e3)


def block_until_done() -> None:
    """Wait for every queued kernel on every card (a no-op without one)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
