"""Render diagnostics: pull counts and per-PE timings.

Copy of ``pygmu2_tpu.core.diagnostics`` (stdlib only), itself a rebuild of
the reference diagnostics module (reference: src/pygmu2/diagnostics.py:23-129).
"Pulls" are *host-level* ``render()`` calls, and per-block timing measures
the whole graph's render of one block.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from pygmu2_tpu_torch.core.processing_element import ProcessingElement

_local = threading.local()


def _st():
    if not hasattr(_local, "enabled"):
        _local.enabled = False
        _local.pull_counts = {}
        _local.timings = {}
        _local.track_pulls = True
        _local.track_timing = True
    return _local


def enable(pull_counts: bool = True, timing: bool = True) -> None:
    """Turn on diagnostics for the current thread."""
    st = _st()
    st.enabled = True
    st.track_pulls = pull_counts
    st.track_timing = timing
    st.pull_counts = {}
    st.timings = {}


def disable() -> None:
    st = _st()
    st.enabled = False
    st.pull_counts = {}
    st.timings = {}


def is_enabled() -> bool:
    return _st().enabled


def pull_count_enabled() -> bool:
    return _st().track_pulls


def timing_enabled() -> bool:
    return _st().track_timing


def record_pull(pe: "ProcessingElement") -> None:
    st = _st()
    key = repr_key(pe)
    st.pull_counts[key] = st.pull_counts.get(key, 0) + 1


def record_timing(pe: "ProcessingElement", elapsed_ns: int) -> None:
    st = _st()
    key = repr_key(pe)
    total, count = st.timings.get(key, (0, 0))
    st.timings[key] = (total + elapsed_ns, count + 1)


def repr_key(pe) -> str:
    return f"{type(pe).__name__}#{pe._uid}"


def get_block_report() -> str:
    """Human-readable summary of pulls and timings since enable()."""
    st = _st()
    lines = ["diagnostics report:"]
    if st.pull_counts:
        lines.append("  pulls:")
        for key, n in sorted(st.pull_counts.items()):
            lines.append(f"    {key}: {n}")
    if st.timings:
        lines.append("  timings (ms):")
        for key, (total, count) in sorted(st.timings.items()):
            lines.append(
                f"    {key}: total={total / 1e6:.3f} count={count} "
                f"avg={total / max(count, 1) / 1e6:.3f}"
            )
    return "\n".join(lines)


def reset() -> None:
    st = _st()
    st.pull_counts = {}
    st.timings = {}


class timed:
    """Context manager measuring wall time in ns."""

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.elapsed_ns = time.perf_counter_ns() - self.t0
        return False
