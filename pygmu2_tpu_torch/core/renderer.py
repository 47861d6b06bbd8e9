"""Renderer: graph validation, lifecycle, block-render driver, profiling.

Counterpart of ``pygmu2_tpu.core.renderer`` (reference:
src/pygmu2/renderer.py:130-562, null_renderer.py:13-33). Validation and
lifecycle semantics are the same; a Renderer renders on one ``device``
(default ``"cuda"``), and ``render_extent`` renders a whole timeline
through :func:`pygmu2_tpu_torch.core.engine.render_scan`.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field

from pygmu2_tpu_torch.core import engine
from pygmu2_tpu_torch.core.config import handle_error
from pygmu2_tpu_torch.core.processing_element import ProcessingElement
from pygmu2_tpu_torch.core.snippet import Snippet


@dataclass
class PEProfile:
    """Per-node profiling record."""

    pe_class: str
    pe_id: int
    render_count: int = 0
    total_time_ns: int = 0
    total_samples: int = 0
    min_time_ns: int = 0
    max_time_ns: int = 0

    @property
    def total_time_ms(self) -> float:
        return self.total_time_ns / 1e6

    @property
    def avg_time_ms(self) -> float:
        return self.total_time_ms / self.render_count if self.render_count else 0.0

    @property
    def samples_per_second(self) -> float:
        if self.total_time_ns == 0:
            return 0.0
        return self.total_samples / (self.total_time_ns / 1e9)

    def realtime_ratio(self, sample_rate: int = 44100) -> float:
        if self.total_time_ns == 0:
            return 0.0
        return (self.total_samples / sample_rate) * 1e9 / self.total_time_ns


@dataclass
class ProfileReport:
    """Aggregated profiling across a render session.

    Whole-graph time is attributed to the root, as in the reference
    (renderer.py:539-556): per-node device time is not split out here —
    use ``torch.profiler`` for kernel-level traces.
    """

    pe_profiles: dict[int, PEProfile] = field(default_factory=dict)
    total_render_time_ns: int = 0
    total_output_time_ns: int = 0
    total_samples: int = 0
    render_calls: int = 0

    def add_pe_timing(self, pe: ProcessingElement, time_ns: int, samples: int) -> None:
        pe_id = id(pe)
        prof = self.pe_profiles.get(pe_id)
        if prof is None:
            prof = PEProfile(
                pe_class=type(pe).__name__,
                pe_id=pe_id,
                min_time_ns=time_ns,
                max_time_ns=time_ns,
            )
            self.pe_profiles[pe_id] = prof
        prof.render_count += 1
        prof.total_time_ns += time_ns
        prof.total_samples += samples
        prof.min_time_ns = min(prof.min_time_ns, time_ns)
        prof.max_time_ns = max(prof.max_time_ns, time_ns)

    def summary(self, sample_rate: int = 44100) -> str:
        lines = [
            "=" * 70,
            "RENDER PROFILE REPORT",
            "=" * 70,
            f"Total render calls: {self.render_calls}",
            f"Total samples: {self.total_samples:,}",
            f"Total render time: {self.total_render_time_ns / 1e6:.2f} ms",
            f"Total output time: {self.total_output_time_ns / 1e6:.2f} ms",
        ]
        if self.total_render_time_ns > 0:
            ratio = (self.total_samples / sample_rate) * 1e9 / self.total_render_time_ns
            lines.append(f"Realtime ratio: {ratio:.1f}x (>1.0x is faster than realtime)")
        lines += [
            "",
            "PER-PE BREAKDOWN (sorted by total time):",
            "-" * 70,
            f"{'PE Class':<20} {'Calls':>8} {'Total ms':>10} {'Avg ms':>10} {'Samples/s':>12}",
            "-" * 70,
        ]
        for prof in sorted(
            self.pe_profiles.values(), key=lambda p: p.total_time_ns, reverse=True
        ):
            lines.append(
                f"{prof.pe_class:<20} {prof.render_count:>8} "
                f"{prof.total_time_ms:>10.2f} {prof.avg_time_ms:>10.4f} "
                f"{prof.samples_per_second:>12,.0f}"
            )
        lines.append("=" * 70)
        return "\n".join(lines)


class Renderer(ABC):
    """Drives a validated PE graph and hands blocks to ``_output``.

    Lifecycle: ``set_source`` (validate) → ``start`` (on_start bottom-up)
    → ``render`` blocks → ``stop`` (on_stop top-down).
    """

    def __init__(self, sample_rate: int = 44100, device="cuda"):
        self._sample_rate = sample_rate
        self._device = device
        self._source: ProcessingElement | None = None
        self._channel_count: int | None = None
        self._started = False
        self._profiling = False
        self._profile_report: ProfileReport | None = None
        self._pe_list: list[ProcessingElement] = []

    # ---- properties ------------------------------------------------------

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    @property
    def source(self) -> ProcessingElement | None:
        return self._source

    @property
    def channel_count(self) -> int | None:
        return self._channel_count

    @property
    def started(self) -> bool:
        return self._started

    @property
    def profiling(self) -> bool:
        return self._profiling

    # ---- profiling -------------------------------------------------------

    def enable_profiling(self) -> None:
        self._profiling = True
        self._profile_report = ProfileReport()

    def disable_profiling(self) -> None:
        self._profiling = False

    def get_profile_report(self) -> ProfileReport | None:
        return self._profile_report

    def print_profile_report(self) -> None:
        if self._profile_report is None:
            print("No profile data available. Call enable_profiling() first.")
            return
        print(self._profile_report.summary(self._sample_rate))

    # ---- lifecycle -------------------------------------------------------

    def set_source(self, source: ProcessingElement) -> None:
        """Set and validate the graph (purity multi-sink rule, channels)."""
        if self._started:
            if handle_error("Cannot set source while started. Call stop() first."):
                return
        self._channel_count = self._validate_graph(source)
        self._source = source
        self._pe_list = self._collect_pes(source)

    def start(self) -> None:
        """Call on_start bottom-up; must have a source."""
        if self._source is None:
            handle_error("No source set. Call set_source() first.", fatal=True)
            return
        if self._started:
            if handle_error("Already started. Call stop() first."):
                return
        started: set[int] = set()

        def go(pe: ProcessingElement) -> None:
            if id(pe) in started:
                return
            started.add(id(pe))
            for inp in pe.inputs():
                go(inp)
            pe.on_start()

        go(self._source)
        self._started = True

    def stop(self) -> None:
        """Call on_stop top-down; idempotent."""
        if not self._started:
            return
        if self._source is not None:
            stopped: set[int] = set()

            def go(pe: ProcessingElement) -> None:
                if id(pe) in stopped:
                    return
                stopped.add(id(pe))
                pe.on_stop()
                for inp in pe.inputs():
                    go(inp)

            go(self._source)
        self._started = False

    def render(self, start: int, duration: int) -> None:
        """Render one block from the source and hand it to ``_output``."""
        if self._source is None:
            handle_error("No source set. Call set_source() first.", fatal=True)
            return
        if not self._started:
            handle_error("Not started. Call start() first.", fatal=True)
            return
        if duration < 1:
            handle_error(
                "Renderer.render() requires duration >= 1 to prevent infinite loops.",
                fatal=True,
                exception_class=ValueError,
            )
            return
        if self._profiling and self._profile_report is not None:
            report = self._profile_report
            report.render_calls += 1
            report.total_samples += duration
            t0 = time.perf_counter_ns()
            snippet = self._source.render(start, duration, device=self._device)
            dt = time.perf_counter_ns() - t0
            report.total_render_time_ns += dt
            report.add_pe_timing(self._source, dt, duration)
            t0 = time.perf_counter_ns()
            self._output(snippet)
            report.total_output_time_ns += time.perf_counter_ns() - t0
        else:
            self._output(self._source.render(start, duration, device=self._device))

    def render_extent(self, start: int, total: int, block: int = 16384) -> Snippet:
        """Render ``[start, start+total)`` block by block in one call.

        Returns the rendered Snippet (also passed to ``_output``).
        """
        if self._source is None:
            handle_error("No source set. Call set_source() first.", fatal=True)
        if not self._started:
            handle_error("Not started. Call start() first.", fatal=True)
        out = engine.render_scan(self._source, start, total, block, device=self._device)
        snippet = Snippet(start, out.cpu().numpy())
        self._output(snippet)
        return snippet

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        return False

    @abstractmethod
    def _output(self, snippet: Snippet) -> None:
        """Deliver one rendered block to the destination."""

    # ---- graph utilities -------------------------------------------------

    def _validate_graph(
        self, pe: ProcessingElement, seen: dict[int, int] | None = None
    ) -> int:
        """DFS validation: impure multi-sink rejected; channels resolved."""
        if seen is None:
            seen = {}
        pe_id = id(pe)
        if pe_id in seen:
            if not pe.is_pure():
                raise ValueError(
                    f"{type(pe).__name__} is not pure but has multiple sinks. "
                    f"Stateful PEs can only connect to one downstream PE."
                )
            return seen[pe_id]

        input_channel_counts = [
            self._validate_graph(inp, seen) for inp in pe.inputs()
        ]

        required = pe.required_input_channels()
        if required is not None:
            for i, actual in enumerate(input_channel_counts):
                if actual != required:
                    raise ValueError(
                        f"{type(pe).__name__} requires {required} channel(s), "
                        f"but {type(pe.inputs()[i]).__name__} outputs {actual}"
                    )

        output = pe.channel_count()
        if output is None:
            if not input_channel_counts:
                raise ValueError(
                    f"{type(pe).__name__} has no inputs but channel_count() is None"
                )
            output = pe.resolve_channel_count(input_channel_counts)

        seen[pe_id] = output
        return output

    def _collect_pes(self, root: ProcessingElement) -> list[ProcessingElement]:
        """All nodes bottom-up (inputs before outputs)."""
        return engine._walk(root)


class NullRenderer(Renderer):
    """Discards output — benchmarking, tests, and side-effect sinks."""

    def _output(self, snippet: Snippet) -> None:
        pass
