"""ProcessingElement: the public node API of the framework.

Counterpart of ``pygmu2_tpu.core.processing_element`` (reference:
src/pygmu2/processing_element.py:28-363). The user-facing contracts are
the same:

1. ``render(start, duration)`` always returns exactly ``duration`` samples
   starting at ``start``; samples outside ``extent()`` are zero-filled;
   duration==0 yields an empty snippet; duration<0 raises.
2. Extent algebra is host-side and cached at first access.
3. ``is_pure()`` True ⇒ stateless, multi-sink OK; False ⇒ stateful,
   one sink (validated by the Renderer).
4. Input blocks are immutable.
5. ``inputs()`` lists every PE this PE renders.

Subclasses implement ``_trace(ctx)`` returning a ``(ctx.duration, C)``
tensor on ``ctx.device`` (see :mod:`pygmu2_tpu_torch.core.engine`).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from pygmu2_tpu_torch.core import diagnostics, engine
from pygmu2_tpu_torch.core.config import get_sample_rate, handle_error
from pygmu2_tpu_torch.core.extent import Extent
from pygmu2_tpu_torch.core.snippet import Snippet


class ProcessingElement(ABC):
    """Abstract base class for all audio processing nodes.

    Nodes form a DAG; the engine renders it block by block.
    """

    _sample_rate: int | None = None
    _cached_extent: Extent | None = None
    _cached_fills_edges: bool | None = None

    def __new__(cls, *args, **kwargs):
        # The global sample rate must exist before any node is constructed
        # (reference: processing_element.py:51-65).
        sample_rate = get_sample_rate()
        if sample_rate is None:
            raise RuntimeError(
                "Global sample_rate is required but not set. "
                "Call pygmu2_tpu_torch.set_sample_rate(rate) before constructing PEs."
            )
        obj = super().__new__(cls)
        obj._sample_rate = sample_rate
        obj._uid = engine.next_uid()
        obj._eng_state = None
        return obj

    # ---- identity / config ---------------------------------------------

    @property
    def sample_rate(self) -> int | None:
        """Sample rate in Hz (set at construction from the global config)."""
        if self._sample_rate is not None:
            return self._sample_rate
        inferred = None
        for input_pe in self.inputs():
            rate = input_pe.sample_rate
            if rate is None:
                continue
            if inferred is None:
                inferred = rate
            elif inferred != rate:
                handle_error(
                    f"{type(self).__name__}.sample_rate inferred conflicting "
                    f"input rates: {inferred} vs {rate}. Using {inferred}.",
                    fatal=False,
                )
                break
        return inferred

    # ---- rendering ------------------------------------------------------

    def render(self, start: int, duration: int, *, device="cuda") -> Snippet:
        """Generate exactly ``duration`` samples starting at ``start``.

        Samples outside :meth:`extent` are zero-filled. This is the host
        entry point: it renders one block of the graph rooted here on
        ``device`` and returns it on the host.
        """
        if duration < 0:
            raise ValueError(f"duration must be >= 0, got {duration}")
        if diagnostics.is_enabled() and diagnostics.pull_count_enabled():
            diagnostics.record_pull(self)
        if duration == 0:
            channels = self.channel_count()
            return Snippet.from_zeros(start, 0, int(channels or 1))
        if diagnostics.is_enabled() and diagnostics.timing_enabled():
            with diagnostics.timed() as t:
                out = engine.get_program(self, duration, device).run(start)
                np_out = out.cpu().numpy()
            diagnostics.record_timing(self, t.elapsed_ns)
        else:
            out = engine.get_program(self, duration, device).run(start)
            np_out = out.cpu().numpy()
        return Snippet(start, np_out)

    @abstractmethod
    def _trace(self, ctx: "engine.TraceContext"):
        """Build this node's output for the current frame.

        Must return a tensor of shape ``(ctx.duration, channels)`` (or
        ``(ctx.duration,)`` for mono) on ``ctx.device``. Pull inputs with
        ``ctx.pull`` / ``ctx.param``; thread state with ``ctx.state`` /
        ``ctx.set_state``.
        """

    # ---- extent ---------------------------------------------------------

    def extent(self) -> Extent:
        """Temporal bounds (lazily computed once; extents are stable)."""
        if self._cached_extent is None:
            self._cached_extent = self._compute_extent()
        return self._cached_extent

    def _compute_extent(self) -> Extent:
        return Extent(None, None)

    def _xla_select(self):
        """The zeroing select, if any, that ends the JAX package's program of
        this PE with no engine mask after it, as a form for MixPE's
        contraction rule (``models/basic._xla_form``); None here."""
        return None

    def _fills_own_edges(self) -> bool:
        """True when this PE emits meaningful samples outside its extent,
        suppressing the engine's zero mask.

        True for PEs that fill edges themselves (ExtendMode HOLD variants)
        and for ringing PEs (IIR decay tails). The default PROPAGATES from
        inputs: a pass-through parent (gain, mix, …) forwards a ringing
        child's tail instead of re-masking it. PEs that enforce a hard
        boundary (window family with ExtendMode.ZERO) override this.
        """
        if self._cached_fills_edges is None:
            self._cached_fills_edges = any(
                inp._fills_own_edges() for inp in self.inputs()
            )
        return self._cached_fills_edges

    # ---- graph structure ------------------------------------------------

    @abstractmethod
    def inputs(self) -> list["ProcessingElement"]:
        """Every PE this node renders (used for validation and lifecycle)."""

    def is_pure(self) -> bool:
        """True ⇒ arbitrary (start, duration) requests, multi-sink allowed.

        False ⇒ stateful; requests should be contiguous and exactly one
        sink is allowed (enforced by the Renderer's validator). Default
        False — the safe choice for stateful nodes.
        """
        return False

    def state_decays(self) -> bool:
        """True ⇒ this node's carried state converges when re-rendered
        from a fresh state after a finite warm-up (decaying IIR tails,
        envelope followers, finite delay histories). Default False."""
        return False

    def state_affine(self) -> bool:
        """True ⇒ holding this block's inputs fixed, the map
        ``state → (output, new_state)`` is affine in the carried state.
        Default False (nonlinear state)."""
        return False

    def channel_count(self) -> int | None:
        """Fixed output channel count, or None for pass-through."""
        return None

    def required_input_channels(self) -> int | None:
        """Exact channel count required from inputs, or None for any."""
        return None

    def resolve_channel_count(self, input_channel_counts: list[int]) -> int:
        """Output channels when :meth:`channel_count` is None (pass-through)."""
        if input_channel_counts:
            return input_channel_counts[0]
        raise ValueError(
            f"{type(self).__name__} has no inputs but channel_count() is None"
        )

    # ---- lifecycle ------------------------------------------------------

    def on_start(self) -> None:
        """Called by Renderer.start() bottom-up before the first render."""
        self._eng_state = None
        if hasattr(self, "_on_start"):
            self._on_start()

    def on_stop(self) -> None:
        """Called by Renderer.stop() top-down after the final render."""
        if hasattr(self, "_on_stop"):
            self._on_stop()

    def reset_state(self) -> None:
        """Reset carried state so the next render re-initializes it."""
        self._eng_state = None
        if hasattr(self, "_reset_state"):
            self._reset_state()


class SourcePE(ProcessingElement):
    """Base for leaf nodes: no inputs, pure by default, must declare a
    concrete channel count (reference: src/pygmu2/source_pe.py:16-52)."""

    def inputs(self) -> list[ProcessingElement]:
        return []

    def is_pure(self) -> bool:
        return True
