"""Temporal bounds algebra.

Copy of ``pygmu2_tpu.core.extent`` (stdlib only), itself a rebuild of
rdpoor/pygmu2's Extent/ExtendMode (reference: src/pygmu2/extent.py:13-205). Semantics preserved exactly:

- half-open ``[start, end)`` in absolute sample indices
- ``None`` bound means infinite in that direction
- empty extents (start == end) are falsy
- ``intersection`` of disjoint extents is an *empty* extent anchored at the
  intersection boundary (max of the two starts), never an error

Extents are host-side Python objects: the graph compiler uses them for
trace-time pruning and for building on-device zero-fill masks.
"""

from __future__ import annotations

import enum
import math


class ExtendMode(enum.Enum):
    """How a PE fills samples requested outside its extent."""

    ZERO = "zero"
    HOLD_FIRST = "hold_first"
    HOLD_LAST = "hold_last"
    HOLD_BOTH = "hold_both"


def _lo(bound: int | None) -> float:
    return -math.inf if bound is None else bound


def _hi(bound: int | None) -> float:
    return math.inf if bound is None else bound


def _as_bound(value: float) -> int | None:
    return None if math.isinf(value) else int(value)


class Extent:
    """Half-open interval ``[start, end)`` of absolute sample indices.

    ``start=None`` means the signal reaches infinitely into the past;
    ``end=None`` means it continues indefinitely.
    """

    __slots__ = ("_start", "_end")

    def __init__(self, start: int | None = None, end: int | None = None):
        if start is not None and end is not None and start > end:
            raise ValueError(
                f"start ({start}) must be less than or equal to end ({end})"
            )
        self._start = start
        self._end = end

    @property
    def start(self) -> int | None:
        return self._start

    @property
    def end(self) -> int | None:
        return self._end

    @property
    def duration(self) -> int | None:
        """Sample count, or None when either bound is infinite."""
        if self._start is None or self._end is None:
            return None
        return self._end - self._start

    def is_empty(self) -> bool:
        """True when both bounds are finite and equal (zero samples)."""
        return self._start is not None and self._start == self._end

    def contains(self, sample_index: int) -> bool:
        """True when ``sample_index`` falls inside the interval."""
        return _lo(self._start) <= sample_index < _hi(self._end)

    def spans(self, start: int, duration: int) -> bool:
        """True when the whole range ``[start, start+duration)`` lies inside."""
        if duration <= 0:
            return True
        return _lo(self._start) <= start and start + duration <= _hi(self._end)

    def intersects(self, other: "Extent") -> bool:
        """True when the two intervals overlap by at least one sample."""
        if self.is_empty() or other.is_empty():
            return False
        return max(_lo(self._start), _lo(other._start)) < min(
            _hi(self._end), _hi(other._end)
        )

    def intersection(self, other: "Extent") -> "Extent":
        """Overlap of the two intervals.

        Disjoint (or empty) operands yield an empty extent anchored at the
        boundary — this keeps idioms like
        ``extent = extent.intersection(other) or extent`` working.
        """
        if self.is_empty():
            return Extent(self._start, self._start)
        if other.is_empty():
            return Extent(other._start, other._start)
        lo = max(_lo(self._start), _lo(other._start))
        hi = min(_hi(self._end), _hi(other._end))
        if lo > hi:
            anchor = _as_bound(lo)
            return Extent(anchor, anchor)
        return Extent(_as_bound(lo), _as_bound(hi))

    def union(self, other: "Extent") -> "Extent":
        """Smallest extent containing both intervals (empty operands ignored)."""
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        lo = min(_lo(self._start), _lo(other._start))
        hi = max(_hi(self._end), _hi(other._end))
        return Extent(_as_bound(lo), _as_bound(hi))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Extent):
            return NotImplemented
        return self._start == other._start and self._end == other._end

    def __hash__(self) -> int:
        return hash((self._start, self._end))

    def __bool__(self) -> bool:
        """Empty extents are falsy."""
        return not self.is_empty()

    def __repr__(self) -> str:
        lo = "-∞" if self._start is None else str(self._start)
        hi = "+∞" if self._end is None else str(self._end)
        return f"Extent({lo}, {hi})"
