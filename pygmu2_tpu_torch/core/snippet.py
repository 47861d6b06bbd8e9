"""Audio block container.

Copy of ``pygmu2_tpu.core.snippet`` (numpy only), itself a rebuild of
rdpoor/pygmu2's Snippet (reference:
src/pygmu2/snippet.py:14-109). A Snippet is the *host-side* view of one
rendered block: ``(samples, channels)`` float32, starting at an absolute
sample index. On the device the same block is a torch tensor — Snippet is the
boundary type the renderer hands to user code / file writers.
"""

from __future__ import annotations

import numpy as np


class Snippet:
    """``(samples, channels)`` float32 block anchored at ``start``.

    1-D input data is promoted to ``(N, 1)``. Data is normalized to float32.
    Treat ``data`` as immutable: blocks may alias device buffers.
    """

    __slots__ = ("_start", "_data")

    def __init__(self, start: int, data):
        arr = np.asarray(data)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        elif arr.ndim != 2:
            raise ValueError(f"data must be 1D or 2D, got {arr.ndim}D")
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32, copy=False)
        self._start = int(start)
        self._data = arr

    @property
    def start(self) -> int:
        return self._start

    @property
    def end(self) -> int:
        return self._start + self._data.shape[0]

    @property
    def duration(self) -> int:
        return self._data.shape[0]

    @property
    def channels(self) -> int:
        return self._data.shape[1]

    @property
    def data(self) -> np.ndarray:
        """Underlying array (not a copy) — treat as immutable."""
        return self._data

    @classmethod
    def from_zeros(cls, start: int, duration: int, channels: int = 1) -> "Snippet":
        """A silent block of the given shape."""
        return cls(start, np.zeros((duration, channels), dtype=np.float32))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Snippet):
            return NotImplemented
        return (
            self._start == other._start
            and self._data.shape == other._data.shape
            and np.allclose(self._data, other._data)
        )

    def __repr__(self) -> str:
        return (
            f"Snippet(start={self._start}, duration={self.duration}, "
            f"channels={self.channels})"
        )
