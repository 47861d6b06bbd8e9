"""Basic sources and pure transforms (counterpart of ``pygmu2_tpu.models.basic``).

Reference file:line for parity:
- ConstantPE  (src/pygmu2/constant_pe.py:15)
- IdentityPE  (src/pygmu2/identity_pe.py:15)
- DiracPE     (src/pygmu2/dirac_pe.py:15)
- ArrayPE     (src/pygmu2/array_pe.py:17)
- GainPE      (src/pygmu2/gain_pe.py:16)
- MixPE       (src/pygmu2/mix_pe.py:16)
- TransformPE (src/pygmu2/transform_pe.py:21)

All pure: functions of the absolute sample index.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent, ExtendMode
from pygmu2_tpu_torch.core.processing_element import ProcessingElement, SourcePE
from pygmu2_tpu_torch.ops import xla_math


class ConstantPE(SourcePE):
    """Constant value on N channels, infinite extent."""

    def __init__(self, value: float, channels: int = 1):
        self._value = value
        self._channels = channels

    @property
    def value(self) -> float:
        return self._value

    def channel_count(self) -> int:
        return self._channels

    def _trace(self, ctx):
        return torch.full(
            (ctx.duration, self._channels), float(self._value),
            dtype=prec.AUDIO, device=ctx.device,
        )

    def __repr__(self) -> str:
        return f"ConstantPE(value={self._value}, channels={self._channels})"


class ParamPE(SourcePE):
    """Named runtime-bindable parameter source.

    Reads its value from the ``bindings`` dict passed to the render call
    (``engine.render_scan`` / ``render_to_array``); unbound renders produce
    ``default``. Accepts any PE parameter slot that takes
    ``float | ProcessingElement``. Pure: safe to share across consumers.
    """

    def __init__(self, name: str, default: float = 0.0, channels: int = 1):
        if not name:
            raise ValueError("ParamPE needs a non-empty name")
        self._name = str(name)
        self._default = float(default)
        self._channels = int(channels)

    @property
    def name(self) -> str:
        return self._name

    @property
    def default(self) -> float:
        return self._default

    def channel_count(self) -> int:
        return self._channels

    def _trace(self, ctx):
        val = torch.atleast_1d(ctx.binding(self._name, self._default))
        if val.shape[0] not in (1, self._channels):
            raise ValueError(
                f"binding {self._name!r} has {val.shape[0]} values for "
                f"{self._channels} channels"
            )
        return val[None, :].expand(ctx.duration, self._channels)

    def __repr__(self) -> str:
        return (
            f"ParamPE(name={self._name!r}, default={self._default}, "
            f"channels={self._channels})"
        )


class IdentityPE(SourcePE):
    """Outputs its own absolute sample index — the canonical test signal."""

    def __init__(self, channels: int = 1):
        self._channels = channels

    def channel_count(self) -> int:
        return self._channels

    def _trace(self, ctx):
        t = ctx.times(prec.AUDIO)
        return t[:, None].repeat(1, self._channels)

    def __repr__(self) -> str:
        return f"IdentityPE(channels={self._channels})"


class DiracPE(SourcePE):
    """Unit impulse: 1.0 at sample 0, 0.0 elsewhere."""

    def __init__(self, channels: int = 1):
        self._channels = channels

    def channel_count(self) -> int:
        return self._channels

    def _trace(self, ctx):
        hit = (ctx.times() == 0).to(prec.AUDIO)
        return hit[:, None].repeat(1, self._channels)

    def __repr__(self) -> str:
        return f"DiracPE(channels={self._channels})"


class ArrayPE(SourcePE):
    """Plays a fixed array anchored at t=0; edges follow ``extend_mode``.

    The table is uploaded to a device once, at its first render there.
    """

    def __init__(self, data, extend_mode: ExtendMode = ExtendMode.ZERO):
        arr = np.asarray(data, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        elif arr.ndim > 2:
            raise ValueError(f"ArrayPE data must be 1D or 2D, got {arr.ndim}D")
        if arr.shape[0] == 0:
            raise ValueError("ArrayPE data cannot be empty")
        self._data = arr
        self._extend_mode = extend_mode
        self._tables: dict[torch.device, torch.Tensor] = {}

    @property
    def data(self) -> np.ndarray:
        return self._data

    def channel_count(self) -> int:
        return self._data.shape[1]

    def _compute_extent(self) -> Extent:
        return Extent(0, self._data.shape[0])

    def _fills_own_edges(self) -> bool:
        return self._extend_mode != ExtendMode.ZERO

    def _xla_select(self):
        """The zeroing select that ends the JAX package's program of this PE
        with no engine mask after it (HOLD_LAST zeroes t < 0, HOLD_FIRST
        t >= n), as a form for MixPE's contraction rule; else None. LLVM
        hoists a scalar gain's product into such a select's arms, so the
        product reaches a sum selected, as a masked one does (see
        ``_xla_form``)."""
        if self._extend_mode == ExtendMode.HOLD_LAST:
            return ("t < 0",)
        if self._extend_mode == ExtendMode.HOLD_FIRST:
            return ("t >= n", self._data.shape[0])
        return None

    def _table(self, device: torch.device) -> torch.Tensor:
        table = self._tables.get(device)
        if table is None:
            table = torch.from_numpy(self._data).to(device)
            self._tables[device] = table
        return table

    def _trace(self, ctx):
        table = self._table(ctx.device)
        n = table.shape[0]
        t = ctx.times()
        out = table[t.clamp(0, n - 1)]
        mode = self._extend_mode
        if mode in (ExtendMode.ZERO, ExtendMode.HOLD_LAST):
            out = torch.where((t < 0)[:, None], 0.0, out)
        if mode in (ExtendMode.ZERO, ExtendMode.HOLD_FIRST):
            out = torch.where((t >= n)[:, None], 0.0, out)
        return out

    def __repr__(self) -> str:
        extra = (
            f", extend_mode={self._extend_mode.value}"
            if self._extend_mode != ExtendMode.ZERO
            else ""
        )
        return f"ArrayPE(shape={self._data.shape}{extra})"


class GainPE(ProcessingElement):
    """Multiply the source by a scalar or a (possibly multichannel) control PE.

    A mono gain PE broadcasts across all source channels. Extent is the
    source extent, intersected with the gain's extent when it is a PE.
    """

    def __init__(self, source: ProcessingElement, gain=1.0):
        self._source = source
        self._gain = gain
        self._gain_is_pe = isinstance(gain, ProcessingElement)

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def gain(self):
        return self._gain

    def inputs(self) -> list[ProcessingElement]:
        return [self._source, self._gain] if self._gain_is_pe else [self._source]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        ext = self._source.extent()
        if self._gain_is_pe:
            ext = ext.intersection(self._gain.extent())
        return ext

    def _trace(self, ctx):
        x = ctx.pull(self._source)
        if self._gain_is_pe:
            g = ctx.param(self._gain, multichannel=True)  # (N,1) broadcasts over channels
        else:
            g = float(np.float32(self._gain))
        ctx.keep_factors(x, g)  # a MixPE may add the product unrounded
        return x * g

    def _xla_select(self):
        """A scalar gain's product is hoisted into its source's zeroing
        select (``ArrayPE._xla_select``); a control gain's is not."""
        return None if self._gain_is_pe else self._source._xla_select()

    def __repr__(self) -> str:
        g = f"{type(self._gain).__name__}(...)" if self._gain_is_pe else str(self._gain)
        return f"GainPE(source={type(self._source).__name__}, gain={g})"


class MixPE(ProcessingElement):
    """Sum of N inputs; extent is the union of input extents.

    All inputs must share a channel count (validated by the Renderer).
    Inputs whose extent misses the request are pruned by the engine.
    """

    def __init__(self, *inputs: ProcessingElement):
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
            inputs = tuple(inputs[0])
        if len(inputs) < 2:
            raise ValueError("MixPE requires at least 2 inputs")
        self._inputs = list(inputs)

    def inputs(self) -> list[ProcessingElement]:
        return self._inputs

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._inputs[0].channel_count()

    def resolve_channel_count(self, input_channel_counts: list[int]) -> int:
        if not input_channel_counts:
            raise ValueError("MixPE has no inputs")
        first = input_channel_counts[0]
        for i, count in enumerate(input_channel_counts[1:], start=2):
            if count != first:
                raise ValueError(
                    f"MixPE input channel mismatch: input 1 has {first} "
                    f"channels, input {i} has {count} channels"
                )
        return first

    def _compute_extent(self) -> Extent:
        ext = self._inputs[0].extent()
        for inp in self._inputs[1:]:
            ext = ext.union(inp.extent())
        return ext

    def _trace(self, ctx):
        # The JAX package's render is XLA's CPU program, which contracts a
        # product whose one use is a sum into one fused multiply-add
        # (ops/xla_math.fmaf here): an input GainPE that feeds nothing else
        # is added with its product unrounded where the program holds both
        # operands of the sum in a form LLVM can fuse (_fuses). Left to
        # right, as XLA sums; where both operands are fusable products, the
        # left one fuses and the right one is rounded. Inside this PE's own
        # mask, LLVM drops an input's mask that is the same one. A zeroing
        # select that ends an input's own program counts as its mask
        # (_xla_select).
        total = first = form = None  # the running sum, the first input's factors, the form
        own = _xla_form(self)
        for i, inp in enumerate(self._inputs, start=1):
            x = ctx.pull(inp)
            if total is not None and x.shape[1] != total.shape[1]:
                # channel_count() reports the first input, so the static
                # validator cannot see a mismatch; broadcasting would mix
                # (N,1)+(N,2) silently (reference mix_pe.py:24-25).
                raise ValueError(
                    f"MixPE input channel mismatch: input 1 has "
                    f"{total.shape[1]} channels, input {i} has {x.shape[1]}"
                )
            fac = ctx.factors_of(inp)
            f = _xla_form(inp)
            if isinstance(own, Extent) and f == own:
                f = None
            if total is None:
                total, first, form = x, fac, f
                continue
            if first is not None:  # the first input's product, unrounded
                if _fuses(form, f):
                    total = _fused(first, x)
                elif fac is not None and _fuses(f, form):
                    total = _fused(fac, total)
                else:
                    total = total + x
                first = None
            elif fac is not None and _fuses(f, form):
                total = _fused(fac, total)
            else:
                total = total + x
            form = _merged(form, f)
        return total

    def __repr__(self) -> str:
        names = ", ".join(type(i).__name__ for i in self._inputs)
        return f"MixPE({names})"


# How XLA's program of a block holds a PE's pull (the JAX engine masks a
# pull to its PE's extent with a select, for every block): _CONSTANT, a
# ConstantPE's folded constant; the Extent of a masked pull; None, a plain
# value (an infinite extent, or a PE that fills its own edges).
_CONSTANT = "constant"


def _xla_form(pe):
    if isinstance(pe, ConstantPE):
        return _CONSTANT
    sel = pe._xla_select()
    if sel is not None:  # selected by its own program, as by a mask
        return sel
    ext = pe.extent()
    if pe._fills_own_edges() or (ext.start is None and ext.end is None):
        return None
    return ext


def _fuses(product, other) -> bool:
    """Whether LLVM fuses a product of form ``product`` (its GainPE's pull)
    into its sum with an operand of form ``other``: a bare product always;
    a masked one where the select folds into the sum (a constant operand)
    or merges with the operand's (the same mask)."""
    return product is None or other is _CONSTANT or other == product


def _merged(a, b):
    """The form of a sum of two operands of forms ``a`` and ``b``."""
    if a is _CONSTANT:
        return b
    if b is _CONSTANT:
        return a
    return a if a is not None and a == b else None


def _fused(fac, c):
    """``a * b + c`` rounded once (``c`` plus zero outside the product's
    extent)."""
    a, b, keep = fac
    y = xla_math.fmaf(a, b, c)
    return y if keep is None else torch.where(keep, y, c + 0.0)


class TransformPE(ProcessingElement):
    """Apply an arbitrary elementwise ``func(tensor) -> tensor`` to the source.

    ``func`` takes and returns a torch tensor of the same shape.
    """

    def __init__(
        self,
        source: ProcessingElement,
        func: Callable,
        name: str | None = None,
    ):
        self._source = source
        self._func = func
        self._name = name or getattr(func, "__name__", "transform")

    @property
    def source(self) -> ProcessingElement:
        return self._source

    @property
    def func(self) -> Callable:
        return self._func

    @property
    def name(self) -> str:
        return self._name

    def inputs(self) -> list[ProcessingElement]:
        return [self._source]

    def is_pure(self) -> bool:
        return True

    def channel_count(self) -> int | None:
        return self._source.channel_count()

    def _compute_extent(self) -> Extent:
        return self._source.extent()

    def _trace(self, ctx):
        x = ctx.pull(self._source)
        y = torch.as_tensor(self._func(x))
        if y.shape != x.shape:
            raise ValueError(
                f"TransformPE func changed shape {tuple(x.shape)} -> {tuple(y.shape)}"
            )
        return y.to(prec.AUDIO)

    def __repr__(self) -> str:
        return (
            f"TransformPE(source={type(self._source).__name__}, "
            f"func={self._name})"
        )
