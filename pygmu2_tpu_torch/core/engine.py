"""PE-graph render engine (counterpart of ``pygmu2_tpu.core.engine``).

A graph of processing elements renders block by block. For one block the
engine walks the graph from the root: each PE's ``_trace(ctx)`` pulls its
inputs through the :class:`TraceContext` and returns a ``(duration, C)``
float32 tensor on the render's device. PyTorch runs eagerly, so "tracing"
a block IS rendering it, and every block start is a host ``int``: the JAX
package's traced-start branches collapse into its static ones.

* Pure PEs are functions of the absolute sample index.
* Stateful PEs thread a state pytree (nested dicts/tuples of tensors)
  from block to block. Each entry carries a ``next`` cursor (the absolute
  index one past the previous request); on a non-contiguous request the
  state is reset to its init value.
* Extent-driven zero-fill is applied centrally by ``TraceContext.pull``:
  a request wholly outside a PE's extent is pruned (zeros, the PE is not
  rendered), a partial overlap is masked.
* Within one block, repeated pulls of the same node at the same offset
  and duration are memoized: a shared node renders once per block.

``render_scan`` renders a timeline as a Python loop over fixed blocks that
threads the state dict, then leaves the final state on the PE instances
(``checkpoint_state`` / ``restore_state`` save and load it, in the JAX
package's format). ``render_functional`` renders from fresh state and
leaves the instances alone; its output is differentiable with respect to
ParamPE bindings given as tensors that require grad.

Besides rendering, a ``Program`` serves three kinds of PE:

* a PE with ``_prepare_host(device)`` builds a host-side cache once, when
  the program is made (TralfamPE's spectral scramble);
* a PE with ``_eng_version`` takes live writes between blocks
  (``ControlPE.set_value``, ``TimeWarpPE.seek``): a write that lands
  while a block renders survives the block's state scatter;
* a PE with ``_eng_on_block`` (WavWriterPE) publishes each block through
  its state payload, handed to the hook after the block
  (``Program.run``) or, in ``render_scan``, all together after the last
  block, in one download.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, TYPE_CHECKING

import numpy as np
import torch

from pygmu2_tpu_torch.core import prec
from pygmu2_tpu_torch.core.extent import Extent

if TYPE_CHECKING:
    from pygmu2_tpu_torch.core.processing_element import ProcessingElement

# ``next`` cursor value meaning "state has never been used" — any request
# start compares unequal, so the first render after a reset re-inits.
FRESH = -(2**62)

_uid_counter = itertools.count()


def next_uid() -> int:
    """Monotonic id assigned to every PE at construction (stable state keys)."""
    return next(_uid_counter)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over a pytree of dicts, tuples and lists
    (and over trees of the same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)
        )
    return fn(tree, *rest)


def _to_device(value, device):
    """A state leaf as a tensor on ``device`` (numpy leaves keep their dtype)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


class _Frame:
    """One entry of the render stack: which PE is rendering what window."""

    __slots__ = ("pe", "start", "rel", "duration")

    def __init__(self, pe, start: int, rel, duration: int):
        self.pe = pe
        self.start = start  # absolute start (host int)
        self.rel = rel  # offset from the block start, or None for pull_abs
        self.duration = duration


class TraceContext:
    """Handed to ``ProcessingElement._trace`` while one block renders.

    Provides input pulls, scalar-or-PE parameter evaluation, absolute time
    indices, and the state protocol.
    """

    def __init__(
        self,
        program: "Program",
        block_start: int,
        states: dict | None,
        bindings: dict | None = None,
    ):
        self._program = program
        self._block_start = block_start
        self._states_in = states  # None on the very first block
        self._states_out: dict[str, Any] = {}
        self._memo: dict[tuple, torch.Tensor] = {}
        self._kept: dict[tuple, tuple] = {}  # a product node's factors (keep_factors)
        self._stack: list[_Frame] = []
        self._bindings = bindings  # name -> value (ParamPE)

    # ---- frame info -----------------------------------------------------

    @property
    def duration(self) -> int:
        """Sample count of the current frame."""
        return self._stack[-1].duration

    @property
    def start(self) -> int:
        """Absolute start index of the current frame."""
        return self._stack[-1].start

    @property
    def sample_rate(self) -> int:
        return self._program.sample_rate

    @property
    def device(self) -> torch.device:
        """The device every tensor of this render lives on."""
        return self._program.device

    def times(self, dtype=prec.INDEX):
        """Absolute sample indices of the current frame, shape (duration,)."""
        frame = self._stack[-1]
        t = torch.arange(frame.duration, dtype=prec.INDEX, device=self.device)
        t = t + frame.start
        return t if dtype == prec.INDEX else t.to(dtype)

    # ---- pulling inputs -------------------------------------------------

    def pull(self, pe: "ProcessingElement", shift: int = 0, duration: int | None = None):
        """Render ``pe`` for ``[frame.start + shift, + duration)``.

        Returns a float32 tensor ``(duration, C)``.
        """
        frame = self._stack[-1]
        if duration is None:
            duration = frame.duration
        rel = None if frame.rel is None else frame.rel + shift
        return self._render_node(pe, int(frame.start) + shift, rel, duration)

    def pull_abs(self, pe: "ProcessingElement", start: int, duration: int):
        """Render ``pe`` at an absolute start index."""
        return self._render_node(pe, int(start), None, duration)

    def _render_node(self, pe, start: int, rel, duration: int):
        if duration <= 0:
            return self._zeros(0, pe.channel_count() or 1)

        ext = pe.extent()
        key = self._key(pe, start, rel, duration)
        if key in self._memo:
            return self._memo[key]

        # Edge-filling PEs (HOLD modes, ringing tails) emit meaningful
        # samples outside their extent — never prune or shortcut them.
        fills = pe._fills_own_edges()
        if not fills and (
            ext.is_empty() or not ext.intersects(Extent(start, start + duration))
        ):
            # Whole request outside the extent: prune.
            out = self._zeros_like_node(pe, duration)
        else:
            self._stack.append(_Frame(pe, start, rel, duration))
            try:
                out = pe._trace(self)
            finally:
                self._stack.pop()
            if out.dim() == 1:
                out = out[:, None]
            if out.shape[0] != duration:
                raise RuntimeError(
                    f"{type(pe).__name__}._trace returned {out.shape[0]} samples, "
                    f"expected {duration}"
                )
            if out.dtype != prec.AUDIO:
                out = out.to(prec.AUDIO)
            out = self._mask_extent(pe, ext, start, duration, out)

        self._memo[key] = out
        return out

    def keep_factors(self, a, b) -> None:
        """Called by a product PE's ``_trace``: its output is ``a * b``
        (see :meth:`factors_of`)."""
        frame = self._stack[-1]
        self._kept[self._key(frame.pe, frame.start, frame.rel, frame.duration)] = (a, b)

    def factors_of(self, pe: "ProcessingElement"):
        """The unrounded factors of the input ``pe`` just pulled over the
        current frame, for a consumer that contracts its product into a sum
        (``MixPE``), as XLA's CPU program contracts a product whose one use
        is a sum into a fused multiply-add.

        Returns ``(a, b, keep)``: the pull is ``where(keep, a * b, 0)``
        (``keep`` a ``(duration, 1)`` mask, or None where the frame lies
        inside ``pe``'s extent). None where ``pe`` kept no factors (not a
        product, or pruned in this frame) or feeds another consumer in the
        graph.
        """
        if self._program.uses(pe) != 1:
            return None
        frame = self._stack[-1]
        kept = self._kept.get(self._key(pe, frame.start, frame.rel, frame.duration))
        if kept is None:
            return None
        mask = None
        if not pe._fills_own_edges():
            mask = self._extent_mask(pe.extent(), frame.start, frame.duration)
        return (*kept, None if mask is None else mask[:, None])

    @staticmethod
    def _key(pe, start: int, rel, duration: int) -> tuple:
        """The memo key of ``pe``'s render over a window."""
        if rel is not None:
            return (id(pe), rel, duration)
        return (id(pe), ("abs", start), duration)

    def _zeros(self, duration: int, channels: int):
        return torch.zeros((duration, int(channels)), dtype=prec.AUDIO, device=self.device)

    def _zeros_like_node(self, pe, duration: int):
        channels = pe.channel_count()
        if channels is None:
            counts = [inp.channel_count() for inp in pe.inputs()]
            counts = [c for c in counts if c is not None]
            channels = pe.resolve_channel_count(counts) if counts else 1
        return self._zeros(duration, channels)

    def _mask_extent(self, pe, ext: Extent, start: int, duration: int, out):
        """Zero samples outside ``ext`` (render contract 1) unless the PE
        fills its own edges (ExtendMode HOLD variants)."""
        if pe._fills_own_edges():
            return out
        mask = self._extent_mask(ext, start, duration)
        if mask is None:
            return out
        return torch.where(mask[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))

    def _extent_mask(self, ext: Extent, start: int, duration: int):
        """``(duration,)`` bool mask of the samples inside ``ext``, or None
        when the window lies inside it."""
        if ext.start is None and ext.end is None:
            return None
        if ext.spans(start, duration):
            return None
        t = torch.arange(duration, dtype=prec.INDEX, device=self.device) + start
        mask = torch.ones((duration,), dtype=torch.bool, device=self.device)
        if ext.start is not None:
            mask = mask & (t >= ext.start)
        if ext.end is not None:
            mask = mask & (t < ext.end)
        return mask

    # ---- scalar-or-PE parameters ---------------------------------------

    def param(
        self,
        value,
        channel: int = 0,
        multichannel: bool = False,
        channels: int | None = None,
        dtype=prec.AUDIO,
    ):
        """Evaluate a scalar-or-PE parameter over the current frame.

        Returns ``(duration,)`` (channel 0 of a multichannel PE by default),
        or ``(duration, C)`` when ``multichannel`` is True.
        """
        from pygmu2_tpu_torch.core.processing_element import ProcessingElement

        duration = self.duration
        if isinstance(value, ProcessingElement):
            data = self.pull(value)
            if multichannel:
                return data.to(dtype)
            if channel < 0 or channel >= data.shape[1]:
                raise ValueError(
                    f"channel {channel} out of range for param with "
                    f"{data.shape[1]} channels"
                )
            return data[:, channel].to(dtype)
        shape = (duration, channels or 1) if multichannel else (duration,)
        return torch.full(shape, float(value), dtype=dtype, device=self.device)

    def param_is_pe(self, value) -> bool:
        from pygmu2_tpu_torch.core.processing_element import ProcessingElement

        return isinstance(value, ProcessingElement)

    # ---- runtime-bindable parameters (ParamPE) ---------------------------

    def binding(self, name: str, default):
        """The bound value for ``name`` (a scalar or ``(C,)`` tensor) when
        the render was given ``bindings={name: value}``, else ``default``."""
        value = default
        if self._bindings is not None and name in self._bindings:
            value = self._bindings[name]
        if isinstance(value, (int, float)):  # a fill, not a host-to-card copy
            return torch.full((), float(value), dtype=prec.AUDIO, device=self.device)
        return torch.as_tensor(value, dtype=prec.AUDIO, device=self.device)

    # ---- state protocol -------------------------------------------------

    def state(self, pe, init, reset_on_gap: bool = True):
        """Fetch ``pe``'s carried state for the current frame.

        ``init`` is a pytree (or zero-arg callable returning one) giving the
        reset value; its leaf shapes/dtypes define the state layout. It is
        evaluated only on the first request and on a gap; a callable that
        builds its tensors on ``ctx.device`` costs no host-to-card copy,
        which would synchronize the stream. Returns
        ``(state, fresh)`` where ``fresh`` is True when the state was
        (re)initialized because this is the first request or a
        non-contiguous one.

        Call :meth:`set_state` with the updated pytree before returning.
        """
        key = f"pe{pe._uid}"
        dev = self.device

        def init_value():
            # only when needed: a copy to the card would synchronize
            val = init() if callable(init) else init
            return tree_map(lambda v: _to_device(v, dev), val)

        if self._states_in is None or key not in self._states_in:
            self._program._register_state_node(pe)
            return init_value(), True

        stored = self._states_in[key]
        user = tree_map(lambda v: _to_device(v, dev), stored["user"])
        if not reset_on_gap:
            return user, stored["next"] == FRESH
        if stored["next"] == self._stack[-1].start:
            return user, False
        return tree_map(lambda cur, ini: ini.to(cur.dtype), user, init_value()), True

    def set_state(self, pe, new_state) -> None:
        """Store ``pe``'s state for the next block."""
        frame = next((fr for fr in reversed(self._stack) if fr.pe is pe), self._stack[-1])
        self._states_out[f"pe{pe._uid}"] = {
            "user": new_state,
            "next": frame.start + frame.duration,
        }

    def _collect_states(self) -> dict:
        # Carry through untouched states so a subgraph pruned this block
        # keeps its state (its ``next`` cursor then marks the gap).
        out = dict(self._states_out)
        if self._states_in:
            for key, val in self._states_in.items():
                out.setdefault(key, val)
        return out


class Program:
    """The render of one (root, block duration, device) triple."""

    def __init__(self, root: "ProcessingElement", duration: int, device="cuda"):
        self.root = root
        self.duration = int(duration)
        self.device = torch.device(device)
        self.sample_rate = root.sample_rate
        self._state_nodes: list = []
        self._walked = _walk(root)
        self._uses = collections.Counter(id(inp) for pe in self._walked for inp in pe.inputs())
        # Host prelude: PEs build host-side caches once, before the first
        # block (TralfamPE renders its whole source here, on this device).
        for pe in self._walked:
            prep = getattr(pe, "_prepare_host", None)
            if prep is not None:
                prep(self.device)

    def uses(self, pe) -> int:
        """How many inputs of the graph's nodes are ``pe`` (its consumers,
        each counted once per input it feeds)."""
        return self._uses[id(pe)]

    def _run(self, block_start: int, states: dict | None, bindings=None):
        """Render one block from ``states``; returns (block, new states)."""
        ctx = TraceContext(self, block_start, states, bindings)
        out = ctx._render_node(self.root, block_start, 0, self.duration)
        return out, ctx._collect_states()

    def _register_state_node(self, pe) -> None:
        if pe not in self._state_nodes:
            self._state_nodes.append(pe)

    def run(self, start: int):
        """Render one block at ``start``, threading instance-held state.

        Live-control writes win: a thread-safe state write that lands
        while the block renders (``ControlPE.set_value``,
        ``TimeWarpPE.seek``; they bump the PE's ``_eng_version``) is not
        overwritten by the scatter after the block: the PE keeps its live
        payload and takes only the timeline cursor (``next``) from the
        render, so the write plays from the next contiguous block.
        """
        versions = [getattr(pe, "_eng_version", 0) for pe in self._walked]
        states = _gather_states(self.root)
        out, new_states = self._run(int(start), states)
        for pe, ver in zip(self._walked, versions):
            key = f"pe{pe._uid}"
            if key not in new_states:
                continue
            if getattr(pe, "_eng_version", 0) != ver:
                live = getattr(pe, "_eng_live_state", None)
                cur = pe._eng_state
                # on the block's device: a write before the PE's first state
                # must not leave a host tensor for the next block to upload
                user = live(new_states[key]["user"].device) if live is not None else (
                    cur["user"] if cur is not None else new_states[key]["user"]
                )
                pe._eng_state = {"user": user, "next": new_states[key]["next"]}
            else:
                pe._eng_state = new_states[key]
        self._fire_block_hooks(states, new_states)
        return out

    def run_static(self, start: int):
        """Same as :meth:`run`: in eager PyTorch every start is static, so
        the JAX package's per-start retrace has nothing to add."""
        return self.run(start)

    def _fire_block_hooks(self, before: dict | None, after: dict) -> None:
        """Hand each side-effect PE (``_eng_on_block``: WavWriterPE) the
        payload it published in the block just rendered. A PE pruned from
        the block published nothing: its carried payload is not handed
        over again."""
        for pe in self._walked:
            hook = getattr(pe, "_eng_on_block", None)
            key = f"pe{pe._uid}"
            if hook is not None and key in after and after[key] is not (before or {}).get(key):
                hook(after[key]["user"])


def _walk(root) -> list:
    """All nodes reachable from root (root included), depth-first, each once."""
    seen: dict[int, Any] = {}
    order = []

    def visit(pe):
        if id(pe) in seen:
            return
        seen[id(pe)] = pe
        for inp in pe.inputs():
            visit(inp)
        order.append(pe)

    visit(root)
    return order


def _gather_states(root) -> dict | None:
    """Collect instance-held states for the graph; None if none initialized."""
    states = {}
    for pe in _walk(root):
        st = getattr(pe, "_eng_state", None)
        if st is not None:
            states[f"pe{pe._uid}"] = st
    return states or None


def _scatter_states(root, states: dict) -> None:
    for pe in _walk(root):
        key = f"pe{pe._uid}"
        if key in states:
            pe._eng_state = states[key]


def _detached(states: dict) -> dict:
    """``states`` with every tensor leaf detached: a state left on a PE
    instance must not hold a differentiable render's graph alive."""
    def leaf(v):
        return v.detach() if isinstance(v, torch.Tensor) else v

    return {k: {**v, "user": tree_map(leaf, v["user"])} for k, v in states.items()}


def _bindings_on(bindings, device):
    """``bindings`` with each tensor on ``device``, copied once per render
    (a differentiable copy), not once per block."""
    if not bindings:
        return bindings
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in bindings.items()}


def reset_graph_states(root) -> None:
    """Drop all carried state in the graph (forces re-init on next render)."""
    for pe in _walk(root):
        pe._eng_state = None


def get_program(root, duration: int, device="cuda") -> Program:
    """Program cache, keyed per root instance, block duration and device."""
    device = torch.device(device)
    cache = root.__dict__.setdefault("_programs", {})
    prog = cache.get((duration, device))
    if prog is None:
        prog = Program(root, duration, device)
        cache[(duration, device)] = prog
    return prog


def _render_blocks(prog, start: int, total: int, states, bindings, taps=None):
    """Render ``[start, start+total)`` in blocks of ``prog.duration`` from
    ``states``. Returns (the (total, C) output, the final states). With
    ``taps`` (a dict of side-effect PE keys to lists), each block's newly
    published payload is appended, its rows past the render's end (the
    last block's padding) cut off."""
    block = prog.duration
    outs = []
    for i in range(-(-total // block)):
        out, new_states = prog._run(start + i * block, states, bindings)
        for key, got in (taps or {}).items():
            st = new_states.get(key)
            if st is not None and st is not (states or {}).get(key):
                n = st["user"].shape[0]  # the payload ends at the cursor
                keep = min(n, start + total - (st["next"] - n))
                if keep > 0:
                    got.append(st["user"][:keep])
        outs.append(out)
        states = new_states
    return torch.cat(outs)[:total], states


def render_scan(root, start: int, total: int, block: int, bindings=None, *,
                device="cuda"):
    """Render ``[start, start+total)`` over fixed blocks of ``block`` samples.

    Returns a ``(total, C)`` float32 tensor on ``device``; the state after
    the last block stays on the PE instances. ``bindings`` maps
    :class:`~pygmu2_tpu_torch.models.basic.ParamPE` names to values.

    Side-effect PEs (``_eng_on_block``: WavWriterPE) get every block's
    payload, in block order, after the last block: the payloads stay on
    the device during the loop and come down in one copy per PE, so a
    graph with a writer syncs the host no more often than one without.
    """
    device = torch.device(device)
    if total <= 0:
        return torch.zeros((0, root.channel_count() or 1), dtype=prec.AUDIO, device=device)
    block = int(min(block, total))
    prog = get_program(root, block, device)
    writers = [pe for pe in prog._walked if hasattr(pe, "_eng_on_block")]
    taps = {f"pe{pe._uid}": [] for pe in writers}
    out, states = _render_blocks(prog, start, total, _gather_states(root),
                                 _bindings_on(bindings, device), taps)
    _scatter_states(root, _detached(states))
    for pe in writers:
        parts = taps[f"pe{pe._uid}"]
        if parts:
            host = torch.cat(parts).cpu()  # the writer's one download
            for part in host.split([p.shape[0] for p in parts]):
                pe._eng_on_block(part)
    return out


def render_functional(root, start: int, total: int, block: int, bindings=None, *,
                      device="cuda"):
    """Render ``[start, start+total)`` from fresh state, as ``render_scan``
    renders it from a reset graph, reading and writing no PE's carried
    state and firing no block hook.

    ``bindings`` maps ParamPE names to values: a parameter sweep renders
    the same graph again and again without touching it. A binding may be
    a scalar or ``(C,)`` tensor that requires grad, on the CPU or the
    render's device (copied there once): the output's ``grad_fn`` then
    reaches it, so ``torch.autograd`` of a loss of the render gives the
    loss's gradient with respect to the bindings, as ``jax.grad`` does in
    the JAX package. On the CPU autograd differentiates the kernels'
    plain versions; on the card every kernel's backward is a hand-written
    backward kernel (``ops/diffable.py``).

    Batched bindings: ``torch.func.vmap(lambda b: render_functional(root,
    start, total, block, b, device=dev))(batch)`` renders a batch of
    binding sets at once, (B, total, C), the counterpart of ``jax.vmap``
    over the JAX package's ``render_functional``; on the card each kernel
    batches by its rule (``ops/diffable.kernel_function``: the batch folded
    into the channel axis, one launch, or one launch per member), and
    ``torch.autograd`` or ``torch.func.grad`` differentiates it.
    """
    device = torch.device(device)
    if total <= 0:
        return torch.zeros((0, root.channel_count() or 1), dtype=prec.AUDIO, device=device)
    block = int(min(block, total))
    # the program's host prelude may render a subgraph through the instances
    # (TralfamPE's source): put their states back as they were
    walked = _walk(root)
    held = [pe._eng_state for pe in walked]
    prog = get_program(root, block, device)
    for pe, st in zip(walked, held):
        pe._eng_state = st
    out, _ = _render_blocks(prog, start, total, None, _bindings_on(bindings, device))
    return out


# ---- checkpoint / resume -------------------------------------------------
#
# Snapshots are keyed structurally (walk order + class name), so they
# restore onto a *rebuilt* graph of the same shape, and they carry the
# JAX package's format: {"i:ClassName": {"user": numpy pytree, "next":
# 0-d int64}}. A snapshot of either package restores in the other.


def _structural_keys(root) -> dict:
    return {
        f"pe{pe._uid}": f"{i}:{type(pe).__name__}"
        for i, pe in enumerate(_walk(root))
    }


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def checkpoint_state(root) -> dict:
    """Snapshot the graph's carried render state as host numpy arrays."""
    states = _gather_states(root) or {}
    remap = _structural_keys(root)
    return {
        remap[k]: {
            "user": tree_map(_to_numpy, v["user"]),
            "next": np.asarray(v["next"], dtype=np.int64),
        }
        for k, v in states.items()
    }


def restore_state(root, snapshot: dict) -> None:
    """Restore a ``checkpoint_state`` snapshot (of this package or of the
    JAX package) onto ``root``'s graph.

    The graph must have the same structure (same PE classes in the same
    walk order) as the one the snapshot was taken from.
    """
    reset_graph_states(root)
    if not snapshot:
        return
    inv = {s: u for u, s in _structural_keys(root).items()}
    unknown = set(snapshot) - set(inv)
    if unknown:
        raise ValueError(
            f"snapshot does not match this graph's structure: {sorted(unknown)}"
        )
    _scatter_states(
        root,
        {
            inv[k]: {
                "user": tree_map(lambda a: torch.as_tensor(np.array(a)), v["user"]),
                "next": int(np.asarray(v["next"])),
            }
            for k, v in snapshot.items()
        },
    )
