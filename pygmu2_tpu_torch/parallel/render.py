"""Multi-device rendering: audio work sharded over a mesh of devices
(counterpart of ``pygmu2_tpu.parallel.render``).

Two axes shard, as in the JAX package:

- **Voices** (the SoundFont synth): the voice engine is laid out over a
  (polyphony,) axis, so each shard renders a slice of the voices and the
  shards' stereo mixes are summed (``render_midi_sharded``,
  ``render_midi_offline_sharded``).
- **Time** (PE graphs): a pure graph renders disjoint spans of the
  timeline independently (``render_time_sharded``); a stateful graph
  relays its carried state from span to span, warms each span up from a
  fresh state (``render_time_sharded_stateful``), or, where its state is
  affine, composes the spans' state maps (``render_time_sharded_affine``).

One Python process drives the whole mesh, as ``jax.shard_map`` under
``jit`` does: each function is called once and returns one host array.
The JAX package's collectives become tensor moves:

- psum: the shards' results summed on the mesh's first device, left to
  right in mesh order;
- the ppermute state relay: the carried states moved with ``.to(device)``
  to the next shard's device;
- the all_gather of the span maps: the maps copied to the mesh's first
  device, which composes them in float64 in mesh order.

A :class:`Mesh` is a list of ``torch.device``; a device may appear more
than once, one shard each (``Mesh(["cpu"] * 8)``, ``Mesh(["cuda:0"] *
4)``), as the JAX package's tests shard over virtual CPU devices. Every
kernel launch enters its device's context on that device's current
stream (each kernel wrapper does); the shards are enqueued one after the
other from this thread.
"""

from __future__ import annotations

import numpy as np
import torch

from pygmu2_tpu_torch.core import engine
from pygmu2_tpu_torch.soundfont import offline as off
from pygmu2_tpu_torch.soundfont.convert import _pack_schedule_np, to_torch
from pygmu2_tpu_torch.soundfont.synthesizer import _unpacked


# The affine probe's basis: the unit vectors times this power of two. A
# column's response then stands above the rounding of the zero-state
# output it is taken from, and dividing by a power of two is exact (on
# the convolve graph of the tests, 8.0e-5 off render_scan with unit
# vectors, 4.3e-6 with this scale).
BASIS_SCALE = 64.0


class Mesh:
    """A 1-D mesh: the devices of its shards, in order, and the axis name.

    ``devices`` is a sequence of ``torch.device`` (or strings); a device
    may repeat. ``axis_names`` and ``size`` mirror ``jax.sharding.Mesh``.
    """

    def __init__(self, devices, axis: str = "v"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)


def default_mesh(n_devices: int | None = None, axis: str = "v",
                 device="cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices of ``device``'s
    type (all of them by default). Raises if fewer exist; the CPU counts
    as one device."""
    kind = torch.device(device).type
    if kind == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(device)]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"{n_devices} devices asked for, {len(devices)} {kind} device(s) "
                f"present; Mesh([...]) repeats a device"
            )
        devices = devices[:n_devices]
    if not devices:
        raise ValueError(f"no {kind} device")
    return Mesh(devices, axis)


def _spans(total: int, n_dev: int, block: int) -> tuple[int, list[int]]:
    """(samples of each shard's span, blocks each shard renders): the
    timeline cut in ``n_dev`` spans, each rounded up to whole blocks. A
    shard renders only the blocks of its span that reach into the
    timeline, so the shards together render the blocks
    ``engine.render_scan`` renders, at the same starts (the JAX package's
    fixed shapes also render the blocks past the end, and discard them)."""
    span = -(-total // n_dev)
    span = -(-span // block) * block
    counts = [max(0, min(span // block, -(-(total - d * span) // block)))
              for d in range(n_dev)]
    return span, counts


def _render_span(prog, s0: int, n_blocks: int, states):
    """``n_blocks`` (>= 1) blocks from ``s0`` threading ``states`` (None: fresh);
    returns (the (n_blocks · block, C) output, the final states)."""
    outs = []
    for k in range(n_blocks):
        out, states = prog._run(s0 + k * prog.duration, states)
        outs.append(out)
    return torch.cat(outs), states


def _download(parts, total: int) -> np.ndarray:
    """The shards' outputs, concatenated on the time axis, on the host (one
    copy a shard)."""
    return torch.cat([p.cpu() for p in parts]).numpy()[:total]


def _psum(parts, device):
    """The shards' results summed on ``device``, left to right in mesh order."""
    acc = parts[0].to(device)
    for part in parts[1:]:
        acc = acc + part.to(device)
    return acc


def _states_to(states, device):
    """Carried states with every tensor leaf moved to ``device``."""
    def leaf(v):
        return v.to(device) if isinstance(v, torch.Tensor) else v

    return {k: {**v, "user": engine.tree_map(leaf, v["user"])} for k, v in states.items()}


def _probe(root, block: int, device):
    """Render one block at 0 from fresh state and discard its output: the
    program's ``_state_nodes`` are then filled, and the returned states
    give the state's layout (the JAX package traces the block abstractly
    for the same)."""
    prog = engine.get_program(root, block, device)
    _out, states = prog._run(0, None)
    return prog, states


# ---- time-parallel pure-graph rendering --------------------------------


def render_time_sharded(root, start: int, total: int, mesh: Mesh, block: int = 8192):
    """Render a PURE graph's ``[start, start+total)`` with the time axis
    sharded over the mesh: each shard renders its own span of blocks, no
    collective.

    Returns a host float32 array (total, C).
    """
    if not root.is_pure():
        raise ValueError(
            "render_time_sharded requires a pure graph (stateful graphs "
            "carry a sequential state chain); use engine.render_scan."
        )
    span, counts = _spans(total, mesh.size, block)
    parts = []
    for d, (dev, n_blocks) in enumerate(zip(mesh.devices, counts)):
        if n_blocks:
            prog = engine.get_program(root, block, dev)
            s0 = start + d * span
            parts.append(torch.cat([prog._run(s0 + k * block, None)[0]
                                    for k in range(n_blocks)]))
    return _download(parts, total)


def render_time_sharded_stateful(
    root, start: int, total: int, mesh: Mesh, block: int = 8192,
    halo: int = 0,
):
    """Render a STATEFUL graph with the block-time axis sharded over the
    mesh.

    Two modes:

    - ``halo == 0`` (default, **exact**): each shard owns a contiguous
      span; the carried states are relayed along the mesh in order, so
      shard d starts from exactly the states shard d-1 ended with. The
      shards render the same blocks from the same states as
      ``engine.render_scan`` does, so the output equals it bit for bit.
      Unlike ``render_scan`` this does not write the final state back
      onto the graph's instances: each call renders its span from a
      fresh state on the first shard, and the instances' states stay as
      they were.

    - ``halo > 0`` (**parallel, approximate**): every shard renders
      ``halo`` warm-up samples (rounded up to whole blocks) from a fresh
      state before its span and discards them. No state crosses shards;
      valid ONLY when every stateful node's state *decays*
      (:meth:`state_decays`), which is checked: a ``ValueError`` names
      the nodes that do not. The first shard pre-rolls t < start, so a
      source defined there changes the cold-start transient within the
      first span.

    Returns a host float32 array (total, C).
    """
    span, counts = _spans(total, mesh.size, block)

    if halo:
        halo_blocks = -(-halo // block)
        prog, _ = _probe(root, block, mesh.devices[0])
        bad = [type(pe).__name__ for pe in prog._state_nodes if not pe.state_decays()]
        if bad:
            raise ValueError(
                "halo mode requires every stateful node's state to decay "
                f"(non-decaying: {sorted(set(bad))}); these depend on "
                "where rendering started and will not converge in the "
                "warm-up — use halo=0 (exact state relay)."
            )
        parts = []
        for d, (dev, n_blocks) in enumerate(zip(mesh.devices, counts)):
            if n_blocks:
                prog = engine.get_program(root, block, dev)
                s0 = start + d * span - halo_blocks * block
                out, _ = _render_span(prog, s0, halo_blocks + n_blocks, None)
                parts.append(out[halo_blocks * block:])
        return _download(parts, total)

    # ---- exact mode: the state relay ----
    parts, states = [], None
    for d, (dev, n_blocks) in enumerate(zip(mesh.devices, counts)):
        if n_blocks:
            prog = engine.get_program(root, block, dev)
            if states is not None:
                states = _states_to(states, dev)
            out, states = _render_span(prog, start + d * span, n_blocks, states)
            parts.append(out)
    return _download(parts, total)


# ---- time-parallel affine-state rendering -------------------------------


def _leaves(tree, path=()):
    """(path, leaf) pairs of a state pytree; dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _map_leaves(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _users(states) -> dict:
    return {k: v["user"] for k, v in states.items()}


def _affine_state_layout(states):
    """((path, shape) of each floating-point state leaf, D): the vector
    the affine machinery probes. Integer and bool leaves, and the ``next``
    cursors, are held at their template values."""
    layout = tuple(
        (path, tuple(leaf.shape))
        for path, leaf in _leaves(_users(states))
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
    )
    return layout, sum(int(np.prod(shape)) for _, shape in layout)


def _set_vec(tmpl, layout, vec):
    """``tmpl`` with its float leaves taken from the (D,) vector ``vec``."""
    offsets, o = {}, 0
    for path, shape in layout:
        n = int(np.prod(shape))
        offsets[path] = (o, n)
        o += n

    def leaf(path, x):
        if path not in offsets:
            return x
        i, n = offsets[path]
        return vec[i:i + n].reshape(x.shape).to(x.dtype)

    users = _map_leaves(leaf, _users(tmpl))
    return {k: {**v, "user": users[k]} for k, v in tmpl.items()}


def _get_vec(states, layout):
    """The float leaves of ``states`` as one float32 (D,) vector."""
    got = dict(_leaves(_users(states)))
    return torch.cat([got[path].reshape(-1).to(torch.float32) for path, _ in layout])


def render_time_sharded_affine(
    root, start: int, total: int, mesh: Mesh, block: int = 8192
):
    """EXACT *and parallel* time sharding for affine-state graphs.

    The exact relay (``render_time_sharded_stateful``) serializes on the
    state chain. When every stateful node declares :meth:`state_affine`
    (linear filters, FIR histories), the span map ``s_in → (output,
    s_out)`` is affine, so the chain solves in parallel instead:

    1. every shard renders its span from a *basis* of initial states
       (the zero vector and the D unit vectors times ``BASIS_SCALE``,
       D + 1 renders), giving
       the zero-state response ``y0``, the span's state transition
       matrix ``M`` and offset ``c``, and the output's state sensitivity
       ``dY``. Each render starts from a template block rendered one
       block before the span, which supplies every state's ``next``
       cursor, so the basis renders continue the timeline;
    2. the small ``(M, c)`` maps are copied to the mesh's first device,
       which composes each shard's entering state in float64 in mesh
       order;
    3. each shard corrects its output by linearity: ``y = y0 + dY ·
       s_in``.

    A long ConvolvePE history makes D = len(fir) − 1 and the basis
    expensive; :func:`render_time_sharded_auto` picks the relay there.
    Matches ``engine.render_scan`` within 1e-5 for constant-coefficient
    chains, 1e-4 under resonance sweeps and long FIR histories.

    Returns a host float32 array (total, C).
    """
    span, counts = _spans(total, mesh.size, block)
    head = mesh.devices[0]
    prog, probe = _probe(root, block, head)
    bad = sorted({type(pe).__name__ for pe in prog._state_nodes if not pe.state_affine()})
    if bad:
        raise ValueError(
            "render_time_sharded_affine requires every stateful node's "
            f"state map to be affine (non-affine: {bad}); use halo=0 "
            "exact relay (render_time_sharded_stateful) for such graphs."
        )
    layout, D = _affine_state_layout(probe)
    if prog._state_nodes and D == 0:
        raise ValueError("affine graph declared state but carries no float leaves")
    if not prog._state_nodes:
        # no state at all: pure time sharding
        return render_time_sharded(root, start, total, mesh, block=block)

    shards = [(d, dev, n) for d, (dev, n) in enumerate(zip(mesh.devices, counts)) if n]
    y0s, dYs, Ms, cs = [], [], [], []
    for d, dev, n_blocks in shards:
        prog = engine.get_program(root, block, dev)
        s0 = start + d * span
        _, tmpl = prog._run(s0 - block, None)
        if _affine_state_layout(tmpl)[0] != layout:
            raise ValueError(
                "render_time_sharded_affine: the state's layout differs between "
                "spans; use the exact relay (render_time_sharded_stateful)."
            )
        basis = torch.cat([torch.zeros((1, D), dtype=torch.float32, device=dev),
                           BASIS_SCALE * torch.eye(D, dtype=torch.float32, device=dev)])
        ys, ends = [], []
        for vec in basis:
            out, st = _render_span(prog, s0, n_blocks, _set_vec(tmpl, layout, vec))
            ys.append(out)
            ends.append(_get_vec(st, layout))
        ys, ends = torch.stack(ys), torch.stack(ends)  # (D+1, span, C), (D+1, D)
        y0s.append(ys[0])
        dYs.append((ys[1:] - ys[0][None]) / BASIS_SCALE)
        cs.append(ends[0].to(torch.float64))
        Ms.append(((ends[1:] - ends[0][None]) / BASIS_SCALE).to(torch.float64).T)

    # the gather: every span's (M, c) on the first device, composed there
    parts, s_in = [], torch.zeros((D,), dtype=torch.float64, device=head)
    for i, (_d, dev, _n) in enumerate(shards):
        corr = torch.einsum("d,dtc->tc", s_in.to(torch.float32).to(dev), dYs[i])
        parts.append(y0s[i] + corr)
        s_in = Ms[i].to(head) @ s_in + cs[i].to(head)
    return _download(parts, total)


def select_time_sharding(
    root, mesh: Mesh, block: int = 8192, affine_max_basis: int | None = None
):
    """Pick the time-sharding strategy for ``root`` on ``mesh``.

    Returns ``(mode, D)`` with ``mode`` in ``{"pure", "affine",
    "relay"}`` and ``D`` the float-state dimension (0 for pure graphs, -1
    where a non-affine node leaves it unprobed).

    The affine path renders D + 1 spans on every shard at once; the relay
    renders ``n_dev`` spans one after the other. So affine is taken
    exactly when ``D + 1 <= n_dev`` (``affine_max_basis`` replaces
    ``n_dev`` as the cap).
    """
    if root.is_pure():
        return "pure", 0
    prog, probe = _probe(root, block, mesh.devices[0])
    if not prog._state_nodes:
        return "pure", 0
    if any(not pe.state_affine() for pe in prog._state_nodes):
        return "relay", -1
    _, D = _affine_state_layout(probe)
    cap = mesh.size if affine_max_basis is None else affine_max_basis
    if D + 1 <= cap:
        return "affine", D
    return "relay", D


def render_time_sharded_auto(
    root, start: int, total: int, mesh: Mesh, block: int = 8192,
    affine_max_basis: int | None = None,
):
    """Time-sharded render with the strategy :func:`select_time_sharding`
    picks: pure graphs shard with no collective, affine-state graphs of
    a small state dimension compose their span maps, everything else
    takes the exact state relay. Returns a host float32 array (total, C)."""
    mode, _d = select_time_sharding(
        root, mesh, block=block, affine_max_basis=affine_max_basis
    )
    if mode == "pure":
        return render_time_sharded(root, start, total, mesh, block=block)
    if mode == "affine":
        return render_time_sharded_affine(root, start, total, mesh, block=block)
    return render_time_sharded_stateful(root, start, total, mesh, block=block)


# ---- voice-parallel SoundFont rendering --------------------------------


def _voice_shards(synth, mesh: Mesh) -> int:
    """Voices per shard; raises where the mesh size does not divide the
    polyphony."""
    n_dev = mesh.size
    if synth.maximum_polyphony % n_dev != 0:
        raise ValueError(
            f"maximum_polyphony ({synth.maximum_polyphony}) must divide by "
            f"the mesh size ({n_dev})"
        )
    return synth.maximum_polyphony // n_dev


def render_midi_sharded(synth, midi_file, seconds: float, mesh: Mesh) -> np.ndarray:
    """MIDI render on the streaming voice engine with the voice axis
    sharded over the mesh.

    Each shard runs ``Synthesizer._block_kernel`` block after block on its
    slice of the voices (its biquad's feedback one launch of the order-2
    scan kernel a block on the card); the channel state and the
    block→snapshot map are the same for all. The one collective is the
    sum of the shards' (N, 2) mixes, left to right in mesh order on the
    first device. The polyphony must divide by the mesh size.

    Returns a host float32 array (samples, 2).
    """
    local_p = _voice_shards(synth, mesh)
    par_np, ch_np, snap_idx, n_blocks = synth.build_schedule(midi_file, seconds)
    N = synth.block_size
    master = float(synth.master_volume)
    pf32, pi32, pf64, cf32, chold, _flags = _pack_schedule_np(par_np, ch_np)
    snaps = np.asarray(snap_idx).tolist()
    parts = []
    for d, dev in enumerate(mesh.devices):
        voices = slice(d * local_p, (d + 1) * local_p)
        sf32, si32, sf64, scf32, schold = to_torch(
            (pf32[..., voices], pi32[..., voices], pf64[..., voices], cf32, chold), dev)
        out = torch.empty((n_blocks * N, 2), dtype=torch.float32, device=dev)
        dyn = synth._init_dyn(local_p, device=dev)
        for b, s in enumerate(snaps):  # s: the block's snapshot
            par, ch = _unpacked(sf32[:, s], si32[:, s], sf64[:, s], scf32[:, s], schold[s])
            dyn, out[b * N:(b + 1) * N] = synth._block_kernel(dyn, par, ch, master)
        parts.append(out)
    total = int(round(seconds * synth.sample_rate))
    result = _psum(parts, mesh.devices[0])[:total].cpu().numpy()
    synth.reset()
    return result


def render_midi_offline_sharded(
    synth, midi_file, seconds: float, mesh: Mesh
) -> np.ndarray:
    """The offline renderer (``offline.render_midi_offline``) with the
    voices sharded over the mesh.

    The control pass and the audio pass both work per voice, so each
    shard runs them on its slice of the voice planes (one launch of the
    fused audio kernel a shard on the card); the channel tables, the
    block→snapshot map and the wavetable are the same for all. The one
    collective is the sum of the shards' (T, 2) mixes, left to right in
    mesh order on the first device. A shard takes the unfused audio pass
    where ``render_midi_offline`` would for its voice count.

    Returns a host float32 array (samples, 2).
    """
    local_p = _voice_shards(synth, mesh)
    par_np, ch_np, snap_idx, _nb = synth.build_schedule(midi_file, seconds)
    pf32, pi32, pf64, cf32, chold, flags = _pack_schedule_np(par_np, ch_np)
    N = synth.block_size
    min_dur = int(synth._minimum_voice_duration)
    sr = float(synth.sample_rate)
    master = float(synth.master_volume)
    unfused = (off._out_of_window(synth, par_np, ch_np)
               and N % 128 == 0 and local_p % 128 == 0)
    snap = np.asarray(snap_idx, np.int64)
    waves, parts = {}, []
    for d, dev in enumerate(mesh.devices):
        voices = slice(d * local_p, (d + 1) * local_p)
        planes = to_torch(
            (pf32[..., voices], pi32[..., voices], pf64[..., voices], cf32, chold, snap), dev)
        ctrl = off._control_device(*planes, N, flags, min_dur, sr)
        if dev not in waves:
            waves[dev] = to_torch(synth._wave, dev)
        out, _state = off._audio_pass(ctrl, waves[dev], N, master, unfused=unfused)
        parts.append(out)
    total = int(round(seconds * synth.sample_rate))
    result = _psum(parts, mesh.devices[0])[:total].cpu().numpy()
    synth.reset()
    return result
