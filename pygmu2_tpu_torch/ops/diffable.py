"""Autograd and batching for the port's CUDA kernels.

Counterpart of ``pygmu2_tpu.ops.diffable``. In the JAX package a Pallas
kernel has no autodiff rule, so ``kernel_with_scan_vjp`` gives each one a
custom VJP: the kernel forward, ``jax.vjp`` of its ``lax.scan`` reference
backward; ``jax.vmap`` batches the kernel by its own rule. Here a wrapper
launches its kernel through ``ctypes`` and gets tensors with no
``grad_fn``; :func:`kernel_function` makes the launch a
``torch.autograd.Function`` in the form ``torch.func`` accepts:

- the forward is the launch as it was; the primal inputs and the outputs
  are saved as residuals (a backward kernel recomputes whatever
  trajectory it needs from them, or reads what the launch wrote for it:
  the ladder's checkpoints, written only by a launch that goes through
  the Function, the comb's delays and windows, the echo's control table,
  written only by such a launch too), but for a buffer the launch updates
  in place (the echo's block rings): its old value is gone, and a later
  launch updates it again, so it is not saved and the backward gets None
  for it;
- the backward is a backward kernel's launch (the ladder, the comb, the
  order-2 affine scan, the Karplus-Strong string, the follower, the slew
  limiter, the reverse echo, the ADSR) or, for a kernel given none, raises
  ``NotImplementedError``: the plain version never runs on the card as a
  backward. The backward's launch is a ``torch.autograd.Function`` of its
  own, so ``torch.func.vmap(torch.func.grad(...))`` batches it too;
- the ``vmap`` rule (``torch.func.vmap`` over a render, the counterpart of
  ``jax.vmap`` over bindings) follows the layout each wrapper declares:
  which arguments and outputs carry a channel axis, and where. Where
  every batched argument has one, the batch moves into that axis (B·C
  channels, member-major), the kernel launches once on the folded
  tensors, and the channel-axis outputs split back into (B, C); an output
  without a channel axis depends on no channel-axis argument, so it is the
  same for every member and stays unbatched. Where a batched argument has
  no channel axis (a column the kernel shares across channels, a scalar
  state, a mono kernel), the kernel launches once per batch member and
  the outputs are stacked. A backward under ``vmap`` launches once per
  member: its shared columns' cotangents are sums over a member's
  channels, never over all B·C. A buffer updated in place is always
  handed to a launch as a fresh copy: batched values are never written
  into an unbatched buffer.

CPU tensors never come here: the wrappers send them to the plain versions,
which autograd differentiates and ``torch.func.vmap`` batches, as JAX
differentiates and batches the ``lax.scan`` references on the CPU. A call
whose tensors need no gradient and are not batched, or one made under
``torch.no_grad()`` outside ``torch.func``, is the launch alone: the same
kernel, the same launch count, no copies.
"""

from __future__ import annotations

import torch

# When set, called as ``on_backward(name, args, outs, grads, kw, got)`` after
# each backward launch, with the forward's arguments, outputs and keywords,
# the cotangents and the backward's results: a check may record the calls.
on_backward = None


class _Box:
    """A call's keywords handed through ``Function.apply`` as one
    non-tensor operand (``torch.func`` maps pytrees; this is a leaf)."""

    __slots__ = ("kw", "n_args", "n_outs")

    def __init__(self, kw, n_args=0, n_outs=0):
        self.kw, self.n_args, self.n_outs = kw, n_args, n_outs


def transformed(*ts) -> bool:
    """Whether any tensor is a ``torch.func`` transform's wrapper (a batched
    or a grad-tracking tensor): a launch cannot read its memory."""
    return any(isinstance(t, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in ts)


def put_row(buf, i, value, functional: bool):
    """``buf[i] = value`` for a plain version's buffer: in place, or, where
    ``functional`` (its tensors ``transformed``), out of place as a new
    tensor, since ``torch.func.vmap`` cannot write a batched value into an
    unbatched buffer. Returns the buffer that holds the write."""
    if functional:
        return torch.index_put(buf, (torch.as_tensor(i, device=buf.device),), value)
    buf[i] = value
    return buf


def _needs_grad(args) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def _per_member(apply, box, args, dims, B, fresh=()):
    """One ``apply`` per batch member: each batched argument's member
    (arguments in ``fresh`` copied), the outputs stacked on a leading axis."""
    outs = []
    for b in range(B):
        member = []
        for i, (a, d) in enumerate(zip(args, dims)):
            if d is not None:
                a = a.select(d, b)
            if i in fresh and isinstance(a, torch.Tensor):
                a = a.clone()
            member.append(a)
        outs.append(apply(box, *member))
    stacked = tuple(None if o[0] is None else torch.stack(o) for o in zip(*outs))
    return stacked, tuple(None if o is None else 0 for o in stacked)


def _fold(apply, box, args, dims, B, channels, out_channels, fresh):
    """One ``apply`` on the batch folded into the channel axis:
    ``channels[i]`` is argument i's (None: none), ``out_channels[j]``
    output j's."""
    moved = [a.movedim(d, 0) if d is not None else a for a, d in zip(args, dims)]
    C = max(a.shape[ax + (d is not None)] for a, d, ax in zip(moved, dims, channels)
            if ax is not None and isinstance(a, torch.Tensor))
    folded = []
    for i, (a, d, ax) in enumerate(zip(moved, dims, channels)):
        if ax is None or not isinstance(a, torch.Tensor):
            folded.append(a)
            continue
        if d is None:
            if a.shape[ax] == 1 and C > 1:  # a plane the kernel broadcasts
                folded.append(a.clone(memory_format=torch.contiguous_format) if i in fresh else a)
                continue
            a = a.unsqueeze(0).expand(B, *a.shape)
        if a.shape[ax + 1] == 1 and C > 1:
            a = a.expand(*a.shape[:ax + 1], C, *a.shape[ax + 2:])
        a = a.movedim(0, ax).flatten(ax, ax + 1)  # member b's channel c is b * C + c
        folded.append(a.clone(memory_format=torch.contiguous_format) if i in fresh else a)
    outs = apply(box, *folded)
    got, out_dims = [], []
    for j, o in enumerate(outs):
        ax = out_channels[j] if j < len(out_channels) else None
        if ax is None or o is None:
            got.append(o)
            out_dims.append(None)
        else:
            got.append(o.unflatten(ax, (B, o.shape[ax] // B)))
            out_dims.append(ax)
    return tuple(got), tuple(out_dims)


def kernel_function(name: str, launch, backward=None, *, channels=(), out_channels=(),
                    inplace=(), untracked=None):
    """A differentiable, batchable call of ``launch``.

    ``launch(*args, **kw)`` returns a tuple of tensors; ``args`` are
    tensors (or None). ``backward(args, outs, grads, **kw)`` returns one
    cotangent (or None) per argument, given the call's arguments, its
    outputs (None in both for a buffer updated in place) and their
    cotangents (zeros where an output got none; None for an integer
    output). Without ``backward`` the gradient raises.

    The layout, for ``torch.func.vmap``: ``channels[i]`` is the channel
    axis of argument i and ``out_channels[j]`` that of output j (None, or
    missing: none); ``inplace`` lists the arguments the launch updates in
    place. With no channel axes the kernel launches once per batch member.
    ``untracked``, where given, is the launch of a call that goes through
    no Function (no gradient, no ``torch.func``): one that writes no
    residuals the backward alone reads (the ladder's checkpoints). A call
    under ``torch.func`` goes through the Function even where nothing needs
    a gradient (a no-grad ``vmap`` of a render): the Function cannot tell
    from its unwrapped arguments whether an outer ``grad`` will read its
    residuals, so such a call launches ``launch`` and writes them.
    """

    class Bwd(torch.autograd.Function):
        """The backward kernel's launch: (forward's arguments, outputs,
        cotangents) -> one cotangent (or None) per argument."""

        @staticmethod
        def forward(box, *flat):
            args = flat[:box.n_args]
            outs = flat[box.n_args:box.n_args + box.n_outs]
            grads = flat[box.n_args + box.n_outs:]
            got = tuple(backward(args, outs, grads, **box.kw))
            if on_backward is not None:
                on_backward(name, args, outs, grads, box.kw, got)
            return got

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def backward(ctx, *grads):
            raise NotImplementedError(f"{name}: no second-order gradient on the card")

        @staticmethod
        def vmap(info, in_dims, box, *flat):
            return _per_member(Bwd.apply, box, flat, in_dims[1:], info.batch_size)

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(box, *args):
            return tuple(launch(*args, **box.kw))

        @staticmethod
        def setup_context(ctx, inputs, output):
            box, *args = inputs
            given = {id(a) for a in args if isinstance(a, torch.Tensor)}
            dirty = [o for o in output if id(o) in given]  # updated in place
            if dirty:
                ctx.mark_dirty(*dirty)
            ctx.mark_non_differentiable(*(o for o in output if not o.is_floating_point()))
            ctx.box = _Box(box.kw, len(args), len(output))
            if backward is not None:
                gone = {id(o) for o in dirty}  # not saved: a later launch updates it again
                ctx.save_for_backward(*(None if id(t) in gone else t for t in (*args, *output)))

        @staticmethod
        def backward(ctx, *grads):
            if backward is None:
                raise NotImplementedError(
                    f"{name}: no backward kernel on the card (ROADMAP.md, queue 2); "
                    "on the CPU its plain version differentiates")
            saved = ctx.saved_tensors
            box = ctx.box
            args, outs = saved[:box.n_args], saved[box.n_args:]
            grads = tuple(
                None if o is not None and not o.is_floating_point()
                else torch.zeros_like(o) if g is None and o is not None else g
                for o, g in zip(outs, grads))
            got = Bwd.apply(box, *args, *outs, *grads)
            return (None, *(g if need else None
                            for g, need in zip(got, ctx.needs_input_grad[1:])))

        @staticmethod
        def vmap(info, in_dims, box, *args):
            dims = in_dims[1:]
            ch = [channels[i] if i < len(channels) else None for i in range(len(args))]
            if all(ch[i] is not None for i, d in enumerate(dims) if d is not None):
                return _fold(Fn.apply, box, args, dims, info.batch_size, ch, out_channels,
                             inplace)
            return _per_member(Fn.apply, box, args, dims, info.batch_size, inplace)

    def call(*args, **kw):
        if _needs_grad(args) or transformed(*args):
            return Fn.apply(_Box(kw), *args)
        return (untracked or launch)(*args, **kw)

    return call
