"""Autograd for the port's CUDA kernels.

Counterpart of ``pygmu2_tpu.ops.diffable``. In the JAX package a Pallas
kernel has no autodiff rule, so ``kernel_with_scan_vjp`` gives each one a
custom VJP: the kernel forward, ``jax.vjp`` of its ``lax.scan`` reference
backward. Here a wrapper launches its kernel through ``ctypes`` and gets
tensors with no ``grad_fn``; :func:`kernel_function` makes the launch a
``torch.autograd.Function``:

- the forward is the launch as it was; the primal inputs and the outputs
  are saved as residuals (a backward kernel recomputes whatever
  trajectory it needs from them), but for a buffer the launch updates in
  place (the echo's block rings): its old value is gone, and a later
  launch updates it again, so it is not saved and the backward gets None
  for it;
- the backward is a backward kernel's launch (the ladder, the comb, the
  order-2 affine scan, the follower, the slew limiter, the reverse echo,
  the ADSR) or, for a kernel whose backward is not ported yet (the
  string), raises ``NotImplementedError``: the plain version never runs
  on the card as a backward.

CPU tensors never come here: the wrappers send them to the plain versions,
which autograd differentiates, as JAX differentiates the ``lax.scan``
references on the CPU. A call whose tensors need no gradient, or one made
under ``torch.no_grad()``, is the launch alone: the same kernel, the same
launch count, no copies.
"""

from __future__ import annotations

import torch

# When set, called as ``on_backward(name, args, outs, grads, kw, got)`` after
# each backward launch, with the forward's arguments, outputs and keywords,
# the cotangents and the backward's results: a check may record the calls.
on_backward = None


def _needs_grad(args) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def kernel_function(name: str, launch, backward=None):
    """A differentiable call of ``launch``.

    ``launch(*args, **kw)`` returns a tuple of tensors; ``args`` are
    tensors (or None). ``backward(args, outs, grads, **kw)`` returns one
    cotangent (or None) per argument, given the call's arguments, its
    outputs (None in both for a buffer updated in place) and their
    cotangents (zeros where an output got none; None for an integer
    output). Without ``backward`` the gradient raises.
    """

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, kw, *args):
            outs = tuple(launch(*args, **kw))
            given = {id(a) for a in args if isinstance(a, torch.Tensor)}
            dirty = [o for o in outs if id(o) in given]  # updated in place
            if dirty:
                ctx.mark_dirty(*dirty)
            ctx.mark_non_differentiable(*(o for o in outs if not o.is_floating_point()))
            ctx.kw, ctx.n_args = kw, len(args)
            if backward is not None:
                gone = {id(o) for o in dirty}  # not saved: a later launch updates it again
                ctx.save_for_backward(*(None if id(t) in gone else t for t in (*args, *outs)))
            return outs

        @staticmethod
        def backward(ctx, *grads):
            if backward is None:
                raise NotImplementedError(
                    f"{name}: no backward kernel on the card yet (ROADMAP.md, queue 2); "
                    "on the CPU its plain version differentiates")
            saved = ctx.saved_tensors
            args, outs = saved[:ctx.n_args], saved[ctx.n_args:]
            grads = tuple(
                None if o is not None and not o.is_floating_point()
                else torch.zeros_like(o) if g is None and o is not None else g
                for o, g in zip(outs, grads))
            got = backward(args, outs, grads, **ctx.kw)
            if on_backward is not None:
                on_backward(name, args, outs, grads, ctx.kw, got)
            return (None, *(g if need else None
                            for g, need in zip(got, ctx.needs_input_grad[1:])))

    def call(*args, **kw):
        if _needs_grad(args):
            return Fn.apply(kw, *args)
        return launch(*args, **kw)

    return call
