"""Counter-based noise primitives (counterpart of ``pygmu2_tpu.ops.noise``).

White noise is a hash of (seed, absolute sample index): stateless,
block-invariant (chunked rendering equals one-shot) and parallel; the
pink and brown colors filter that white stream. The JAX package hashes
in uint32; torch has no unsigned 32-bit arithmetic, so the hash runs on
int64 holding uint32 values, masked to 32 bits after every multiply: the
low 32 bits of a product do not depend on its wrapped high bits, so the
result is the JAX hash bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF


def _fmix32(x):
    """murmur3 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK
    return x ^ (x >> 16)


def _seed_word(seed: int, lane: int) -> int:
    return (seed * 0x9E3779B9 + lane * 0x85EBCA6B + 0x27D4EB2F) & _MASK


def hash_u32(t, seed: int = 0, lane: int = 0):
    """The 32-bit hash of each absolute sample index (an int64 tensor of
    uint32 values): the word :func:`white_uniform` scales."""
    t = t.to(torch.int64)
    s = _seed_word(seed, lane)
    x = _fmix32((t & _MASK) ^ s)
    return _fmix32(x ^ ((t >> 32) & _MASK) ^ ((s * 0x01000193) & _MASK))


def white_uniform(t, seed: int = 0, lane: int = 0):
    """Uniform noise in [-1, 1) indexed by absolute sample position.

    Args:
        t: int64 tensor of absolute sample indices (any shape).
        seed: stream seed.
        lane: sub-stream index (e.g. channel or voice) so parallel streams
            decorrelate.
    """
    # 32-bit value -> [-1, 1): one rounding to float32, an exact scaling,
    # one rounding of the difference
    return hash_u32(t, seed, lane).to(torch.float32) * (2.0 ** -31) - 1.0


def white_uniform_np(t, seed: int = 0, lane: int = 0):
    """Numpy mirror of white_uniform — bit-identical, for host-side
    precomputations (TralfamPE's one-time spectral scramble). A copy of the
    JAX package's."""
    tt = np.asarray(t)
    lo = (tt & 0xFFFFFFFF).astype(np.uint32)
    hi = ((tt >> 32) & 0xFFFFFFFF).astype(np.uint32)
    s = np.uint32(_seed_word(seed, lane))

    def fmix(x):
        x = x ^ (x >> np.uint32(16))
        x = (x * np.uint32(0x7FEB352D)).astype(np.uint32)
        x = x ^ (x >> np.uint32(15))
        x = (x * np.uint32(0x846CA68B)).astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
        return x

    with np.errstate(over="ignore"):
        x = fmix(lo ^ s)
        x = fmix(x ^ hi ^ np.uint32((int(s) * 0x01000193) & 0xFFFFFFFF))
    return (x.astype(np.float32) * np.float32(2.0**-31)) - np.float32(1.0)
