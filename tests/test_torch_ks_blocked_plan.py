"""PyTorch port: the string's blocked order in its card kernel's layout.

``csrc/ks_scan.cu`` ``ks_blocked`` gives each of eight lanes one chain
(k mod 8) of a run of R consecutive rows, four runs (a quad) a warp, a
quad a warp where the cluster has a warp for each, else a short quad and a
long one, its warps over a cluster of CTAs
(``ops/ks.blocked_layout``, ``blocked_quads``, ``blocked_steps``). A lane
runs as many steps as its quad's longest row needs, so it adds terms past
its own rows (a diagonal of 0) and past K8 (a u of 0): products by zero,
which leave a chain that starts at +0 as it is. ``ops/ks.ks_blocked_plan``
runs that order in torch ops; here it is held to ``ks_blocked_ref`` (the
JAX package's ``ks_blocked`` as XLA's CPU program rounds it) bit for bit at
every layout that fits: the six chain strings (L = 535, 401, 300, 225, 178,
133), L = 16, 17, 24, 513, 514 and past ``MAX_KERNEL_L``, T not a multiple
of the block, and two calls handed off. The layout's quads cover every
row once with enough steps, for every B; and ``ks_blocked_ref`` stays bit
for bit with the JAX ``ks_blocked``. On the card the kernel is held to
``ks_blocked_ref`` bit for bit (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygmu2_tpu.ops.ks_block import ks_blocked as jax_ks_blocked
from pygmu2_tpu_torch.ops import ks

torch.set_num_threads(1)

CHAIN_LS = (535, 401, 300, 225, 178, 133)
EDGE_LS = (16, 17, 24, 513, 514, ks.MAX_KERNEL_L + 1)
LAYOUTS = ks.BLOCKED_LAYOUTS + (ks.GLOBAL_LAYOUT,)
C = 0.35


def _case(L, T, seed):
    rng = np.random.default_rng(seed)
    rho = torch.from_numpy(rng.uniform(0.99, 0.9999, T).astype(np.float32))
    buf = torch.from_numpy(rng.uniform(-1.0, 1.0, L).astype(np.float32))
    state = (torch.tensor(int(rng.integers(0, L)), dtype=torch.int32),
             torch.tensor(np.float32(rng.uniform(-0.3, 0.3))),
             torch.tensor(np.float32(rng.uniform(-0.3, 0.3))))
    return rho, buf, state


def _bits(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"output {i} differs"


def _fits(B, layout):
    try:
        ks.blocked_quads(B, *layout)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("L", CHAIN_LS + EDGE_LS)
def test_plan_equals_ref_at_every_layout(L):
    B = min(L - 1, ks.BLOCKED_MAX_B)
    T = 2 * B + 37  # two blocks and a part one
    rho, buf, state = _case(L, T, L)
    want = ks.ks_blocked_ref(rho, buf, *state, L=L, allpass_c=C)
    layouts = [lay for lay in LAYOUTS if _fits(B, lay)]
    assert (16, 1) in layouts and ks.blocked_layout(B) in layouts
    for layout in layouts:
        _bits(ks.ks_blocked_plan(rho, buf, *state, L=L, allpass_c=C, layout=layout), want)


@pytest.mark.parametrize("L", CHAIN_LS + (17, 514))
def test_plan_hands_off_across_calls(L):
    """Blocks start at each call's first sample: two calls of the plan (the
    default layout) against two calls of the plain version."""
    B = min(L - 1, ks.BLOCKED_MAX_B)
    T = B + B // 2 + 11
    rho, buf, state = _case(L, T, L + 1)
    cut = B // 2 + 3
    ref1 = ks.ks_blocked_ref(rho[:cut], buf, *state, L=L, allpass_c=C)
    ref2 = ks.ks_blocked_ref(rho[cut:], *ref1[1:], L=L, allpass_c=C)
    got1 = ks.ks_blocked_plan(rho[:cut], buf, *state, L=L, allpass_c=C)
    got2 = ks.ks_blocked_plan(rho[cut:], *got1[1:], L=L, allpass_c=C)
    _bits(got1, ref1)
    _bits(got2, ref2)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_quads_cover_every_row_with_enough_steps(layout):
    R, ncta = layout
    for B in range(15, ks.BLOCKED_MAX_B + 1):
        if not _fits(B, layout):
            continue
        K8 = B - B % 8
        seen = np.zeros(B, np.int64)
        quads = ks.blocked_quads(B, R, ncta)
        assert len(quads) <= ncta * ks.BLOCKED_WARPS
        for qa, qb in quads:
            for q in (qa, qb):
                if q < 0:
                    continue
                rows = np.arange(4 * R * q, 4 * R * (q + 1))
                rows = rows[rows < B]
                seen[rows] += 1
                need = (np.minimum(rows + 1, K8) + 7) // 8  # a row's steps of eight terms
                assert ks.blocked_steps(B, R, q) >= need.max(initial=0)
        assert (seen == 1).all(), (B, layout)


def test_default_layout_fits_every_block():
    for B in range(15, ks.BLOCKED_MAX_B + 1):
        assert _fits(B, ks.blocked_layout(B)), B


@pytest.mark.parametrize("layout", ((4, 1), (8, 2), (2, 4), (16, 8)))
def test_layouts_the_kernel_lacks_are_refused(layout):
    """The kernel is built for ``BLOCKED_LAYOUTS`` only."""
    assert not _fits(256, layout)


@pytest.mark.parametrize("L", CHAIN_LS + (16, 17, 24, 513))
def test_ref_equals_jax_ks_blocked(L):
    B = min(L - 1, ks.BLOCKED_MAX_B)
    T = 2 * B + 37
    rho, buf, (r, ai, ao) = _case(L, T, L + 2)
    want = jax_ks_blocked(jnp.asarray(rho.numpy()), jnp.asarray(buf.numpy()),
                          jnp.asarray(int(r), jnp.int32), jnp.asarray(float(ai), jnp.float32),
                          jnp.asarray(float(ao), jnp.float32), L=L, allpass_c=C)
    got = ks.ks_blocked_ref(rho, buf, r, ai, ao, L=L, allpass_c=C)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.array_equal(g.numpy().view(np.int32) if w.dtype == np.float32 else g.numpy(),
                              w.view(np.int32) if w.dtype == np.float32 else w)
