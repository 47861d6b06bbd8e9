"""The repo's examples as the port's parity suite: the shared helper of
``tests/test_torch_examples_a.py`` and ``_b.py``.

Each example under ``examples/`` that has a ``build()`` is imported twice
by ``pygmu2_tpu_torch.example_loader``, once against a stand-in
``_common`` whose ``pg`` is the JAX package and once against one whose
``pg`` is the port. The head of each graph, 16384 samples as
``tests/test_examples_smoke.py`` renders it, goes through both on the CPU
and is held to 1e-4, the repo's render bound. SuperSawPE's random start
phases (``seed=None`` in ``super_saw_eg``) are pinned to one seed in both
packages.

``python tests/_torch_examples.py [names]`` prints each example's maximum
difference and both packages' walls.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from pygmu2_tpu_torch.example_loader import (  # noqa: F401
    CANNOT_RUN,
    EXAMPLES,
    NO_BUILD,
    RUNNABLE,
    WITH_BUILD,
    pinned_numpy,
    render_head,
)

TOL = 1e-4  # the repo's render bound
# test_torch_examples_a.py takes the first half (alphabetically), _b.py the
# rest: ~45 and ~55 s of both packages' renders on one CPU core
HALF = len(RUNNABLE) // 2


def pin_supersaw_phases(monkeypatch) -> None:
    """Both packages' SuperSawPE draw their phases from one seed."""
    import pygmu2_tpu.models.osc_bandlimited as jax_osc
    import pygmu2_tpu_torch.models.osc_bandlimited as torch_osc

    for mod in (jax_osc, torch_osc):
        monkeypatch.setattr(mod, "np", pinned_numpy())


def compare(name: str, tmp_path: Path) -> tuple[float, float]:
    """(max abs difference, peak) of the example's head, the port on the
    CPU against the JAX package."""
    import pygmu2_tpu as jpg
    import pygmu2_tpu_torch as tpg

    want = render_head(name, jpg, tmp_path / "jax")
    got = render_head(name, tpg, tmp_path / "torch", device="cpu")
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got.astype(np.float64) - want).max()), float(np.abs(want).max())


if __name__ == "__main__":
    import tempfile
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    import pygmu2_tpu as jpg
    import pygmu2_tpu.models.osc_bandlimited as jax_osc
    import pygmu2_tpu_torch as tpg
    import pygmu2_tpu_torch.models.osc_bandlimited as torch_osc

    jax_osc.np = torch_osc.np = pinned_numpy()
    with tempfile.TemporaryDirectory() as tmp:
        for name in sys.argv[1:] or RUNNABLE:
            t0 = time.perf_counter()
            want = render_head(name, jpg, Path(tmp) / "jax")
            t1 = time.perf_counter()
            got = render_head(name, tpg, Path(tmp) / "torch", device="cpu")
            t2 = time.perf_counter()
            err = float(np.abs(got.astype(np.float64) - want).max())
            print(f"{name:28s} max abs diff {err:.3g} (peak {np.abs(want).max():.3g}; "
                  f"jax {t1 - t0:.1f} s, port {t2 - t1:.1f} s)", flush=True)
