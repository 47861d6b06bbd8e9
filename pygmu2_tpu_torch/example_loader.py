"""The repo's examples on the port.

Each example under ``examples/`` takes its package from
``examples/_common.py``, which imports the JAX package. ``load_example``
imports an example against a stand-in ``_common`` whose ``pg`` is a
package given by the caller (the port, or the JAX package in the parity
tests), and ``render_head`` renders the head of its ``build()``:

    from pygmu2_tpu_torch import example_loader as ex
    import pygmu2_tpu_torch as pg
    out = ex.render_head("05_flanging", pg, Path("build/examples"), device="cuda")

- ``make_drum_wav`` and the examples' fixed ``/tmp`` folders
  (``12_audio_library``, ``demo_asset_manager``) write under the folder
  given, not to paths that concurrent runs would share.
- SuperSawPE draws its voices' start phases from
  ``np.random.default_rng(seed)``, so a SuperSawPE with ``seed=None``
  (``super_saw_eg``) differs at every construction;
  ``pinned_numpy()`` is a numpy whose ``random.default_rng(None)`` draws
  from one seed, to set as a module's ``np``.

``CANNOT_RUN`` names the example that cannot run on the port, with its
reason; ``NO_BUILD`` the scripts that have no ``build()``.
"""

from __future__ import annotations

import importlib.util
import sys
import types
from pathlib import Path

import numpy as np

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
HEAD = 16384  # samples, as tests/test_examples_smoke.py renders them
SR = 44100
PINNED_SEED = 1234

WITH_BUILD = sorted(p.stem for p in EXAMPLES.glob("*.py")
                    if "def build()" in p.read_text() and p.stem != "_common")
CANNOT_RUN = {
    "07_soft_clipping": "hands TransformPE a JAX function, jnp.tanh "
                        "(examples/07_soft_clipping.py:14); the port's TransformPE "
                        "calls its function on torch tensors",
}
NO_BUILD = {
    "40_soundfont_midi": "a script on pygmu2_tpu.soundfont; the port's soundfont and "
                         "MIDI tests cover its path (tests/test_torch_synth_stream.py, "
                         "test_torch_meltysynth_pe.py)",
    "gradient_fit_eg": "a jax.grad fit; the port's fit tests cover its path "
                       "(tests/test_torch_param_grad.py, test_torch_fit_chain.py)",
}
RUNNABLE = [n for n in WITH_BUILD if n not in CANNOT_RUN]


def pinned_numpy() -> types.ModuleType:
    """numpy, but ``random.default_rng(None)`` draws from PINNED_SEED."""
    ns = types.ModuleType("numpy_pinned")
    ns.__getattr__ = lambda name: getattr(np, name)
    ns.random = types.SimpleNamespace(default_rng=lambda seed=None: np.random.default_rng(
        PINNED_SEED if seed is None else seed))
    return ns


def _stand_in(pg, folder: Path, device) -> types.ModuleType:
    """``examples/_common.py``'s names, with ``pg`` the given package (the
    port rendering on ``device``) and the drum written under ``folder``."""
    common = types.ModuleType("_common")
    on = {} if device is None else {"device": device}
    pg.set_sample_rate(SR)
    common.pg, common.SAMPLE_RATE = pg, SR

    def finish(graph, name: str) -> None:
        pg.render_to_file(graph, str(folder / f"{name}.wav"), **on)

    def make_drum_wav(path: str | None = None, seconds: float = 0.6) -> str:
        # examples/_common.py's synthetic hit, bounced through ``pg``
        path = str(folder / "pygmu2_tpu_drum.wav") if path is None else path
        n = int(seconds * SR)
        t = np.arange(n) / SR
        rng = np.random.default_rng(7)
        body = np.sin(2 * np.pi * (80.0 + 60.0 * np.exp(-t * 18.0)) * t)
        snap = rng.standard_normal(n) * np.exp(-t * 40.0) * 0.4
        data = ((body * np.exp(-t * 6.0) + snap) * 0.7).astype(np.float32)
        pg.render_to_file(pg.ArrayPE(data[:, None]), path, **on)
        return path

    common.finish, common.make_drum_wav = finish, make_drum_wav
    return common


def load_example(name: str, pg, folder: Path, device=None) -> types.ModuleType:
    """Imports ``examples/<name>.py`` against a stand-in ``_common`` for
    ``pg`` (the port on ``device``; None for the JAX package), its ``/tmp``
    folders moved under ``folder``. The module and the stand-in leave
    ``sys.modules`` again."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    saved = sys.modules.get("_common")
    sys.modules["_common"] = _stand_in(pg, folder, device)
    sys.modules.pop(name, None)
    try:
        spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            sys.modules.pop("_common", None)
        else:
            sys.modules["_common"] = saved
    if hasattr(mod, "Path"):  # the examples' fixed /tmp folders
        mod.Path = lambda p, *rest: (folder / Path(p).name if str(p).startswith("/tmp/")
                                     else Path(p, *rest))
    return mod


def render_head(name: str, pg, folder: Path, device=None, head: int = HEAD) -> np.ndarray:
    """The first ``head`` samples of the example's graph through ``pg``
    (the port on ``device``; None for the JAX package), a host array."""
    graph = pg.CropPE(load_example(name, pg, folder, device).build(), 0, head)
    if device is None:
        return np.asarray(pg.render_to_array(graph))
    return pg.render_to_array(graph, device=device)
