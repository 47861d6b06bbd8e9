"""PyTorch port: the repo's examples (first half), each head of 16384
samples through the JAX package and the port on the CPU, within 1e-4, the
repo's render bound. The shared helper is tests/_torch_examples.py; the
second half is in test_torch_examples_b.py.

Observed (CPU): bit for bit but 04_filtering 5.33e-6, 10_compression
1.31e-6, 11_dynamics 3.58e-7, 15_reverse_pitch_echo 3.73e-9 and
17_ladder_filter 1.42e-7 (05_flanging 1.64e-3 before SinePE took glibc's
``sinf``).

Named, not run: ``07_soft_clipping`` cannot run on the port (its reason in
``CANNOT_RUN``); ``40_soundfont_midi`` and ``gradient_fit_eg`` have no
``build()`` (``NO_BUILD``).
"""

import pytest
import torch

import _torch_examples as ex

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ex.RUNNABLE[:ex.HALF])
def test_example_head_matches_jax(name, tmp_path, monkeypatch):
    ex.pin_supersaw_phases(monkeypatch)
    err, peak = ex.compare(name, tmp_path)
    assert peak > 1e-4, f"{name} rendered silence"
    assert err <= ex.TOL, f"{name}: {err}"


def test_every_example_is_run_or_named():
    files = sorted(p.stem for p in ex.EXAMPLES.glob("*.py") if p.stem != "_common")
    assert sorted(ex.RUNNABLE + list(ex.CANNOT_RUN) + list(ex.NO_BUILD)) == files
    assert len(ex.RUNNABLE) == 34 and set(ex.CANNOT_RUN) <= set(ex.WITH_BUILD)
    assert not set(ex.NO_BUILD) & set(ex.WITH_BUILD)


def test_soft_clipping_cannot_run_on_the_port(tmp_path):
    """Its TransformPE calls jnp.tanh, a JAX function, on the port's
    torch tensors."""
    import pygmu2_tpu_torch as tpg

    with pytest.raises(TypeError, match="torch.Tensor"):
        ex.render_head("07_soft_clipping", tpg, tmp_path, device="cpu", head=1024)
