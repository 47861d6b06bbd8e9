"""PyTorch port, control pass: ``_control_device`` against the JAX one.

Same schedule (the bench score through the bench font, 3 s, so the
note-offs at 2 s release every voice) into both packages' control
passes, in one pass and in streaming carry mode over several segments.
A seeded perturbation of the schedule turns on the branches the bench
score does not reach: LOOP_UNTIL_NOTE_OFF voices (``mode3_any``) and
mod-LFO-modulated cutoffs (``dynamic_any``).

Tolerances: bool and int planes exact; float32 planes rtol 1e-6,
atol 1e-7 (XLA's and PyTorch's pow/exp/cos differ by an ulp); ``base_pos``
within 1e-6 absolute (the float64 advance cumsum regroups). The one
exception is ``a1 = -2 cos(w) / a0``: it crosses zero where the cutoff
nears sr/4, and there an ulp of ``w`` is an absolute error of ~4e-7 in a
value near 0, so it is held to rtol 1e-6 of its scale (2), atol 2e-6.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import bench
from pygmu2_tpu.soundfont import offline as joff
from pygmu2_tpu_torch.soundfont import offline as toff
from pygmu2_tpu_torch.soundfont.convert import schedule_to_torch, to_torch
from pygmu2_tpu_torch.soundfont.model import LoopMode

torch.set_num_threads(1)

SECONDS = 3.0
SEG_BLOCKS = 40  # 130 blocks -> 4 segments


@functools.cache
def _jax_control():
    return jax.jit(
        joff._control_device,
        static_argnums=(6, 7, 8, 9),
        static_argnames=("with_carry",),
    )


def _perturb(par_np, seed):
    """Seeded per-voice perturbation, the same for every snapshot: a mod
    LFO on the cutoff of a third of the voices, LOOP_UNTIL_NOTE_OFF on
    another third."""
    rng = np.random.default_rng(seed)
    P = par_np["key"].shape[1]
    pick = rng.integers(0, 3, P)
    dyn, m3 = pick == 1, pick == 2
    par = {k: v.copy() for k, v in par_np.items()}
    par["modlfo2cut"][:, dyn] = rng.uniform(-2400, 2400, dyn.sum()).astype(np.float32)
    par["mod_period"][:, dyn] = rng.uniform(0.05, 0.5, dyn.sum()).astype(np.float32)
    par["mod_delay"][:, dyn] = rng.uniform(0.0, 0.2, dyn.sum()).astype(np.float32)
    par["loop_mode"][:, m3] = int(LoopMode.LOOP_UNTIL_NOTE_OFF)
    return par


@pytest.fixture(scope="module")
def workload():
    synth, midi = bench.build_workload(False)
    return synth, midi


def _consts(synth):
    return synth.block_size, int(synth._minimum_voice_duration), float(synth.sample_rate)


def _run_jax(par_np, ch_np, snap_idx, synth, b0=None, carry=None):
    N, min_dur, sr = _consts(synth)
    *planes, flags = joff._pack_schedule_np(par_np, ch_np)
    args = (*planes, np.asarray(snap_idx, np.int32), N, flags, min_dur, sr)
    if carry is None:
        return jax.tree.map(np.asarray, _jax_control()(*args))
    ctrl, c = _jax_control()(*args, b0=np.int32(b0), carry=carry, with_carry=True)
    return jax.tree.map(np.asarray, ctrl), jax.tree.map(np.asarray, c)


def _run_torch(par_np, ch_np, snap_idx, synth, b0=None, carry=None):
    N, min_dur, sr = _consts(synth)
    planes, flags = schedule_to_torch(par_np, ch_np, snap_idx, "cpu")
    if carry is None:
        return toff._control_device(*planes, N, flags, min_dur, sr)
    return toff._control_device(
        *planes, N, flags, min_dur, sr, b0=b0, carry=carry, with_carry=True
    )


def _assert_close(jax_tree, torch_tree, what):
    assert jax_tree.keys() == torch_tree.keys(), what
    for k, ref in jax_tree.items():
        got = torch_tree[k].numpy()
        msg = f"{what}: {k}"
        assert got.shape == ref.shape, msg
        if ref.dtype == np.bool_ or np.issubdtype(ref.dtype, np.integer):
            np.testing.assert_array_equal(got, ref, err_msg=msg)
        elif k in ("base_pos", "adv_cs", "sg_adv", "bar_v"):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=msg)
        else:
            atol = 2e-6 if k == "a1" else 1e-7
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=atol, err_msg=msg)


@pytest.mark.parametrize("perturb", [False, True], ids=["bench", "mode3_dynamic"])
def test_control_monolithic(workload, perturb):
    synth, midi = workload
    par_np, ch_np, snap_idx, _nb = synth.build_schedule(midi, SECONDS)
    if perturb:
        par_np = _perturb(par_np, seed=3)
    flags = schedule_to_torch(par_np, ch_np, snap_idx, "cpu")[1]
    assert flags == (perturb, perturb)
    ref = _run_jax(par_np, ch_np, snap_idx, synth)
    got = _run_torch(par_np, ch_np, snap_idx, synth)
    _assert_close(ref, got, "monolithic")
    assert ref["alive"].any() and not ref["alive"][-1].all()  # releases land


@pytest.mark.parametrize("perturb", [False, True], ids=["bench", "mode3_dynamic"])
def test_control_carry_segments(workload, perturb):
    """Streaming carry mode: each package threads its own carry across
    4 segments; segments, carries and the concatenation match, and the
    JAX carry handed to the port mid-stream continues identically."""
    synth, midi = workload
    mono = _run_torch(
        *synth.build_schedule(midi, SECONDS)[:3], synth
    ) if not perturb else None
    j_carry = joff._stream_carry_init(128)
    t_carry = toff._stream_carry_init(128, "cpu")
    b0, n_seg, parts = 0, 0, []
    for par_np, ch_np, snap_idx, nb in synth.build_schedule_segments(
        midi, SECONDS, SEG_BLOCKS
    ):
        if perturb:
            par_np = _perturb(par_np, seed=3)
        ref, j_next = _run_jax(par_np, ch_np, snap_idx, synth, b0, j_carry)
        got, t_next = _run_torch(par_np, ch_np, snap_idx, synth, b0, t_carry)
        _assert_close(ref, got, f"segment {n_seg}")
        _assert_close(j_next, t_next, f"carry after segment {n_seg}")
        # the JAX carry, converted, drives the port to the same segment
        got2, _ = _run_torch(
            par_np, ch_np, snap_idx, synth, b0, to_torch(j_carry, "cpu")
        )
        _assert_close(ref, got2, f"segment {n_seg} from the JAX carry")
        parts.append(got)
        j_carry, t_carry = j_next, t_next
        b0 += nb
        n_seg += 1
    assert n_seg >= 3
    if mono is not None:  # segments == one pass
        for k, v in mono.items():
            cat = torch.cat([p[k] for p in parts])
            if v.dtype == torch.float64:
                torch.testing.assert_close(cat, v, rtol=0, atol=1e-6)
            else:
                torch.testing.assert_close(cat, v, rtol=0, atol=0, msg=k)
