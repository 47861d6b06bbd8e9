"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at
first use, from the sources in this checkout only, into
``build/kernels/`` beside the package; the library's name carries a hash
of the sources (``*.cu`` and the ``*.cuh`` headers they include) and
flags, so an edited source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_BUILD_DIR = _PKG.parent / "build" / "kernels"
# sm_90a: Hopper with its arch-specific instructions; no --use_fast_math
# (the kernels hold parity with the plain PyTorch versions)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)


def _sources() -> list[Path]:
    return sorted((_PKG / "csrc").glob("*.cu"))


def _nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    default = toolkit / "bin" / "nvcc"
    return str(default) if default.exists() else None


def _run_all(commands: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of any that fails."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands
    ]
    failed = []
    for cmd, proc in zip(commands, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile the kernels (or reuse an identical earlier build); returns
    the library path. Raises RuntimeError when nvcc is missing or fails."""
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin, default /usr/local/cuda): "
            "the CUDA kernels need the CUDA toolkit"
        )
    sources = _sources()
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in sources + sorted((_PKG / "csrc").glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = _BUILD_DIR / f"libpygmu2_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources, objs)
        ])
        tmp_lib = Path(tmp) / lib.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)]])
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with its C functions' signatures declared."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    q, d = ctypes.c_longlong, ctypes.c_double
    signatures = {
        # rows_f, rows_i, wave, L, state_in, out, state_out, scratch_f, n_f,
        # scratch_i, n_i, B, P, N, stream
        "osc_filter_gain_mix_launch": [p, p, p, i, p, p, p, p, q, p, q, i, i, i, p],
        # x, al, qa, ki, dsc, state_in, y, state_out, ckpt (or null), every, T,
        # C, os_n, pbg, mode_index, input_threshold, state_decay, stream
        "ladder_scan_launch": [p] * 9 + [i, i, i, i, f, i, f, f, p],
        # x, al, qa, ki, dsc, ckpt, gy, gstate, gx, gcols, gstate_in, transfers,
        # g_end, part, steps (or null), T, C, K, os_n, per, rewalk, pbg,
        # mode_index, input_threshold, state_decay, stream
        "ladder_scan_bwd_launch": [p] * 15 + [i] * 6 + [f, i, f, f, p],
        # fb, buf_in, pos_in, sf_in, y, gy, gbuf, gsf, delay, bounds, n_windows,
        # smoothed, gx, gfreq, gfb, gbuf_in, gsf_in, part, ring (or null), agg,
        # flags, T, C, L, smooth_alpha, stream
        "comb_scan_bwd_launch": [p] * 21 + [i, i, i, f, p],
        # x, freq, fb, buf_in, pos_in, sf_in, y, buf_out, pos_out, sf_out,
        # delay, bounds, n_windows, smoothed, T, C, L, sr, smooth_alpha, stream
        "comb_scan_launch": [p] * 14 + [i, i, i, f, f, p],
        # gate, state_in, env, state_out, env_next, T, dA, dD, dR, sus,
        # sustain_samples (-1: gated), stream
        "adsr_scan_launch": [p] * 5 + [i, f, f, f, f, i, p],
        # trig, stage_in, env_in, ends_in, y, stage_out, env_out, ends_out,
        # T, t0, dA, dD, dR, sus, sustain_samples, dense_above, stream
        "adsr_clock_launch": [p] * 8 + [i, q, d, d, d, d, q, i, p],
        # rho, act, buf_in, r_in, ap_in_in, ap_out_in, y, buf_out, r_out,
        # ap_in_out, ap_out_out, idx, rho_c, T, L, allpass_c, stream
        "ks_scan_launch": [p] * 13 + [i, i, f, p],
        # rho, act (or null), buf, r_in, y, gy, gbuf, gai, gao, grho, gbuf_in,
        # gap_in, gap_out, idx, comp, ring_global, T, L, W, allpass_c, stream
        "ks_scan_bwd_launch": [p] * 16 + [i, i, i, f, p],
        # rho, buf_in, r_in, ap_in_in, ap_out_in, diag, powv, y, buf_out,
        # r_out, ap_in_out, ap_out_out, T, L, B, R, ncta, allpass_c, stream
        "ks_blocked_launch": [p] * 12 + [i, i, i, i, i, f, p],
        # x, env0, env, env_final, T, C, atk, rel, stream
        "envelope_ar_scan_launch": [p] * 4 + [i, i, f, f, p],
        # x, cur_in, y, cur_out, T, linear, p_rise, p_fall, stream
        "slew_scan_launch": [p] * 4 + [i, i, f, f, p],
        # x, env0, env, genv, genv_final, gx, genv0, agg, flags, T, C, atk, rel,
        # stream
        "envelope_ar_scan_bwd_launch": [p] * 9 + [i, i, f, f, p],
        # x, cur_in, y, gy, gcur_out, gx, gcur_in, agg, flags, T, linear, p_rise,
        # p_fall, stream
        "slew_scan_bwd_launch": [p] * 9 + [i, i, f, f, p],
        # gate, state_in, env, genv, gstate_out, genv_next, gstate_in, flags,
        # info (both null for one tile), T, dA, dD, dR, sus, sustain_samples
        # (-1: gated), stream
        "adsr_scan_bwd_launch": [p] * 9 + [i, f, f, f, f, i, p],
        # trig, stage_in, env_in, gy, genv_out, genv_in, T, dA, dD, dR, sus, stream
        "adsr_clock_bwd_launch": [p] * 6 + [i, d, d, d, d, p],
        # x, fb, y, gy, tab, bounds, n_periods, gbuf_a, gbuf_b, gmisc, lam_a,
        # lam_b, pb_in, gpb_out, gline, gfb, gratio, gm, gp, gcs, gfb_part,
        # gp_part, first, count, list, rows (or null), T, C, cap, plen,
        # tile_cap, inv_half, decay, stream
        "reverse_echo_scan_bwd_launch": [p] * 26 + [i, i, i, i, i, f, f, p],
        # x, blk, ratio, fb, alt, buf_a, buf_b, pb_in, misc_in, y, pb_out,
        # misc_out, tab, bounds, n_periods, T, C, sr, plen, cap, min_block,
        # max_block, smooth_alpha, inv_plen, half, inv_half, stream
        "reverse_echo_scan_launch": [p] * 15 + [i, i, f, i, i, i, i, f, f, f, f, p],
        # a11, a12, a21, a22, u1, u2, s01, s02, s1, s2, agg, flags, T, C, chunk,
        # shared, stream
        "affine_scan_2_launch": [p] * 12 + [i, i, i, i, p],
        # a11, a12, a21, a22, g1, g2, s01, s02, s1, s2, ga11, ga12, ga21, ga22,
        # gu1, gu2, gs01, gs02, part, col, agg, flags, T, C, chunk, shared,
        # summed, stream
        "affine_scan_2_bwd_launch": [p] * 22 + [i, i, i, i, i, p],
        # xt, rows, out, scratch_f, n_f, scratch_i, n_i, B, P, N, stream
        "filter_gain_mix_launch": [p, p, p, p, q, p, q, i, i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.pgt_cuda_error_string.argtypes = [i]
    lib.pgt_cuda_error_string.restype = p
    return lib


def raise_on_error(err: int, kernel: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        msg = ctypes.string_at(load().pgt_cuda_error_string(err)).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")


def checked(t: torch.Tensor, name: str, shape: tuple, device) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor of ``shape`` on ``device``, or raise."""
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or t.device != device:
        raise ValueError(
            f"{name}: expected float32 {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()
