"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at
first use, from the sources in this checkout only, into
``build/kernels/`` beside the package; the library's name carries a hash
of the sources and flags, so an edited source builds anew and an
unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_BUILD_DIR = _PKG.parent / "build" / "kernels"
# sm_90a: Hopper with its arch-specific instructions; no --use_fast_math
# (the kernels hold parity with the plain PyTorch versions)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
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
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = _BUILD_DIR / f"libpygmu2_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with its C functions' signatures declared."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.osc_filter_gain_mix_launch
    # rows_f, rows_i, wave, L, state_in, out, state_out, scratch, B, P, N, stream
    fn.argtypes = [p, p, p, i, p, p, p, p, i, i, i, p]
    fn.restype = i
    lib.pgt_cuda_error_string.argtypes = [i]
    lib.pgt_cuda_error_string.restype = p
    return lib
