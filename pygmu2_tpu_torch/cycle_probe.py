"""Cycle counts of the serial threads in the comb and string kernels, on one
CUDA card: ``python -m pygmu2_tpu_torch.cycle_probe``.

Two measurements, each printed as one JSON line with the card's name:

1. ``chains``: one thread, ``clock64()`` around 2**20 steps of a dependent
   chain, in cycles a step: the string's allpass (a multiply and a
   subtract), the comb's smoother without its select, with the select as
   ``setp``/``selp``, and as a C conditional; and the smoother walking a
   512-sample chunk in shared memory with bounds-tested scalar loads eight
   ahead and register moves between batches, against the 16-byte vector
   walk the kernels use.
2. ``roles``: copies of ``csrc/comb_scan.cu`` and ``csrc/ks_scan.cu`` with
   ``clock64()`` stamps around each role's work in the pipelined loop
   (busy) and around its barrier (wait), run at T = 16384: the comb at
   C = 1 with a 200-240 Hz sweep, the string at L = 133 and 535.

Builds into ``build/cycle_probe/`` beside the package with ``nvcc``; the
kernels' own library is untouched.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from pygmu2_tpu_torch import _ext

_PKG = Path(__file__).resolve().parent
_OUT = _PKG.parent / "build" / "cycle_probe"

_CHAINS = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float smooth_selp(float sf, float f, float a) {
  const float s = __fadd_rn(sf, __fmul_rn(__fsub_rn(f, sf), a));
  float out;
  asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %1, 0f00000000;\n\tselp.f32 %0, %2, %3, p;\n\t}"
      : "=f"(out) : "f"(sf), "f"(f), "f"(s));
  return out;
}
__device__ __forceinline__ float step(float sf, float f, float a) {
  return __fadd_rn(sf, __fmul_rn(__fsub_rn(f, sf), a));
}
constexpr int kN = 512;
__global__ void chains(const float* in, float* out, long long* cyc, int n, int m, float a,
                       int mode) {  // m: the chunk length, a run-time value as in the kernels
  __shared__ __align__(16) float s_in[kN + 8], s_out[kN + 8];
  for (int i = threadIdx.x; i < kN + 8; i += blockDim.x) s_in[i] = in[i & 7];
  __syncthreads();
  if (threadIdx.x != 0) return;
  float x = in[0];
  const long long t0 = clock64();
  if (mode == 0) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = __fsub_rn(in[i & 7], __fmul_rn(a, x));
  } else if (mode == 1) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = step(x, in[i & 7], a);
  } else if (mode == 2) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = smooth_selp(x, in[i & 7], a);
  } else if (mode == 3) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float f = in[i & 7];
      x = x < 0.0f ? f : step(x, f, a);
    }
  } else if (mode == 4) {  // bounds-tested scalar loads, register moves
    for (int r = 0; r < n / m; ++r) {
      float f[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = u < m ? s_in[u] : 0.0f;
      for (int i = 0; i + 8 <= m; i += 8) {
        float g[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) g[u] = i + 8 + u < m ? s_in[i + 8 + u] : 0.0f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          x = step(x, f[u], a);
          s_out[i + u] = x;
          f[u] = g[u];
        }
      }
    }
  } else {  // the kernels' walk: 16-byte vectors, two batches a turn
    const float4* in4 = reinterpret_cast<const float4*>(s_in);
    float4* out4 = reinterpret_cast<float4*>(s_out);
    auto four = [&](float4 v, int i) {
      const float o0 = x = step(x, v.x, a), o1 = x = step(x, v.y, a),
                  o2 = x = step(x, v.z, a), o3 = x = step(x, v.w, a);
      out4[i / 4] = make_float4(o0, o1, o2, o3);
    };
    for (int r = 0; r < n / m; ++r) {
      float4 f0 = in4[0], f1 = in4[1];
      for (int i = 0; i + 16 <= m; i += 16) {
        const float4 g0 = in4[i / 4 + 2], g1 = in4[i / 4 + 3];
        four(f0, i);
        four(f1, i + 4);
        f0 = in4[i / 4 + 4];
        f1 = in4[i / 4 + 5];
        four(g0, i + 8);
        four(g1, i + 12);
      }
    }
  }
  const long long t1 = clock64();
  out[0] = x + s_out[3];
  cyc[0] = t1 - t0;
}
extern "C" int chains_launch(const float* in, float* out, long long* cyc, int n, int m,
                             float a, int mode) {
  if (m > kN || m % 16) return (int)cudaErrorInvalidValue;
  chains<<<1, 256>>>(in, out, cyc, n, m, a, mode);
  return (int)cudaDeviceSynchronize();
}
"""

_READ = """
__device__ long long g_cycles[8];
extern "C" int read_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(long long) * 8);
}
"""


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"cycle_probe: the kernel source changed; not found: {old!r}")
    return text.replace(old, new, 1)


def _instrumented(src: str, loop: str, barrier: str, tail: str, start: str, end: str,
                  roles: tuple) -> str:
    """``src`` with each pipelined-loop iteration's busy and barrier-wait
    cycles summed per thread, and written to ``g_cycles`` for ``roles``."""
    s = (_PKG / "csrc" / src).read_text()
    s = _replace(s, "namespace {", _READ + "namespace {")
    s = _replace(s, start, "  long long busy = 0, waited = 0;\n" + start)
    s = _replace(s, loop, loop + "\n      const long long a0 = clock64();")
    s = _replace(s, barrier + tail, "const long long a1 = clock64(); busy += a1 - a0;\n"
                 + barrier + "\n    waited += clock64() - a1;" + tail)
    record = " || ".join(f"tid == {t}" for t in roles)
    return _replace(s, end, f"  if ({record}) {{ g_cycles[2 * (tid / 32)] = busy;"
                    " g_cycles[2 * (tid / 32) + 1] = waited; }\n" + end)


def _build(name: str, text: str) -> ctypes.CDLL:
    _OUT.mkdir(parents=True, exist_ok=True)
    src, lib = _OUT / f"{name}.cu", _OUT / f"{name}.so"
    src.write_text(text)
    nvcc = _ext._nvcc()
    if nvcc is None:
        raise RuntimeError("cycle_probe: nvcc not found")
    subprocess.run([nvcc, *_ext.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def chains(card: str) -> dict:
    lib = _build("chains", _CHAINS)
    p = ctypes.c_void_p
    lib.chains_launch.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int]
    dev = torch.device("cuda")
    vals = torch.tensor([220.0, 221.0, 219.5, 230.0, 210.0, 225.0, 215.0, 240.0], device=dev)
    out = torch.empty(1, device=dev)
    cyc = torch.empty(1, dtype=torch.int64, device=dev)
    n = 1 << 20
    names = ["allpass chain", "smoother, no select", "smoother, setp/selp",
             "smoother, C conditional", "smoother walk, bounds-tested scalar loads",
             "smoother walk, 16-byte vectors"]
    result = {"probe": "chains", "card": card, "cycles_per_step": {}}
    for mode, name in enumerate(names):
        a = 0.35 if mode == 0 else 1.0 / 2400
        for _ in range(2):  # the second launch is the one kept
            err = lib.chains_launch(vals.data_ptr(), out.data_ptr(), cyc.data_ptr(), n, 512, a,
                                    mode)
            if err:
                raise RuntimeError(f"cycle_probe: chains launch failed ({err})")
        result["cycles_per_step"][name] = cyc.item() / n
    return result


def roles(card: str) -> dict:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T = 16384
    cycles = (ctypes.c_longlong * 8)()
    result = {"probe": "roles", "card": card, "T": T}

    comb = _build("comb_roles", _instrumented(
        "comb_scan.cu", "for (int j = 0; j <= n_chunks + 1; ++j) {",
        "    unsafe = __syncthreads_or(bad);", "  // chunk j + 1's",
        "  float sf = *sf_in;  // thread 0", "  if (tid == 0) {\n    *sf_out = sf;",
        (0, 32, 64)))
    comb.comb_scan_launch.argtypes = [p] * 13 + [i, i, i, f, f, p]
    C, L = 1, 2206
    x = torch.from_numpy(rng.uniform(-1, 1, (T, C)).astype(np.float32)).to(dev)
    freq = torch.from_numpy(rng.uniform(200, 240, T).astype(np.float32)).to(dev)
    ins = [x, freq, torch.full((T,), 0.5, device=dev), torch.zeros((L, C), device=dev),
           torch.tensor(3, dtype=torch.int32, device=dev), torch.tensor(-1.0, device=dev)]
    outs = [torch.empty((T, C), device=dev), torch.empty((L, C), device=dev),
            torch.empty((), dtype=torch.int32, device=dev), torch.empty((), device=dev),
            torch.empty(T, dtype=torch.int32, device=dev),
            torch.empty(T + 1, dtype=torch.int32, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev)]
    stream = torch.cuda.current_stream().cuda_stream
    comb.comb_scan_launch(*[t.data_ptr() for t in ins + outs], T, C, L, 44100.0, 1 / 2400,
                          stream)
    torch.cuda.synchronize()
    comb.read_cycles(cycles)
    result["comb C=1"] = {
        role: {"busy": cycles[2 * k], "wait": cycles[2 * k + 1]}
        for k, role in enumerate(("thread 0: smoother", "warp 1: window cuts",
                                  "warps 2-7: staging, delays"))}
    result["comb C=1"]["windows"] = int(outs[6])

    ks = _build("ks_roles", _instrumented(
        "ks_scan.cu", "for (int j = 0; j <= n_win; ++j) {", "__syncthreads();",
        "\n    }\n#pragma unroll 4\n    for (int k = tid; k < K;",
        "    // ---- 2. windows of W active samples, pipelined ----",
        "#pragma unroll 4\n    for (int k = tid; k < K; k += kThreads) y[idx[k]] = rho_c[k];",
        (0, 32)))
    ks.ks_scan_launch.argtypes = [p] * 13 + [i, i, f, p]
    for L in (133, 535):
        ins = [torch.full((T,), 0.995, device=dev), torch.arange(T, device=dev) >= 100,
               torch.from_numpy(rng.uniform(-0.3, 0.3, L).astype(np.float32)).to(dev),
               torch.tensor(3, dtype=torch.int32, device=dev), torch.tensor(0.0, device=dev),
               torch.tensor(0.0, device=dev)]
        outs = [torch.empty(T, device=dev), torch.empty(L, device=dev),
                torch.empty((), dtype=torch.int32, device=dev), torch.empty((), device=dev),
                torch.empty((), device=dev), torch.empty(T, dtype=torch.int32, device=dev),
                torch.empty(T, device=dev)]
        ks.ks_scan_launch(*[t.data_ptr() for t in ins + outs], T, L, 0.35, stream)
        torch.cuda.synchronize()
        ks.read_cycles(cycles)
        result[f"ks L={L}"] = {
            role: {"busy": cycles[2 * k], "wait": cycles[2 * k + 1]}
            for k, role in enumerate(("thread 0: allpass", "warps 1-7: emit, form, stage"))}
    return result


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cycle_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(json.dumps(chains(card)))
    print(json.dumps(roles(card)))


if __name__ == "__main__":
    main()
