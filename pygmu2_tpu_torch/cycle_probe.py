"""Cycle counts of the serial threads and the roles of the port's kernels,
on one CUDA card: ``python -m pygmu2_tpu_torch.cycle_probe [name ...]``
(names: the keys of ``PROBES``; all by default).

Each measurement prints one JSON line with the card's name:

1. ``chains``: one thread, ``clock64()`` around 2**20 steps of a dependent
   chain, in cycles a step: the string's allpass (a multiply and a
   subtract), the comb's smoother without its select, with the select as
   ``setp``/``selp``, and as a C conditional; the smoother walking a
   512-sample chunk in shared memory with bounds-tested scalar loads eight
   ahead and register moves between batches, against the 16-byte vector
   walk the kernels use; the envelope follower's step with its
   coefficient selected before the multiply (its first design), with the
   two products formed and one selected (in C, and by ``setp``/``selp``),
   with the attack coefficient alone (its chain without a select), with
   the products or the coefficient picked by a mask in a register
   (``set``, ``lop3``: no predicate), and with both updates formed and one
   selected or picked last; and the slew limiter's steps: LINEAR's clip
   as ``fminf``/``fmaxf``, as ``setp``/``selp``, and as three sums formed
   and one selected, EXPONENTIAL's coefficient selected, and both updates
   formed and one selected.
2. ``roles``: copies of ``csrc/comb_scan.cu``, ``csrc/ks_scan.cu`` and
   ``csrc/ks_scan_bwd.cu`` with ``clock64()`` stamps around each role's
   work in the pipelined loop (busy) and around its barrier (wait), run at
   T = 16384: the comb at C = 1 with a 200-240 Hz sweep, the string and
   its backward at L = 133 and 535 (the backward in both orders: a
   100-sample head of inactive samples, and every sample active), with
   the backward chain's cycles a sample (thread 0's busy cycles over the
   active samples).
3. ``follower`` and ``slew``: copies of ``csrc/envelope_ar_scan.cu`` and
   ``csrc/slew_scan.cu`` with ``clock64()`` around each warp's whole run
   and its mbarrier waits, at T = 16384: the follower at C = 1 and 128,
   the slew limiter in both modes.
4. ``osc``: a copy of ``csrc/osc_filter_gain_mix.cu`` (with the segment
   pass of ``csrc/filter_pass.cuh`` inlined) with ``clock64()``
   around each role's work (``OSC_ROLES``), summed over the CUDA blocks,
   on the bench's rows: the 3 s chord through both fonts and the 60 s
   piece's first streamed segment.
5. ``adsr``: copies of ``csrc/adsr_scan.cu`` with ``clock64()`` around its
   set-up, each tile's three passes and the whole kernel, at T = 16384 on
   the patch's gate, the many-edges gate, an edge every eight samples and
   every sample; as built, and with the tile's path forced to the edge
   walk and to the per-sample walk (``ADSR_PATHS``).
6. ``blocked``: a copy of ``csrc/ks_scan.cu`` with ``clock64()`` around each
   part of ``ks_blocked``'s block (``BLOCKED_PHASES``), cycles a block for
   warps 0 and 3 of the first CTA, at T = 16384, L = 535 and 133, on each
   layout of ``ops/ks.BLOCKED_LAYOUTS`` that fits.
7. ``clock``: a copy of ``csrc/adsr_scan.cu`` with ``clock64()`` around
   ``adsr_clock``'s passes (``CLOCK_PHASES``), at T = 16384 on four
   triggers, a trigger every 97 samples and every sample, on the run walk
   and forced to the per-sample walk: cycles a run record and a sample.

Builds into ``build/cycle_probe/`` beside the package with ``nvcc``; the
kernels' own library is untouched.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
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
// the follower's step, fma(coeff, x - e, e) with coeff = x > e ? atk : rel
__device__ __forceinline__ float follow_coeff(float e, float x, float atk, float rel) {
  const float coeff = x > e ? atk : rel;
  return __fmaf_rn(coeff, __fsub_rn(x, e), e);
}
__device__ __forceinline__ float follow_products(float e, float x, float atk, float rel) {
  const float d = __fsub_rn(x, e);
  const float up = __fmul_rn(atk, d), down = __fmul_rn(rel, d);
  return __fadd_rn(e, x > e ? up : down);
}
__device__ __forceinline__ float follow_selp(float e, float x, float atk, float rel) {
  const float d = __fsub_rn(x, e);
  const float up = __fmul_rn(atk, d), down = __fmul_rn(rel, d);
  float s;
  asm("{\n\t.reg .pred p;\n\tsetp.gt.f32 p, %1, %2;\n\tselp.f32 %0, %3, %4, p;\n\t}"
      : "=f"(s) : "f"(x), "f"(e), "f"(up), "f"(down));
  return __fadd_rn(e, s);
}
// x > e as an all-ones mask in a register (no predicate), and a bitwise pick
__device__ __forceinline__ unsigned gt_mask(float x, float e) {
  unsigned m;
  asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(m) : "f"(x), "f"(e));
  return m;
}
__device__ __forceinline__ float pick(unsigned m, float a, float b) {  // m ? a : b
  unsigned r;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;"
      : "=r"(r) : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(m));
  return __uint_as_float(r);
}
__device__ __forceinline__ float follow_products_lop3(float e, float x, float atk, float rel) {
  const float d = __fsub_rn(x, e);
  return __fadd_rn(e, pick(gt_mask(x, e), __fmul_rn(atk, d), __fmul_rn(rel, d)));
}
__device__ __forceinline__ float follow_coeff_lop3(float e, float x, float atk, float rel) {
  return __fadd_rn(e, __fmul_rn(pick(gt_mask(x, e), atk, rel), __fsub_rn(x, e)));
}
// both updates formed, one picked last: the compare off the chain's path
__device__ __forceinline__ float follow_results(float e, float x, float atk, float rel) {
  const float d = __fsub_rn(x, e);
  const float up = __fadd_rn(e, __fmul_rn(atk, d)), down = __fadd_rn(e, __fmul_rn(rel, d));
  return x > e ? up : down;
}
__device__ __forceinline__ float follow_results_lop3(float e, float x, float atk, float rel) {
  const float d = __fsub_rn(x, e);
  return pick(gt_mask(x, e), __fadd_rn(e, __fmul_rn(atk, d)), __fadd_rn(e, __fmul_rn(rel, d)));
}
// the slew limiter's steps: LINEAR cur + clip(x - cur, -fall, rise), as
// fminf / fmaxf, as setp/selp, and as the three sums formed and one selected;
// EXPONENTIAL cur + (err > 0 ? rise : fall) * err with the coefficient
// selected, and with both updates formed and one selected
__device__ __forceinline__ float slew_minmax(float cur, float x, float rise, float nfall) {
  return __fadd_rn(cur, fminf(fmaxf(__fsub_rn(x, cur), nfall), rise));
}
__device__ __forceinline__ float slew_selp(float cur, float x, float rise, float nfall) {
  const float d = __fsub_rn(x, cur);
  float c;
  asm("{\n\t.reg .pred p, q;\n\tsetp.lt.f32 p, %1, %2;\n\tselp.f32 %0, %2, %1, p;\n\t"
      "setp.gt.f32 q, %0, %3;\n\tselp.f32 %0, %3, %0, q;\n\t}"
      : "=f"(c) : "f"(d), "f"(nfall), "f"(rise));
  return __fadd_rn(cur, c);
}
__device__ __forceinline__ float slew_sums(float cur, float x, float rise, float nfall) {
  const float d = __fsub_rn(x, cur);
  const float up = __fadd_rn(cur, rise), down = __fadd_rn(cur, nfall), mid = __fadd_rn(cur, d);
  return d > rise ? up : (d < nfall ? down : mid);
}
__device__ __forceinline__ float slew_coeff(float cur, float x, float rise, float fall) {
  const float err = __fsub_rn(x, cur);
  return __fadd_rn(cur, __fmul_rn(err > 0.0f ? rise : fall, err));
}
__device__ __forceinline__ float slew_updates(float cur, float x, float rise, float fall) {
  const float err = __fsub_rn(x, cur);
  const float up = __fadd_rn(cur, __fmul_rn(rise, err));
  const float down = __fadd_rn(cur, __fmul_rn(fall, err));
  return err > 0.0f ? up : down;
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
  } else if (mode == 6) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = follow_coeff(x, in[i & 7], a, a * 0.0625f);
  } else if (mode == 7) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = follow_products(x, in[i & 7], a, a * 0.0625f);
  } else if (mode == 8) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = follow_selp(x, in[i & 7], a, a * 0.0625f);
  } else if (mode == 9) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = __fadd_rn(x, __fmul_rn(a, __fsub_rn(in[i & 7], x)));
  } else if (mode == 10) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = follow_products_lop3(x, in[i & 7], a, a * 0.0625f);
  } else if (mode == 11) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = follow_coeff_lop3(x, in[i & 7], a, a * 0.0625f);
  } else if (mode == 12) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = follow_results(x, in[i & 7], a, a * 0.0625f);
  } else if (mode == 13) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = follow_results_lop3(x, in[i & 7], a, a * 0.0625f);
  } else if (mode == 14) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = slew_minmax(x, in[i & 7], a, -0.2f * a);
  } else if (mode == 15) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = slew_selp(x, in[i & 7], a, -0.2f * a);
  } else if (mode == 16) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = slew_sums(x, in[i & 7], a, -0.2f * a);
  } else if (mode == 17) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = slew_coeff(x, in[i & 7], a, 0.04f * a);
  } else if (mode == 18) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = slew_updates(x, in[i & 7], a, 0.04f * a);
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
__device__ long long g_cycles[16];
extern "C" int read_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(long long) * 16);
}
extern "C" int write_cycles(const long long* in) {
  return (int)cudaMemcpyToSymbol(g_cycles, in, sizeof(long long) * 16);
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
    subprocess.run([nvcc, *_ext.NVCC_FLAGS, "-I", str(_PKG / "csrc"), "-shared", "-o", str(lib),
                    str(src)], check=True)
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
             "smoother walk, 16-byte vectors", "follower, coefficient selected",
             "follower, products selected", "follower, products selected by setp/selp",
             "follower, attack alone (no select)",
             "follower, products picked by a mask (set, lop3)",
             "follower, coefficient picked by a mask (set, lop3)",
             "follower, both updates formed, one selected",
             "follower, both updates formed, one picked by a mask (set, lop3)",
             "slew linear, clip as fminf/fmaxf", "slew linear, clip as setp/selp",
             "slew linear, three sums formed, one selected",
             "slew exponential, coefficient selected",
             "slew exponential, both updates formed, one selected"]
    result = {"probe": "chains", "card": card, "cycles_per_step": {}}
    for mode, name in enumerate(names):
        # the slew's: the wah's rise (40000 / 44100 a sample) and an exponential 0.05
        a = (0.35, 1.0 / 2400, 0.0045, 40000.0 / 44100, 0.05)[
            (mode > 0) + (mode >= 6) + (mode >= 14) + (mode >= 17)]
        for _ in range(2):  # the second launch is the one kept
            err = lib.chains_launch(vals.data_ptr(), out.data_ptr(), cyc.data_ptr(), n, 512, a,
                                    mode)
            if err:
                raise RuntimeError(f"cycle_probe: chains launch failed ({err})")
        result["cycles_per_step"][name] = cyc.item() / n
    return result


def comb_roles_source() -> str:
    return _instrumented(
        "comb_scan.cu", "for (int j = 0; j <= n_chunks + 1; ++j) {",
        "    unsafe = __syncthreads_or(bad);", "  // chunk j + 1's",
        "  float sf = *sf_in;  // thread 0", "  if (tid == 0) {\n    *sf_out = sf;",
        (0, 32, 64))


def ks_roles_source() -> str:
    return _instrumented(
        "ks_scan.cu", "for (int j = 0; j <= n_win; ++j) {", "__syncthreads();",
        "\n    }\n#pragma unroll 4\n    for (int k = tid; k < K;",
        "    // ---- 2. windows of W active samples, pipelined ----",
        "#pragma unroll 4\n    for (int k = tid; k < K; k += kThreads) y[idx[k]] = rho_c[k];",
        (0, 32))


def ks_bwd_roles_source() -> str:
    return _instrumented(
        "ks_scan_bwd.cu", "for (int j = n_win - 1; j >= -1; --j) {", "__syncthreads();",
        "\n    }\n    if (act",
        "    lam = copysignf(0.0f, c);",
        "    if (act != nullptr) {\n#pragma unroll 4\n      for (int k = tid; k < K;",
        (0, 32))


def roles(card: str) -> dict:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T = 16384
    cycles = (ctypes.c_longlong * 16)()
    result = {"probe": "roles", "card": card, "T": T}

    comb = _build("comb_roles", comb_roles_source())
    comb.comb_scan_launch.argtypes = [p] * 14 + [i, i, i, f, f, p]
    C, L = 1, 2206
    x = torch.from_numpy(rng.uniform(-1, 1, (T, C)).astype(np.float32)).to(dev)
    freq = torch.from_numpy(rng.uniform(200, 240, T).astype(np.float32)).to(dev)
    ins = [x, freq, torch.full((T,), 0.5, device=dev), torch.zeros((L, C), device=dev),
           torch.tensor(3, dtype=torch.int32, device=dev), torch.tensor(-1.0, device=dev)]
    outs = [torch.empty((T, C), device=dev), torch.empty((L, C), device=dev),
            torch.empty((), dtype=torch.int32, device=dev), torch.empty((), device=dev),
            torch.empty(T, dtype=torch.int32, device=dev),
            torch.empty(T + 1, dtype=torch.int32, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev), torch.empty(T, device=dev)]
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

    ks = _build("ks_roles", ks_roles_source())
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

    bwd = _build("ks_bwd_roles", ks_bwd_roles_source())
    bwd.ks_scan_bwd_launch.argtypes = [p] * 16 + [i, i, i, f, p]
    from pygmu2_tpu_torch.ops import ks as ks_ops

    def vec(n):
        return torch.from_numpy(rng.uniform(-0.3, 0.3, n).astype(np.float32)).to(dev)

    for L in (133, 535):
        for head in (100, None):  # the per-sample order's call, and the blocked order's
            act = None if head is None else torch.arange(T, device=dev) >= head
            K = T if act is None else int(act.sum())
            ins = [torch.full((T,), 0.995, device=dev), act, vec(L),
                   torch.tensor(3, dtype=torch.int32, device=dev), vec(T), vec(T), vec(L),
                   torch.tensor(0.1, device=dev), torch.tensor(-0.2, device=dev)]
            outs = [torch.empty(T, device=dev), torch.empty(L, device=dev),
                    torch.empty((), device=dev), torch.empty((), device=dev),
                    torch.empty(T, dtype=torch.int32, device=dev), torch.empty(3 * T, device=dev),
                    torch.empty(1, device=dev)]
            ptrs = [None if t is None else t.data_ptr() for t in ins + outs]
            err = bwd.ks_scan_bwd_launch(*ptrs, T, L, ks_ops.bwd_window(L), 0.35, stream)
            if err:
                raise RuntimeError(f"cycle_probe: ks_scan_bwd launch failed ({err})")
            torch.cuda.synchronize()
            bwd.read_cycles(cycles)
            key = f"ks_bwd L={L} {'blocked (all active)' if head is None else 'per sample'}"
            result[key] = {
                role: {"busy": cycles[2 * k], "wait": cycles[2 * k + 1]}
                for k, role in enumerate(("thread 0: chain", "warps 1-7: adjoint, seeds, stage"))}
            result[key]["chain_cycles_per_sample"] = cycles[0] / K
    return result


def _ring_roles_source(src: str, consumer_end: str) -> str:
    """``csrc/<src>`` (a producer warp staging a ring, a consumer) with
    ``clock64()`` around each role's whole run and around its mbarrier
    waits: lane 0 of the consumer and of the producer warp."""
    s = (_PKG / "csrc" / src).read_text()
    s = _replace(s, "namespace {", _READ + "namespace {")
    s = _replace(s, "  __syncthreads();\n", "  __syncthreads();\n  long long waited = 0;\n"
                 "  const long long t_start = clock64();\n")
    for bar in ("full", "done"):
        wait = f"mbar_wait(&{bar}[j % kStages], (j / kStages) & 1);"
        s = _replace(s, wait, "{ const long long w0 = clock64(); " + wait
                     + " waited += clock64() - w0; }")
    record = ("if ((threadIdx.x & 31) == 0 && blockIdx.x == 0) {{ g_cycles[{k}] = "
              "clock64() - t_start; g_cycles[{k} + 1] = waited; }}\n")
    s = _replace(s, "    return;\n", "    " + record.format(k=2) + "    return;\n")
    return _replace(s, consumer_end, "  " + record.format(k=0) + consumer_end)


def follower_roles_source() -> str:
    return _ring_roles_source("envelope_ar_scan.cu", "  if (live) env_final[c] = e;")


def slew_roles_source() -> str:
    return _ring_roles_source("slew_scan.cu", "  *cur_out = cur;")


def follower_roles(card: str) -> dict:
    """The follower's roles at T = 16384 and C = 1, 128."""
    lib = _build("follower_roles", follower_roles_source())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.envelope_ar_scan_launch.argtypes = [p] * 4 + [i, i, f, f, p]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T = 16384
    cycles = (ctypes.c_longlong * 16)()
    result = {"probe": "follower roles", "card": card, "T": T}
    for C in (1, 128):
        x = torch.from_numpy(rng.uniform(0.0, 0.5, (T, C)).astype(np.float32)).to(dev)
        env0, env = torch.zeros(C, device=dev), torch.empty((T, C), device=dev)
        final = torch.empty(C, device=dev)
        for _ in range(2):  # the second launch is the one kept
            lib.envelope_ar_scan_launch(x.data_ptr(), env0.data_ptr(), env.data_ptr(),
                                        final.data_ptr(), T, C, 0.0045, 0.00028,
                                        torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
        lib.read_cycles(cycles)
        result[f"C={C}"] = {
            role: {"total": cycles[k], "waiting": cycles[k + 1]}
            for role, k in (("consumer", 0), ("producer", 2))}
    return result


# the ADSR's tile paths: as built (past kSerialAbove edges a tile the
# per-sample walk), the edge walk at any edge count, the per-sample walk always
ADSR_PATHS = {"as built": None, "edge walk": 1 << 30, "per-sample walk": -1}


def slew_roles(card: str) -> dict:
    """The slew limiter's roles at T = 16384 in both modes (the wah's
    LINEAR rates, an EXPONENTIAL pair)."""
    lib = _build("slew_roles", slew_roles_source())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.slew_scan_launch.argtypes = [p] * 4 + [i, i, f, f, p]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T = 16384
    cycles = (ctypes.c_longlong * 16)()
    x = torch.from_numpy(np.repeat(rng.uniform(300.0, 2800.0, T // 64), 64)
                         .astype(np.float32)).to(dev)
    cur0, y, final = torch.full((), 300.0, device=dev), torch.empty(T, device=dev), \
        torch.empty((), device=dev)
    result = {"probe": "slew roles", "card": card, "T": T}
    for mode, linear, rise, fall in (("linear", 1, 40000.0 / 44100, 8000.0 / 44100),
                                     ("exponential", 0, 0.05, 0.002)):
        for _ in range(2):  # the second launch is the one kept
            lib.slew_scan_launch(x.data_ptr(), cur0.data_ptr(), y.data_ptr(), final.data_ptr(),
                                 T, linear, rise, fall, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
        lib.read_cycles(cycles)
        result[mode] = {role: {"total": cycles[k], "waiting": cycles[k + 1]}
                        for role, k in (("consumer", 0), ("producer", 2))}
    return result


def adsr_passes_source(serial_above=None) -> str:
    """``csrc/adsr_scan.cu`` with ``clock64()`` stamps (thread 0) around the
    chain set-up, each tile's three passes (summed over the tiles) and the
    whole kernel; ``serial_above`` replaces ``kSerialAbove`` (None: as
    built)."""
    s = (_PKG / "csrc" / "adsr_scan.cu").read_text()
    s = _replace(s, "namespace {", _READ + "namespace {")
    if serial_above is not None:
        built = re.findall(r"constexpr int kSerialAbove = \d+;", s)
        if len(built) != 1:
            raise RuntimeError("cycle_probe: the kernel source changed; no kSerialAbove")
        s = _replace(s, built[0], f"constexpr int kSerialAbove = {serial_above};")
    s = _replace(s, "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
                 "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
                 "  const long long t_begin = clock64();\n"
                 "  long long t_mark = t_begin, t_set = 0, t_a = 0, t_b = 0, t_c = 0;\n")
    s = _replace(s, "  const Chain c = s_chain;\n",
                 "  const Chain c = s_chain;\n  t_set = clock64() - t_mark;\n")
    s = _replace(s, "  for (int t0 = 0; t0 < T; t0 += kTile) {\n",
                 "  for (int t0 = 0; t0 < T; t0 += kTile) {\n    t_mark = clock64();\n")
    s = _replace(s, "    const int K = s_count;\n    __syncthreads();\n",
                 "    const int K = s_count;\n    __syncthreads();\n"
                 "    t_a += clock64() - t_mark;\n    t_mark = clock64();\n")
    s = _replace(s, "    // ---- C. every sample from its segment ----\n",
                 "    t_b += clock64() - t_mark;\n    t_mark = clock64();\n")
    s = _replace(s, "    __syncthreads();  // the next tile reuses the shared arrays\n",
                 "    __syncthreads();\n    t_c += clock64() - t_mark;\n")
    return _replace(s, "    for (int i = 0; i < 4; ++i) state_out[i] = s_state[i];\n",
                    "    for (int i = 0; i < 4; ++i) state_out[i] = s_state[i];\n"
                    "    g_cycles[0] = t_set, g_cycles[1] = t_a, g_cycles[2] = t_b,"
                    " g_cycles[3] = t_c, g_cycles[4] = clock64() - t_begin;\n")


def adsr_passes(card: str) -> dict:
    """The ADSR's passes at T = 16384 (two tiles) on each path of
    ``ADSR_PATHS``: the patch's gate (two edges), the many-edges gate of
    chip_smoke.py (440), an edge every eight samples and every sample.
    B and C stay 0 on the per-sample walk, which ``total`` holds."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dev = torch.device("cuda")
    T, sr = 16384, 44100
    gates = {"the patch's gate": (np.arange(T) < 22050 // 2).astype(np.float32)}
    g = np.zeros(T, np.float32)
    g[100:T // 3] = 1.0
    g[T // 2:T - 100:37] = 1.0
    gates["many edges"] = g
    gates["an edge every 8 samples"] = ((np.arange(T) // 8) % 2).astype(np.float32)
    gates["an edge every sample"] = (np.arange(T) % 2).astype(np.float32)
    cycles = (ctypes.c_longlong * 16)()
    result = {"probe": "adsr passes", "card": card, "T": T}
    for k, (path, above) in enumerate(ADSR_PATHS.items()):
        lib = _build(f"adsr_passes_{k}", adsr_passes_source(above))
        lib.adsr_scan_launch.argtypes = [p] * 5 + [i, f, f, f, f, i, p]
        for name, gate in gates.items():
            gd = torch.from_numpy(gate).to(dev)
            state, env, out, nxt = (torch.zeros(4, device=dev), torch.empty(T, device=dev),
                                    torch.empty(4, device=dev), torch.empty((), device=dev))
            for _ in range(2):  # the second launch is the one kept
                err = lib.adsr_scan_launch(gd.data_ptr(), state.data_ptr(), env.data_ptr(),
                                           out.data_ptr(), nxt.data_ptr(), T, 1 / (0.01 * sr),
                                           -0.4 / (0.05 * sr), -0.6 / (0.1 * sr), 0.6, -1,
                                           torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"cycle_probe: adsr launch failed ({err})")
            lib.read_cycles(cycles)
            result[f"{path}, {name}"] = {
                "edges": int(np.count_nonzero(np.diff(gate, prepend=0.0))),
                **{k: cycles[n] for n, k in enumerate(("set-up", "A", "B", "C", "total"))}}
    return result


BLOCKED_PHASES = ("the state's loads", "averages and u", "rho's prefetch and barrier", "chains",
                  "butterflies", "cluster wait", "outputs", "last barrier and y's stores")


def ks_blocked_phases_source() -> str:
    """``csrc/ks_scan.cu`` with ``clock64()`` stamps in ``ks_blocked`` (lane
    0 of warps 0 and 3 of CTA 0, summed over the blocks): each part of a
    block (``BLOCKED_PHASES``): the entering state's loads, the averages
    and u, rho's prefetch with the barrier, the warp's two chains, their
    butterflies and the last rows' lane sums, the wait on the cluster
    before the first remote write, the outputs, the block's last barrier
    with y's stores from its stage (one CTA)."""
    s = (_PKG / "csrc" / "ks_scan.cu").read_text()
    s = _replace(s, "namespace {", _READ + "namespace {")
    s = _replace(s, "  int par = 0, flushed = 0;\n",
                 "  long long q[8] = {0, 0, 0, 0, 0, 0, 0, 0}, c_at = clock64(), c_now;\n"
                 "  auto lap = [&](int k) { c_now = clock64(); q[k] += c_now - c_at; c_at = c_now; };\n"
                 "  int par = 0, flushed = 0;\n")
    s = _replace(s, "    // ---- the averages and u, all rows, each CTA ----\n",
                 "    c_at = clock64();\n    // ---- the averages and u, all rows, each CTA ----\n")
    s = _replace(s, "    if (n0 > 0) ao = ring[sb == 0 ? L - 1 : sb - 1], ai = s_ai[par ^ 1];\n",
                 "    if (n0 > 0) ao = ring[sb == 0 ? L - 1 : sb - 1], ai = s_ai[par ^ 1];\n"
                 "    const float ao_used = ao;\n    lap(0);\n")
    s = _replace(s, "    if (n0 + B < T) fetch(n0 + B);\n",
                 "    lap(1);\n    if (n0 + B < T) fetch(n0 + B);\n")
    s = _replace(s, "    if (ncta > 1) cluster_arrive_relaxed();  // this CTA is done reading its"
                 " string\n",
                 "    lap(2);\n    if (ncta > 1) cluster_arrive_relaxed();  // this CTA is done"
                 " reading its string\n")
    s = _replace(s, "        run_chain<R>(D, s_uz, j0, l, quad_steps<R>(q, K8), acc);\n",
                 "        run_chain<R>(D, s_uz, j0, l, quad_steps<R>(q, K8), acc);\n"
                 "        if (acc[0] == ao_used * 1e30f) c_at -= 1;  // the chain done\n"
                 "        lap(3);\n")
    s = _replace(s, "        rows[which] = j0 + first_row<R>(l);\n",
                 "        rows[which] = j0 + first_row<R>(l);\n        lap(4);\n")
    s = _replace(s, "    // ---- the outputs ----\n", "    lap(5);\n    // ---- the outputs ----\n")
    s = _replace(s, "    if (ncta > 1) {\n      __syncwarp();\n      cluster_arrive_release();",
                 "    lap(6);\n    if (ncta > 1) {\n      __syncwarp();\n      cluster_arrive_release();")
    s = _replace(s, "    sb += nb;\n    if (sb >= L) sb -= L;\n  }\n  if (rank == 0) {",
                 "    lap(7);\n    sb += nb;\n    if (sb >= L) sb -= L;\n  }\n"
                 "  if (rank == 0 && lane == 0 && (tid >> 5 == 0 || tid >> 5 == 3)) {\n"
                 "    const int k = tid >> 5 == 0 ? 0 : 8;\n"
                 "    for (int i = 0; i < 8; ++i) g_cycles[k + i] = q[i];\n  }\n  if (rank == 0) {")
    return s


def ks_blocked_phases(card: str) -> dict:
    """The blocked string at T = 16384 (every sample active) at L = 535 and
    133 on each layout of ``ops/ks.BLOCKED_LAYOUTS`` that fits: each part's cycles
    a block for warps 0 and 3 of CTA 0."""
    from pygmu2_tpu_torch.ops import ks as ks_ops

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    T = 16384
    lib = _build("ks_blocked_phases", ks_blocked_phases_source())
    lib.ks_blocked_launch.argtypes = [p] * 12 + [i, i, i, i, i, f, p]
    cycles = (ctypes.c_longlong * 16)()
    result = {"probe": "ks_blocked phases", "card": card, "T": T}
    for L in (535, 133):
        B, tril, powv = ks_ops.blocked_tables(L, 0.35)
        diag = torch.from_numpy(np.ascontiguousarray(tril[:, 0])).to(dev)
        powv = torch.from_numpy(powv).to(dev)
        ins = [torch.full((T,), 0.995, device=dev),
               torch.from_numpy(rng.uniform(-0.3, 0.3, L).astype(np.float32)).to(dev),
               torch.tensor(3, dtype=torch.int32, device=dev), torch.tensor(0.0, device=dev),
               torch.tensor(0.0, device=dev), diag, powv]
        outs = [torch.empty(T, device=dev), torch.empty(L, device=dev),
                torch.empty((), dtype=torch.int32, device=dev), torch.empty((), device=dev),
                torch.empty((), device=dev)]
        for R, ncta in ks_ops.BLOCKED_LAYOUTS:
            try:
                ks_ops.blocked_quads(B, R, ncta)
            except ValueError:
                continue
            lib.write_cycles((ctypes.c_longlong * 16)())
            err = lib.ks_blocked_launch(*[t.data_ptr() for t in ins + outs], T, L, B, R, ncta,
                                        0.35, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"cycle_probe: ks_blocked launch failed ({err})")
            lib.read_cycles(cycles)
            blocks = -(-T // B)
            result[f"L={L} R={R} ncta={ncta}"] = {
                f"warp {w}": {ph: round(cycles[8 * i + k] / blocks, 1)
                              for k, ph in enumerate(BLOCKED_PHASES)}
                for i, w in enumerate((0, 3))}
    return result


CLOCK_PHASES = ("A: stage and compact", "B: the run walk", "C: every sample from its run",
                "the per-sample walk", "total", "records")


def adsr_clock_phases_source() -> str:
    """``csrc/adsr_scan.cu`` with ``clock64()`` stamps (thread 0) in
    ``adsr_clock``, summed over the tiles (``CLOCK_PHASES``), and the run
    records the walks wrote."""
    s = (_PKG / "csrc" / "adsr_scan.cu").read_text()
    s = _replace(s, "namespace {", _READ + "namespace {")
    s = _replace(s, "  const Clock p{dA, dD, dR, sus, sustain_samples};\n",
                 "  const Clock p{dA, dD, dR, sus, sustain_samples};\n"
                 "  const long long q_begin = clock64();\n"
                 "  long long q_mark = q_begin, qa = 0, qb = 0, qc = 0, qd = 0, recs = 0;\n")
    s = _replace(s, "    // ---- A. stage the triggers; compact their samples ----\n",
                 "    q_mark = clock64();\n"
                 "    // ---- A. stage the triggers; compact their samples ----\n")
    s = _replace(s, "    const int K = s_count;\n    __syncthreads();\n\n    if (K > dense_above) {",
                 "    const int K = s_count;\n    __syncthreads();\n"
                 "    qa += clock64() - q_mark;\n    q_mark = clock64();\n\n"
                 "    if (K > dense_above) {")
    s = _replace(s, "        s_st = st, s_e = e, s_end = end;\n      }\n      __syncthreads();\n"
                 "    } else {",
                 "        s_st = st, s_e = e, s_end = end;\n      }\n      __syncthreads();\n"
                 "      qd += clock64() - q_mark;\n    } else {")
    s = _replace(s, "        // ---- C. every sample of [s, stop) from its record ----\n",
                 "        qb += clock64() - q_mark;\n        q_mark = clock64();\n"
                 "        recs += s_nrec;\n"
                 "        // ---- C. every sample of [s, stop) from its record ----\n")
    s = _replace(s, "        __syncthreads();\n        s = stop;\n",
                 "        __syncthreads();\n        qc += clock64() - q_mark;\n"
                 "        q_mark = clock64();\n        s = stop;\n")
    return _replace(s, "  if (tid == 0) *stage_out = s_st, *env_out = s_e, *ends_out = s_end;\n",
                    "  if (tid == 0) *stage_out = s_st, *env_out = s_e, *ends_out = s_end;\n"
                    "  if (tid == 0) g_cycles[0] = qa, g_cycles[1] = qb, g_cycles[2] = qc,"
                    " g_cycles[3] = qd, g_cycles[4] = clock64() - q_begin,"
                    " g_cycles[5] = recs;\n")


def adsr_clock_phases(card: str) -> dict:
    """The clock kernel at T = 16384 from IDLE (a pluck's slopes: attack
    10 ms, decay 50 ms to 0.6, release 100 ms; sustain 0 samples): four
    triggers, a trigger every 97 samples, and every sample, each on its
    run walk and forced to the per-sample walk."""
    p, i, q, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    dev = torch.device("cuda")
    T, sr = 16384, 44100.0
    lib = _build("adsr_clock_phases", adsr_clock_phases_source())
    lib.adsr_clock_launch.argtypes = [p] * 8 + [i, q, d, d, d, d, q, i, p]
    trigs = {"four triggers": np.isin(np.arange(T), [10, 5000, 9000, 15000]),
             "a trigger every 97 samples": np.arange(T) % 97 == 0,
             "every sample": np.ones(T, bool)}
    cycles = (ctypes.c_longlong * 16)()
    result = {"probe": "adsr_clock phases", "card": card, "T": T}
    for name, g in trigs.items():
        gd = torch.from_numpy(g.astype(np.float32)).to(dev)
        ins = [gd, torch.tensor(0, dtype=torch.int32, device=dev),
               torch.tensor(0.0, dtype=torch.float64, device=dev),
               torch.tensor(0, dtype=torch.int64, device=dev)]
        outs = [torch.empty(T, device=dev), torch.empty((), dtype=torch.int32, device=dev),
                torch.empty((), dtype=torch.float64, device=dev),
                torch.empty((), dtype=torch.int64, device=dev)]
        for walk, above in (("run walk", 1 << 30), ("per-sample walk", -1)):
            for _ in range(2):  # the second launch is the one kept
                lib.write_cycles((ctypes.c_longlong * 16)())
                err = lib.adsr_clock_launch(*[t.data_ptr() for t in ins + outs], T, 0,
                                            1 / (0.01 * sr), -0.4 / (0.05 * sr),
                                            -0.6 / (0.1 * sr), 0.6, 0, above,
                                            torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"cycle_probe: adsr_clock launch failed ({err})")
            lib.read_cycles(cycles)
            out = {k: cycles[n] for n, k in enumerate(CLOCK_PHASES)}
            out["triggers"] = int(g.sum())
            if out["records"]:
                out["walk cycles a record"] = round(out["B: the run walk"] / out["records"], 1)
            out["per-sample walk cycles a sample"] = round(out["the per-sample walk"] / T, 2)
            result[f"{name}, {walk}"] = out
    return result


# the SoundFont pass's roles, each summed over the CUDA blocks
OSC_ROLES = ("producers: oscillator", "producers: earlier maps", "producers: barrier",
             "producers: mix", "producers: mix, waiting on run 2", "chain: run 1",
             "chain: run 1, waiting on the producers", "chain: map and barrier",
             "chain: entering state", "chain: run 2")


def osc_roles_source() -> str:
    """``csrc/osc_filter_gain_mix.cu`` with the segment pass it includes
    (``csrc/filter_pass.cuh``) inlined and ``clock64()`` stamps around each
    role's work (``OSC_ROLES``: thread 0 for the producer warps, the chain
    warp's lane 0), summed over the CUDA blocks into ``g_cycles``."""
    s = (_PKG / "csrc" / "filter_pass.cuh").read_text()
    s = _replace(s, "namespace {", _READ + "namespace {")
    s = _replace(s, "  if (warp < kProducers) {\n",
                 "  long long c[10] = {0}, m0 = clock64(), m1;\n"
                 "  auto lap = [&](int k) { m1 = clock64(); c[k] += m1 - m0; m0 = m1; };\n"
                 "  if (warp < kProducers) {\n")
    s = _replace(s, "    // ---- the maps of the group's earlier segments, kSlot a warp ----\n",
                 "    lap(0);\n    // ---- the maps of the group's earlier segments, kSlot a warp ----\n")
    bar = '    asm volatile("bar.sync 1, %0;" ::"n"(kThreads));\n'
    s = _replace(s, bar + "\n    // ---- the mix", "    lap(1);\n" + bar + "    lap(2);\n\n    // ---- the mix")
    s = _replace(s, "      mbar_wait(&sm.ydone[t], 0);\n",
                 "      { const long long w0 = clock64(); mbar_wait(&sm.ydone[t], 0);"
                 " c[4] += clock64() - w0; }\n")
    s = _replace(s, "  } else {\n    // ---- the chain: one voice a lane ----\n",
                 "    lap(3);\n  } else {\n    // ---- the chain: one voice a lane ----\n"
                 "    m0 = clock64();\n")
    s = _replace(s, "        if (!run2) mbar_wait(&sm.full[t], 0);\n",
                 "        if (!run2) { const long long w0 = clock64(); mbar_wait(&sm.full[t], 0);"
                 " c[6] += clock64() - w0; }\n")
    s = _replace(s, "    walk(fir_quad, false);\n", "    walk(fir_quad, false);\n    lap(5);\n")
    s = _replace(s, bar + "\n    // the entering state", bar + "    lap(7);\n\n    // the entering state")
    s = _replace(s, "    walk(y_quad, true);\n", "    lap(8);\n    walk(y_quad, true);\n    lap(9);\n")
    s = _replace(s, "  // ---- with more than one block of voices: the partials, in order ----\n",
                 "  if (tid == 0 || tid == kProducers * 32)\n"
                 "    for (int k = 0; k < 10; ++k)\n"
                 "      if (c[k]) atomicAdd((unsigned long long*)&g_cycles[k], (unsigned long long)c[k]);\n"
                 "  // ---- with more than one block of voices: the partials, in order ----\n")
    return _replace((_PKG / "csrc" / "osc_filter_gain_mix.cu").read_text(),
                    '#include "filter_pass.cuh"\n', s)


def osc_roles(card: str) -> dict:
    """The SoundFont pass's roles on the bench's rows: the 3 s chord
    through the small and the large font, and the 60 s piece's first
    streamed segment (large font); cycles per CUDA block, and per sample of
    its segment."""
    from pygmu2_tpu_torch.soundfont import filter_kernels as fk

    lib = _build("osc_roles", osc_roles_source())
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.osc_filter_gain_mix_launch.argtypes = [p, p, p, i, p, p, p, p, q, p, q, i, i, i, p]
    dev = torch.device("cuda")
    cycles = (ctypes.c_longlong * 16)()
    zero = (ctypes.c_longlong * 16)()
    result = {"probe": "osc roles", "card": card}
    for name, large, seconds in (("3 s chord, small font", False, 3.0),
                                 ("3 s chord, large font", True, 3.0),
                                 ("60 s piece's first segment", True, 255.5 * 1024 / 44100)):
        rows, wave, N = _osc_rows(large, seconds, dev)
        B, P = rows["ratio"].shape
        rows_f = torch.stack([rows[k].float() for k in fk._OSC_F32_ROWS])
        rows_i = torch.stack([rows[k].to(torch.int32) for k in fk._OSC_I32_ROWS])
        n_f, n_i = fk._osc_scratch_sizes(B, P, N)
        scratch_f, scratch_i = torch.empty(n_f, device=dev), torch.empty(n_i, dtype=torch.int32,
                                                                         device=dev)
        state = torch.zeros((4, P), device=dev)
        out, state_out = torch.empty((B * N, 2), device=dev), torch.empty((4, P), device=dev)
        for _ in range(2):  # the second launch is the one kept
            lib.write_cycles(zero)
            err = lib.osc_filter_gain_mix_launch(
                rows_f.data_ptr(), rows_i.data_ptr(), wave.data_ptr(), wave.shape[0],
                state.data_ptr(), out.data_ptr(), state_out.data_ptr(), scratch_f.data_ptr(), n_f,
                scratch_i.data_ptr(), n_i, B, P, N, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"cycle_probe: osc launch failed ({err})")
        lib.read_cycles(cycles)
        blocks = B * -(-N // fk.OSC_SEG) * -(-P // fk.OSC_VOICES)
        result[name] = {"B": B, "P": P, "N": N, "cuda_blocks": blocks, **{
            role: {"per_block": cycles[k] / blocks, "per_sample": cycles[k] / blocks / fk.OSC_SEG}
            for k, role in enumerate(OSC_ROLES)}}
    return result


def _osc_rows(large: bool, seconds: float, dev):
    """The bench's control rows (``chip_smoke.py`` phase 3's): the 3 s chord,
    or the first ``seconds`` of the 60 s piece."""
    from pygmu2_tpu_torch import bench_workload
    from pygmu2_tpu_torch.soundfont import MidiFile

    synth, midi = bench_workload.build_workload(large)
    if seconds != 3.0:
        midi = MidiFile(bench_workload.build_midi_bytes(repeats=15))
    return bench_workload.audio_pass_rows(synth, midi, seconds, dev)


def instrumented_sources() -> dict:
    """Every instrumented copy's source text (no build): each raises if a
    line it stamps is gone from its kernel."""
    out = {"comb roles": comb_roles_source(), "ks roles": ks_roles_source(),
           "ks bwd roles": ks_bwd_roles_source(),
           "follower roles": follower_roles_source(), "slew roles": slew_roles_source(),
           "osc roles": osc_roles_source()}
    out.update({f"adsr passes, {k}": adsr_passes_source(v) for k, v in ADSR_PATHS.items()})
    out["ks_blocked phases"] = ks_blocked_phases_source()
    out["adsr_clock phases"] = adsr_clock_phases_source()
    return out


PROBES = {"chains": chains, "roles": roles, "follower": follower_roles, "slew": slew_roles,
          "osc": osc_roles, "adsr": adsr_passes, "blocked": ks_blocked_phases,
          "clock": adsr_clock_phases}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cycle_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    for name in sys.argv[1:] or PROBES:
        print(json.dumps(PROBES[name](card)))


if __name__ == "__main__":
    main()
