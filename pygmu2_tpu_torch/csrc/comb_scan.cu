// Feedback comb over a ring buffer for Hopper (sm_90a): a serial control
// pass shared by the channels, then an audio pass parallel within windows.
//
// Replaces the TPU kernel pygmu2_tpu/ops/comb_pallas.py:comb_scan_pallas
// (:125), which keeps the (L, 128) ring buffer in VMEM scratch and walks a
// sequential grid of time chunks.
//
// What it computes (the op order of comb_scan_ref, float32), per sample t:
//   sf    = sf < 0 ? f[t] : sf + (f[t] - sf) * alpha    one-pole smoothing
//   delay = clip(rint(sr / max(sf, 1)), 1, L - 1)        half to even
//   y     = x[t, c] + fb[t] * buf[(pos - delay + L) % L, c]
//   buf[pos, c] = y; pos = (pos + 1) % L
//
// What bounds it on this card: a dependent chain, not bytes or operations.
// At the main path's block (T = 16384, C = 128, L = 2206) it moves 19 MB
// (roofline 5.7 us at 3.35 TB/s) and does 13 ops per sample plus 2 per
// sample and channel. Only the smoother is truly serial: three rounded
// ops, ~12-16 cycles a sample with its select, ~0.13 ms per 16384 samples
// at 1.98 GHz, whatever C. The delay depends on the smoothed frequency
// alone, never on the audio. And sample t reads the value written at
// t - delay[t] (or, before the call, the ring handed in), so a run of
// samples whose reads all land before the run starts can be computed at
// once, on every channel. The first design ran the whole sample (the
// smoother, an IEEE division, rounding, a modulo, a shared-memory read and
// the multiply-add) as one chain per thread: 3.45 ms at C = 1, 5.48 ms at
// C = 128.
//
// What the design does about it: two launches on the caller's stream.
// 1. comb_control, one CUDA block of 256 threads, in chunks of 512
//    samples: thread 0 runs only the smoother, from frequencies that warps
//    2-7 staged into shared memory a chunk ahead with cp.async (and found
//    free of negative or NaN values: then the smoother's select cannot
//    fire and leaves the chain, three rounded ops a sample); warps 2-7
//    turn the previous chunk's smoothed values into delays (the division,
//    rintf, the clip) for shared memory and the table `delay`; warp 1 cuts
//    the chunk before that into windows, greedily: a window that starts at
//    t0 runs to the first t with t - delay[t] >= t0, one integer compare a
//    sample, 32 samples a step (a ballot finds the first cut among them).
//    One __syncthreads() per chunk.
// 2. comb_audio, one CUDA block per group of up to 8 channels (a bank of
//    128 on 16 SMs; one row of 8 channels is one 32-byte sector), 1024
//    threads along time and channel: for each window in order, every
//    (t, c) reads its delayed value from y (written by an earlier window)
//    or from the ring handed in, and writes y = x + fb * value; a
//    __syncthreads() between windows. Windows shorter than 8 samples (the
//    delay collapses: at delay 1 every window is one sample) are walked
//    by one thread per channel instead, with no barrier inside a run of
//    them. The ring is never kept: its final state is the last L samples
//    of [ring ; y], gathered at the end.
// The backward (comb_scan_bwd.cu) reads the delay table, the windows and
// the smoothed values (`smoothed`, written beside the delays by warps 2-7)
// as residuals; it runs no control pass of its own.
// Per-sample arithmetic is that of the plain version, in explicitly
// rounded float ops, __fdiv_rn and rintf, so the kernel equals the plain
// PyTorch version bit for bit; only the order in which independent samples
// are computed changes.
//
// Measured (H100 80GB HBM3, 700 W; T = 16384, L = 2206): 0.195 ms at
// C = 1 and 0.250 ms at C = 128 for a 200-240 Hz sweep (chip_smoke.py); in
// the patch's render the control pass takes 0.131 ms a call and the audio
// pass 0.053 ms (C = 1; the bank's, C = 128: 0.113 ms; profile_pe.py). By
// cycle_probe.py's clock counters thread 0 spends ~14.5 cycles a sample,
// its chain alone 12.9.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;       // samples per staged chunk of the control pass
constexpr int kCtlThreads = 256;  // warp 0 smoother, warp 1 windows, warps 2-7 the rest
constexpr int kAudioThreads = 1024;
constexpr int kGroup = 8;         // channels per CUDA block of the audio pass
constexpr int kMinParallel = 8;   // shorter windows: one thread per channel

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// one step of the one-pole smoother, as the plain version rounds it. The
// select is spelled out (setp, selp) so that it stays a select after the
// chain: as a C conditional it became predication, and the predicate's
// compare stood in the chain ahead of the three rounded ops.
__device__ __forceinline__ float smooth(float sf, float f, float alpha) {
  const float s = __fadd_rn(sf, __fmul_rn(__fsub_rn(f, sf), alpha));
  float out;
  asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %1, 0f00000000;\n\tselp.f32 %0, %2, %3, p;\n\t}"
      : "=f"(out)
      : "f"(sf), "f"(f), "f"(s));
  return out;
}


// One serial thread's walk over n staged values: out[i] = step(in[i]), in
// order. Loads run eight values ahead of the chain as 16-byte vectors and
// outputs leave as 16-byte vectors, with no bounds test inside the loop:
// in and out are 16-byte aligned and readable to n + 8. A warp runs its
// instructions in order, so every test and register move stands in the
// chain's way: in cycle_probe.py's microbenchmark (H100) the smoother
// walks 512 staged values at 16.1 cycles a step with bounds-tested scalar
// loads and moves between batches, at 13.3 this way, against 12.9 for its
// chain alone.
template <class Step>
__device__ __forceinline__ void walk(const float* __restrict__ in, float* __restrict__ out,
                                     int n, Step step) {
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  auto four = [&](float4 a, int i) {  // in order: step carries the chain
    const float o0 = step(a.x), o1 = step(a.y), o2 = step(a.z), o3 = step(a.w);
    out4[i / 4] = make_float4(o0, o1, o2, o3);
  };
  auto eight = [&](float4 a, float4 b, int i) {
    four(a, i);
    four(b, i + 4);
  };
  float4 f0 = in4[0], f1 = in4[1];
  int i = 0;
  for (; i + 16 <= n; i += 16) {  // two batches a turn: no register moves
    const float4 g0 = in4[i / 4 + 2], g1 = in4[i / 4 + 3];
    eight(f0, f1, i);
    f0 = in4[i / 4 + 4];
    f1 = in4[i / 4 + 5];
    eight(g0, g1, i + 8);
  }
  if (i + 8 <= n) {
    const float4 g0 = in4[i / 4 + 2], g1 = in4[i / 4 + 3];
    eight(f0, f1, i);
    f0 = g0;
    f1 = g1;
    i += 8;
  }
  const float rest[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (i + u < n) out[i + u] = step(rest[u]);
}

__global__ void __launch_bounds__(kCtlThreads) comb_control(
    const float* __restrict__ freq, const int* __restrict__ pos_in,
    const float* __restrict__ sf_in, int* __restrict__ delay,
    int* __restrict__ bounds, int* __restrict__ n_windows, float* __restrict__ smoothed,
    int* __restrict__ pos_out, float* __restrict__ sf_out, int T, int L,
    float sr, float alpha) {
  // padded by 8: thread 0 reads 16-byte vectors past a chunk's end
  __shared__ __align__(16) float s_f[2][kChunk + 8], s_sf[2][kChunk + 8];
  __shared__ int s_d[2][kChunk];
  const int tid = threadIdx.x;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int step = kCtlThreads - 64;  // warps 2-7

  auto stage = [&](int j) {  // warps 2-7: chunk j's frequencies
    const int base = j * kChunk, n = min(kChunk, T - base), b = j & 1;
    for (int i = tid - 64; i < n; i += step) cp_async4(&s_f[b][i], freq + base + i);
    cp_async_commit();
  };
  auto delays = [&](int j) {  // warps 2-7: chunk j's delays
    const int base = j * kChunk, n = min(kChunk, T - base), b = j & 1;
    for (int i = tid - 64; i < n; i += step) {
      smoothed[base + i] = s_sf[b][i];
      const int d = (int)rintf(__fdiv_rn(sr, fmaxf(s_sf[b][i], 1.0f)));
      s_d[b][i] = delay[base + i] = min(max(d, 1), L - 1);
    }
  };

  int bad = 0;  // warps 2-7: a staged frequency is negative or NaN
  if (tid >= 64) {
    stage(0);
    cp_async_wait_all();
    for (int i = tid - 64; i < min(kChunk, T); i += step) bad |= !(s_f[0][i] >= 0.0f);
  }
  int unsafe = __syncthreads_or(bad);  // the chunk thread 0 walks next
  bad = 0;

  float sf = *sf_in;  // thread 0
  const bool alpha_in_01 = alpha >= 0.0f && alpha <= 1.0f;
  int t0 = 0, nb = 0;  // warp 1: the current window's start, the cuts so far
  for (int j = 0; j <= n_chunks + 1; ++j) {
    if (tid == 0) {
      if (j < n_chunks) {
        const int n = min(kChunk, T - j * kChunk), b = j & 1;
        // no frequency of this chunk is negative or NaN and sf >= 0: then
        // sf stays >= 0 (each step is a rounded convex combination of two
        // values >= 0) and the select never takes f, so it leaves the chain
        if (!unsafe && alpha_in_01 && sf >= 0.0f) {
          walk(s_f[b], s_sf[b], n, [&](float f) {
            return sf = __fadd_rn(sf, __fmul_rn(__fsub_rn(f, sf), alpha));
          });
        } else {
          walk(s_f[b], s_sf[b], n, [&](float f) { return sf = smooth(sf, f, alpha); });
        }
      }
    } else if (tid >= 64) {
      if (j + 1 < n_chunks) stage(j + 1);
      if (j >= 1 && j - 1 < n_chunks) delays(j - 1);
      cp_async_wait_all();
      if (j + 1 < n_chunks) {  // a negative or NaN frequency in chunk j + 1
        const int base = (j + 1) * kChunk, n = min(kChunk, T - base), b = (j + 1) & 1;
        for (int i = tid - 64; i < n; i += step) bad |= !(s_f[b][i] >= 0.0f);
      }
    } else if (tid >= 32) {  // warp 1: the greedy cuts, 32 samples a step
      if (j >= 2) {
        const int base = (j - 2) * kChunk, n = min(kChunk, T - base), b = j & 1;
        const int lane = tid - 32;
        for (int g = 0; g < n; g += 32) {
          const bool valid = g + lane < n;
          const int t = base + g + lane;
          const int reads = valid ? t - s_d[b][g + lane] : -1;  // t - delay[t]
          unsigned ahead = __ballot_sync(0xffffffffu, valid);
          // the next cut is the first sample ahead that reads at or after t0
          unsigned hits;
          while ((hits = __ballot_sync(0xffffffffu, reads >= t0) & ahead) != 0) {
            const int first = __ffs(hits) - 1;
            t0 = base + g + first;
            if (lane == 0) bounds[nb + 1] = t0;
            ++nb;
            ahead &= first == 31 ? 0u : ~0u << (first + 1);
          }
        }
      }
    }
    unsafe = __syncthreads_or(bad);  // chunk j + 1's frequencies, for thread 0
    bad = 0;
  }
  if (tid == 0) {
    *sf_out = sf;
    *pos_out = (int)(((long long)*pos_in + T) % L);
  } else if (tid == 32) {
    bounds[0] = 0;
    bounds[nb + 1] = T;
    *n_windows = nb + 1;
  }
}

__global__ void __launch_bounds__(kAudioThreads) comb_audio(
    const float* __restrict__ x, const float* __restrict__ fb,
    const float* __restrict__ buf_in, const int* __restrict__ pos_in,
    const int* __restrict__ delay, const int* __restrict__ bounds,
    const int* __restrict__ n_windows, float* y, float* __restrict__ buf_out,
    int T, int C, int L) {
  const int c = blockIdx.x * kGroup + threadIdx.x;
  const bool live = c < C;
  const int lanes = blockDim.y, ty = threadIdx.y;
  const int p0 = *pos_in, nw = *n_windows;
  // y[t] = x[t] + fb[t] * the value written at t - delay[t]
  auto sample = [&](int t) {
    const int m = t - delay[t];
    int slot = (p0 + m) % L;
    if (slot < 0) slot += L;
    const float v = m >= 0 ? y[(long)m * C + c] : buf_in[(long)slot * C + c];
    const long row = (long)t * C + c;
    y[row] = __fadd_rn(x[row], __fmul_rn(fb[t], v));
  };
  bool serial_before = false;
  int a = bounds[0], b = bounds[1];
  for (int k = 0; k < nw; ++k) {
    const int next = bounds[min(k + 2, nw)];  // the window after, loaded ahead
    if (b - a >= kMinParallel) {  // the same branch for the whole block
      if (serial_before) __syncthreads();
      if (live)
        for (int t = a + ty; t < b; t += lanes) sample(t);
      __syncthreads();  // this window's values are read by later ones
      serial_before = false;
    } else {
      if (live && ty == 0)
        for (int t = a; t < b; ++t) sample(t);
      serial_before = true;
    }
    a = b;
    b = next;
  }
  __syncthreads();
  if (live) {  // slot s last held the sample m in [T - L, T) with m = s - p0 mod L
    for (int s = ty; s < L; s += lanes) {
      int back = (int)(((long long)p0 + T - 1 - s) % L);
      if (back < 0) back += L;
      const int m = T - 1 - back;
      buf_out[(long)s * C + c] = m >= 0 ? y[(long)m * C + c] : buf_in[(long)s * C + c];
    }
  }
}

}  // namespace

extern "C" {

// Enqueues the two launches on `stream`; returns the first cudaError_t (0
// when both were accepted). Device pointers: x / y (T, C) f32, freq / fb
// (T,) f32, buf_in / buf_out (L, C) f32, pos_in / pos_out () i32, sf_in /
// sf_out () f32; the control pass's results, kept for the backward: delay
// (T,) i32, bounds (T + 1,) i32 (the windows' starts, then T), n_windows
// (1,) i32, smoothed (T,) f32. Needs L >= 2.
int comb_scan_launch(const float* x, const float* freq, const float* fb,
                     const float* buf_in, const int* pos_in,
                     const float* sf_in, float* y, float* buf_out, int* pos_out,
                     float* sf_out, int* delay, int* bounds, int* n_windows, float* smoothed,
                     int T, int C, int L, float sr, float smooth_alpha,
                     cudaStream_t stream) {
  if (L < 2) return (int)cudaErrorInvalidValue;
  comb_control<<<1, kCtlThreads, 0, stream>>>(freq, pos_in, sf_in, delay, bounds,
                                              n_windows, smoothed, pos_out, sf_out, T, L, sr,
                                              smooth_alpha);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = C < kGroup ? C : kGroup;
  const dim3 threads(width, kAudioThreads / width);
  comb_audio<<<(C + kGroup - 1) / kGroup, threads, 0, stream>>>(
      x, fb, buf_in, pos_in, delay, bounds, n_windows, y, buf_out, T, C, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
