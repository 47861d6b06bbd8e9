// Two-sided slew limiter, serial in time, for Hopper (sm_90a).
//
// Replaces the TPU kernel pygmu2_tpu/ops/slew_pallas.py:slew_scan_pallas
// (:107), which broadcasts the mono value across 128 lanes (a tiling need
// of the TPU) and walks a sequential grid of time chunks.
//
// What it computes (the op order of slew_scan_ref, float32), per sample:
//   LINEAR:       cur = cur + clip(x[t] - cur, -p_fall, p_rise)
//   EXPONENTIAL:  err = x[t] - cur; cur = cur + (err > 0 ? p_rise : p_fall) * err
//   y[t] = cur
//
// What bounds it on this card: the dependent chain. At the main path's
// block (T = 16384) it moves 128 KB (roofline 0.04 us at 3.35 TB/s) and
// does 4 ops per sample; each sample's subtract, clamp (or compare, select
// and multiply) and add depend on the previous sample's value. The composed
// per-step maps (slopes 0 and 1) grow staircases, so no fixed-size
// associative form splits the chain. The first design (one thread reading
// x[t] and writing y[t] in global memory, unrolled by 8) measured 0.4944 ms
// (linear) and 0.5069 ms (exponential) at T = 16384 (chip_smoke.py, H100
// 80GB HBM3, 700 W): ~60 cycles a sample, where the chain takes ~12-16;
// the thread waited on memory, not on the chain.
//
// What the design does about it: the envelope follower's layout
// (envelope_ar_scan.cu) at one channel. A producer warp streams chunks of
// kChunk samples of x into a ring of kStages shared-memory stages with
// cp.async, 16 bytes a lane where x is 16-byte aligned, each arrival
// tracked by an mbarrier, and drains the y values the consumer wrote over a
// stage back to global memory once the consumer releases it (a second
// mbarrier), 16 bytes a lane where y allows it. The consumer is one thread:
// it reads a chunk's inputs from shared memory as 16-byte vectors, two
// vectors ahead of the chain, runs only the chain, and writes its outputs
// over the stage, never to global memory. The step forms are the ones
// cycle_probe.py measured fastest (`chains`: slew rows). Explicitly rounded
// float ops keep the kernel equal to the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "staged_ring.cuh"

namespace {

constexpr int kChunk = 256;  // samples per ring stage
constexpr int kStages = 4;
constexpr int kLanes = 32;

struct Stage {
  // x in, y out (in place); 8 floats of padding for the reads ahead
  float v[kChunk + 8];
};

// cur + clip(x - cur, -p_fall, p_rise): the clip as fmaxf / fminf
__device__ __forceinline__ float linear_step(float cur, float x, float rise, float neg_fall) {
  return __fadd_rn(cur, fminf(fmaxf(__fsub_rn(x, cur), neg_fall), rise));
}

// cur + k * err with k = err > 0 ? p_rise : p_fall: both updates formed,
// one selected (the compare and both products off the selected path)
__device__ __forceinline__ float exp_step(float cur, float x, float rise, float fall) {
  const float err = __fsub_rn(x, cur);
  const float up = __fadd_rn(cur, __fmul_rn(rise, err));
  const float down = __fadd_rn(cur, __fmul_rn(fall, err));
  return err > 0.0f ? up : down;
}

template <bool kLinear>
__device__ __forceinline__ float step(float cur, float x, float rise, float fall) {
  return kLinear ? linear_step(cur, x, rise, -fall) : exp_step(cur, x, rise, fall);
}

__global__ void __launch_bounds__(2 * kLanes)
    slew_scan(const float* __restrict__ x, const float* __restrict__ cur_in,
              float* __restrict__ y, float* __restrict__ cur_out, int T, bool linear,
              float p_rise, float p_fall) {
  __shared__ __align__(16) Stage ring[kStages];
  __shared__ uint64_t full[kStages], done[kStages];
  const int lane = threadIdx.x & 31;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kLanes);  // the producer's 32 threads
      mbar_init(&done[s], 1);       // the consumer thread
    }
  __syncthreads();

  if (threadIdx.x >= kLanes) {  // ---- the producer warp ----
    const bool x16 = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const bool y16 = (reinterpret_cast<uintptr_t>(y) & 15) == 0;
    auto drain = [&](int j) {  // chunk j's y values, from its stage to global
      mbar_wait(&done[j % kStages], (j / kStages) & 1);
      const float* v = ring[j % kStages].v;
      const int base = j * kChunk, n = min(kChunk, T - base);
      float* out = y + base;
      const int n4 = y16 ? n & ~3 : 0;
#pragma unroll 2
      for (int f = 4 * lane; f < n4; f += 4 * kLanes)
        *reinterpret_cast<float4*>(out + f) = *reinterpret_cast<const float4*>(v + f);
      for (int f = n4 + lane; f < n; f += kLanes) out[f] = v[f];
    };
    for (int j = 0; j < n_chunks; ++j) {
      if (j >= kStages) drain(j - kStages);
      float* v = ring[j % kStages].v;
      const int base = j * kChunk, n = min(kChunk, T - base);
      const float* in = x + base;
      const int n4 = x16 ? n & ~3 : 0;
      for (int f = 4 * lane; f < n4; f += 4 * kLanes) cp_async16(v + f, in + f);
      for (int f = n4 + lane; f < n; f += kLanes) cp_async4(v + f, in + f);
      cp_async_arrive(&full[j % kStages]);
    }
    for (int j = max(n_chunks - kStages, 0); j < n_chunks; ++j) drain(j);
    return;
  }
  if (threadIdx.x != 0) return;

  // ---- the consumer thread: the chain over the ring's chunks, in place ----
  const float rise = p_rise, fall = p_fall;
  auto consume = [&](auto lin) {
    constexpr bool kLinear = decltype(lin)::value;
    float cur = *cur_in;
    for (int j = 0; j < n_chunks; ++j) {
      Stage& st = ring[j % kStages];
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
      const int n = min(kChunk, T - j * kChunk);
      if (n == kChunk) {
        float4* v4 = reinterpret_cast<float4*>(st.v);
        auto four = [&](float4 a) {
          const float o0 = cur = step<kLinear>(cur, a.x, rise, fall);
          const float o1 = cur = step<kLinear>(cur, a.y, rise, fall);
          const float o2 = cur = step<kLinear>(cur, a.z, rise, fall);
          const float o3 = cur = step<kLinear>(cur, a.w, rise, fall);
          return make_float4(o0, o1, o2, o3);
        };
        float4 a = v4[0], b = v4[1];
#pragma unroll 4
        for (int i = 0; i < kChunk / 4; i += 2) {
          const float4 na = v4[i + 2], nb = v4[i + 3];  // past the end: the padding
          v4[i] = four(a);
          v4[i + 1] = four(b);
          a = na;
          b = nb;
        }
      } else {  // the last chunk
        for (int i = 0; i < n; ++i) st.v[i] = cur = step<kLinear>(cur, st.v[i], rise, fall);
      }
      mbar_arrive(&done[j % kStages]);
    }
    return cur;
  };
  const float cur = linear ? consume(std::true_type{}) : consume(std::false_type{});
  *cur_out = cur;
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: x / y (T,) f32, cur_in / cur_out () f32.
int slew_scan_launch(const float* x, const float* cur_in, float* y,
                     float* cur_out, int T, int linear, float p_rise,
                     float p_fall, cudaStream_t stream) {
  slew_scan<<<1, 2 * kLanes, 0, stream>>>(x, cur_in, y, cur_out, T, linear != 0,
                                          p_rise, p_fall);
  return (int)cudaGetLastError();
}

}  // extern "C"
