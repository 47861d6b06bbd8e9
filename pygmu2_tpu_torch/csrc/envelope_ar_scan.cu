// Asymmetric attack/release envelope follower, serial in time, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pygmu2_tpu/ops/envelope_pallas.py:
// envelope_ar_pallas (:97), which keeps the envelope of 128 lanes in vector
// registers and walks a sequential grid of time chunks.
//
// What it computes (the op order of envelope_ar_scan_ref, float32, the
// update one fused multiply-add as XLA's CPU program forms it), per sample
// t and channel c:
//   coeff = x[t, c] > e ? atk : rel
//   e     = fma(coeff, x[t, c] - e, e);   env[t, c] = e
//
// What bounds it on this card: the dependent chain. At the main path's
// block (T = 16384) it moves 8 bytes per sample and channel (16.8 MB at
// C = 128: roofline 5.0 us at 3.35 TB/s) and does 4 ops per sample and
// channel. The coefficient switches on x > e, so the recurrence is not
// linear and no parallel scan reproduces its roundings: each sample's
// compare, select, subtract, multiply and add wait for the previous
// sample's envelope, a serial floor of ~0.16 ms per 16384 samples at
// 1.98 GHz, whatever C. The first design (one thread per channel reading
// x from global memory in an unrolled loop, a 64-bit index and a scalar
// store a sample) measured 0.4755 ms at C = 1 and 0.5497 ms at C = 128
// (chip_smoke.py, H100 80GB HBM3, 700 W): ~57-66 cycles a sample.
//
// What the design does about it: nothing but the chain in the thread that
// runs it. Each CUDA block is two warps and 32 channels (a bank of 128 on
// four SMs), as in ladder_scan.cu. The producer warp streams chunks of 64
// samples of the x rows into a ring of four shared-memory stages with
// cp.async, each arrival tracked by an mbarrier, and drains the env rows
// the consumer wrote over them back to global memory once the consumer
// releases the stage (a second mbarrier), 16 bytes a lane where the rows
// allow it (see Layout): with 4-byte copies a row the producer, not the
// chain, set the pace (~35 cycles a row). The consumer warp holds one
// channel per lane and reads and writes only shared memory: a chunk's 64
// inputs into registers, then the chain (loads behind stores to a
// run-time row stride would each wait on the chain).
//
// Measured (chip_smoke.py and cycle_probe.py, H100 80GB HBM3, 700 W):
// ~0.20 ms at C = 1 and at C = 128, ~24.5 cycles a sample in the consumer;
// the chain's compare, select, subtract, multiply and add take 19.4
// (cycle_probe: both updates formed and one selected 18.9, about the same;
// both products formed and one selected, or picked by a mask, 22.4-23.9).
// Explicitly rounded float ops (__fsub_rn, __fmaf_rn) keep the kernel
// equal to the plain PyTorch version bit for bit (the coefficient switches
// on x > e: one ulp can flip a sample). Until the update became one fused
// multiply-add (rounded once, as the JAX package's program on the CPU
// rounds it) the product and the sum were rounded apart.

#include <cuda_runtime.h>
#include <cstdint>

#include "staged_ring.cuh"

namespace {

constexpr int kLanes = 32;   // channels per CUDA block: one consumer warp
constexpr int kChunk = 64;   // samples per ring stage
constexpr int kStages = 4;

struct Stage {
  float v[kChunk * kLanes];  // x rows in, env rows out (in place)
};

__device__ __forceinline__ float step(float e, float x, float atk, float rel) {
  const float coeff = x > e ? atk : rel;
  return __fmaf_rn(coeff, __fsub_rn(x, e), e);
}

// How a chunk's rows move between global and shared memory (each stage
// holds them `width` floats a row, in the order of global memory):
// kFlat: the block's channels are all of them, so the chunk is one run of
// n * C floats; kRows: rows of `width` floats, C apart. The 4 variants move
// 16 bytes a lane (x and env 16-byte aligned; kRows4 takes rows of 32
// channels with C % 4 == 0).
enum Layout { kFlat, kFlat4, kRows, kRows4 };

__global__ void __launch_bounds__(2 * kLanes)
    envelope_ar_scan(const float* __restrict__ x, const float* __restrict__ env0,
                     float* __restrict__ env, float* __restrict__ env_final, int T, int C,
                     float atk, float rel) {
  __shared__ __align__(16) Stage ring[kStages];
  __shared__ uint64_t full[kStages], done[kStages];
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kLanes;
  const int width = min(kLanes, C - c0);
  const bool live = lane < width;
  const int c = c0 + lane;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(env)) & 15) == 0;
  const Layout layout = width == C ? (aligned ? kFlat4 : kFlat)
                                   : (aligned && width == kLanes && C % 4 == 0 ? kRows4 : kRows);
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kLanes);  // the producer's 32 threads
      mbar_init(&done[s], kLanes);  // the consumer's 32 threads
    }
  __syncthreads();

  if (threadIdx.x >= kLanes) {  // ---- the producer warp ----
    auto drain = [&](int j) {  // chunk j's env rows, from its stage to global
      mbar_wait(&done[j % kStages], (j / kStages) & 1);
      const float* v = ring[j % kStages].v;
      const int base = j * kChunk, n = min(kChunk, T - base);
      float* out = env + (long)base * C;
      if (layout == kFlat4) {
        const int m = n * C, m4 = m & ~3;
#pragma unroll 4  // the loads of a batch before its stores
        for (int f = 4 * lane; f < m4; f += 4 * kLanes)
          *reinterpret_cast<float4*>(out + f) = *reinterpret_cast<const float4*>(v + f);
        for (int f = m4 + lane; f < m; f += kLanes) out[f] = v[f];
      } else if (layout == kFlat) {
        for (int f = lane; f < n * C; f += kLanes) out[f] = v[f];
      } else if (layout == kRows4) {
#pragma unroll 4
        for (int q = lane; q < n * 8; q += kLanes) {
          const int row = q >> 3, col = (q & 7) * 4;
          *reinterpret_cast<float4*>(out + (long)row * C + c0 + col) =
              *reinterpret_cast<const float4*>(v + row * kLanes + col);
        }
      } else if (live) {
        for (int row = 0; row < n; ++row) out[(long)row * C + c] = v[row * width + lane];
      }
    };
    for (int j = 0; j < n_chunks; ++j) {
      if (j >= kStages) drain(j - kStages);
      float* v = ring[j % kStages].v;
      const int base = j * kChunk, n = min(kChunk, T - base);
      const float* in = x + (long)base * C;
      if (layout == kFlat4) {
        const int m = n * C, m4 = m & ~3;
        for (int f = 4 * lane; f < m4; f += 4 * kLanes) cp_async16(v + f, in + f);
        for (int f = m4 + lane; f < m; f += kLanes) cp_async4(v + f, in + f);
      } else if (layout == kFlat) {
        for (int f = lane; f < n * C; f += kLanes) cp_async4(v + f, in + f);
      } else if (layout == kRows4) {
        for (int q = lane; q < n * 8; q += kLanes) {
          const int row = q >> 3, col = (q & 7) * 4;
          cp_async16(v + row * kLanes + col, in + (long)row * C + c0 + col);
        }
      } else if (live) {
        for (int row = 0; row < n; ++row) cp_async4(v + row * width + lane, in + (long)row * C + c);
      }
      cp_async_arrive(&full[j % kStages]);
    }
    for (int j = max(n_chunks - kStages, 0); j < n_chunks; ++j) drain(j);
    return;
  }

  // ---- the consumer warp: one channel per lane ----
  float e = live ? env0[c] : 0.0f;
  for (int j = 0; j < n_chunks; ++j) {
    float* v = ring[j % kStages].v + lane;
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    const int n = min(kChunk, T - j * kChunk);
    if (live && n == kChunk) {
      // the whole chunk's inputs first: the stores below may not pass them
      float xs[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) xs[i] = v[i * width];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[i * width] = e = step(e, xs[i], atk, rel);
    } else if (live) {  // the last chunk
      for (int i = 0; i < n; ++i) v[i * width] = e = step(e, v[i * width], atk, rel);
    }
    mbar_arrive(&done[j % kStages]);
  }
  if (live) env_final[c] = e;
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: x / env (T, C) f32, env0 / env_final (C,)
// f32.
int envelope_ar_scan_launch(const float* x, const float* env0, float* env,
                            float* env_final, int T, int C, float atk,
                            float rel, cudaStream_t stream) {
  envelope_ar_scan<<<(C + kLanes - 1) / kLanes, 2 * kLanes, 0, stream>>>(
      x, env0, env, env_final, T, C, atk, rel);
  return (int)cudaGetLastError();
}

}  // extern "C"
