// Moog ladder filter, serial in time, for Hopper (sm_90a).
//
// Replaces the TPU kernel pygmu2_tpu/ops/ladder_pallas.py:ladder_scan_pallas
// (:202), which runs 128 channels on the VPU lanes over a sequential grid of
// time chunks with the 9 filter states in VMEM scratch.
//
// What it computes, per channel c and sample t (the op order of
// ladder_scan_ref, float32): the input x[t, c] * drive, a quiet-input state
// decay, then os_n oversampled steps of a tanh-saturated feedback into four
// trapezoidal one-pole stages, mixed by the response mode. The (9, C) state
// [z0[0..3]; z1[0..3]; old] enters and leaves through global memory.
//
// What bounds it on this card: neither bytes nor operations. At the main
// path's block (T = 16384, C = 128) it moves 17 MB (roofline 5.1 us at
// 3.35 TB/s) and does 82 float ops per sample and channel (2.6 us at
// 67 TFLOP/s). The bound is the dependent chain: every sample needs the
// previous sample's 9 states, and one sample is the decay of the states,
// then os_n = 2 steps of feedback (~16 cycles), tanhf (~40) and four
// stages of five dependent float ops (~80): ~280 cycles, a serial floor
// of ~2.3 ms per 16384 samples at 1.98 GHz whatever C, as first
// estimated. The first design
// (one thread per channel, each sample starting with global loads of x
// and the four coefficient columns, all 128 channels of a bank in one
// CUDA block) measured 5.54 ms at C = 1 and 7.36 ms at C = 128
// (chip_smoke.py, H100 80GB HBM3, 700 W): the load latency sat on the
// chain, because the decay that multiplies all nine states depends on
// |x * drive|.
//
// What the design does about it: the inputs are taken off the chain.
// Each CUDA block is two warps and 32 channels, so a bank of 128 runs on
// four SMs. The producer warp streams chunks of 32 samples of the x rows
// and of the four (T,) columns into a ring of four shared-memory stages
// with cp.async, each stage's arrival tracked by an mbarrier
// (cp.async.mbarrier.arrive), and drains the y rows the consumer left in
// the stage back to global memory once the consumer releases it (a second
// mbarrier). The consumer warp holds one channel per lane with the nine
// states in registers and reads only shared memory; the input, its drive
// product and the decay of sample t + 1 are computed while sample t's
// chain runs. The oversampling factor is a template parameter for 1, 2
// and 4 (LadderPE's default is 2), where the interpolation weights fold
// to constants and the loop unrolls; one generic instantiation takes any
// other os_n >= 1. The arithmetic uses explicitly rounded float ops
// (__fmul_rn, __fadd_rn) so that FMA contraction cannot change a rounding
// against the plain PyTorch version; with tanhf, the function PyTorch's
// own CUDA tanh calls, the kernel equals the plain version on the card
// bit for bit.
//
// Measured (chip_smoke.py's timed case, os_n = 2; H100 80GB HBM3, 700 W):
// 3.5541 ms at C = 1 and 3.5628 ms at C = 128 (82 registers, no spills):
// the same at both widths, so the chain alone sets it, ~400 cycles a
// sample. Counted again with tanhf at an estimated ~90 cycles (not ~40)
// the chain comes to ~370; tanhf's SASS is not read. What remains is the
// chain's own arithmetic, which parity with the plain version fixes.
//
// Checkpoints for the backward (csrc/ladder_scan_bwd.cu): given a
// non-null `ckpt`, the consumer also leaves each channel's entering state
// (9 floats) in the stage every `every` samples (a multiple of kChunk),
// and the producer drains it with the y rows into a (ceil(T / every), 9,
// C) tensor. The consumer only stores to shared memory: a first cut that
// had the consumer store them to device memory slowed the forward
// measurably, the stores drained before each release of the stage. y and
// the state out are the same bits with or without them.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 32;   // channels per CUDA block: one consumer warp
constexpr int kChunk = 32;   // samples per ring stage
constexpr int kStages = 4;
constexpr float kC1 = 0.76923077f;  // trapezoidal stage weights
constexpr float kC2 = 0.23076923f;

struct Stage {
  float x[kChunk][kLanes];
  float y[kChunk][kLanes];
  float col[4][kChunk];  // al, qa, ki, dsc
  float ck[9][kLanes];   // the chunk's entering state, where it is a checkpoint
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               ::"r"(smem(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  // labels inside braces are local to the block in PTX
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(smem(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem(dst)), "l"(src)
               : "memory");
}
// the barrier counts this thread's arrival once its cp.async copies land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem(bar))
               : "memory");
}

__device__ __forceinline__ float mode_mix(int mode, float u, const float* s) {
  switch (mode) {
    case 0: return s[3];
    case 1: return s[1];
    case 2: return sub(mul(add(s[1], s[3]), 4.0f), mul(s[2], 8.0f));
    case 3: return mul(sub(s[0], s[1]), 2.0f);
    case 4: return add(sub(add(u, s[3]), mul(add(s[0], s[2]), 4.0f)), mul(s[1], 6.0f));
    default: return sub(add(u, s[1]), mul(s[0], 2.0f));
  }
}

// OS > 0: os_n is OS, folded at compile time; OS == 0: os_n at run time
template <int OS>
__global__ void __launch_bounds__(2 * kLanes) ladder_scan(
    const float* __restrict__ x, const float* __restrict__ al,
    const float* __restrict__ qa, const float* __restrict__ ki,
    const float* __restrict__ dsc, const float* __restrict__ state_in,
    float* __restrict__ y, float* __restrict__ state_out, float* __restrict__ ckpt,
    int every, int T, int C, int os_n_arg, float pbg, int mode, float threshold,
    float state_decay) {
  __shared__ Stage ring[kStages];
  __shared__ uint64_t full[kStages], done[kStages];
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kLanes;
  const int width = min(kLanes, C - c0);
  const bool live = lane < width;
  const int c = c0 + lane;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kLanes);  // the producer's 32 threads
      mbar_init(&done[s], kLanes);  // the consumer's 32 threads
    }
  __syncthreads();

  if (threadIdx.x >= kLanes) {  // ---- the producer warp ----
    const float* cols[4] = {al, qa, ki, dsc};
    auto drain = [&](int j) {  // chunk j's y rows, from its stage to global
      mbar_wait(&done[j % kStages], (j / kStages) & 1);
      const Stage& st = ring[j % kStages];
      const int base = j * kChunk, n = min(kChunk, T - base);
      if (live) {
        for (int i = 0; i < n; ++i) y[(long)(base + i) * C + c] = st.y[i][lane];
        if (ckpt != nullptr && base % every == 0)
          for (int k = 0; k < 9; ++k) ckpt[((long)(base / every) * 9 + k) * C + c] = st.ck[k][lane];
      }
    };
    for (int j = 0; j < n_chunks; ++j) {
      if (j >= kStages) drain(j - kStages);
      Stage& st = ring[j % kStages];
      const int base = j * kChunk, n = min(kChunk, T - base);
      if (live)
        for (int i = 0; i < n; ++i) cp_async4(&st.x[i][lane], x + (long)(base + i) * C + c);
      for (int k = 0; k < 4; ++k)
        for (int i = lane; i < n; i += kLanes) cp_async4(&st.col[k][i], cols[k] + base + i);
      cp_async_arrive(&full[j % kStages]);
    }
    for (int j = max(n_chunks - kStages, 0); j < n_chunks; ++j) drain(j);
    return;
  }

  // ---- the consumer warp: one channel per lane ----
  float z0[4], z1[4], old = 0.0f;
  if (live) {
    for (int k = 0; k < 4; ++k) {
      z0[k] = state_in[k * C + c];
      z1[k] = state_in[(4 + k) * C + c];
    }
    old = state_in[8 * C + c];
  } else {
    for (int k = 0; k < 4; ++k) z0[k] = z1[k] = 0.0f;
  }
  // the plain version's Python doubles: os_recip = 1/os_n,
  // interp = s * os_recip and 1 - interp, each rounded to float once
  const int os_n = OS > 0 ? OS : os_n_arg;
  const double recip = 1.0 / os_n;
  int ck_count = 0;  // chunks since the last checkpoint
  const float os_recip = (float)recip;

  for (int j = 0; j < n_chunks; ++j) {
    Stage& st = ring[j % kStages];
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    const int n = min(kChunk, T - j * kChunk);
    if (ckpt != nullptr && ck_count == 0) {  // the entering state, for the producer
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        st.ck[k][lane] = z0[k];
        st.ck[4 + k][lane] = z1[k];
      }
      st.ck[8][lane] = old;
    }
    if (++ck_count == every / kChunk) ck_count = 0;
    // sample i's input and decay, computed one sample ahead of the chain
    float in_s = mul(st.x[0][lane], st.col[3][0]);
    float decay = fabsf(in_s) < threshold ? state_decay : 1.0f;
    for (int i = 0; i < n; ++i) {
      const float a = st.col[0][i], q = st.col[1][i], k = st.col[2][i];
      const int nx = i + 1 < n ? i + 1 : i;
      const float in_next = mul(st.x[nx][lane], st.col[3][nx]);
      const float decay_next = fabsf(in_next) < threshold ? state_decay : 1.0f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        z0[s] = mul(z0[s], decay);
        z1[s] = mul(z1[s], decay);
      }
      old = mul(old, decay);

      float total = 0.0f;
#pragma unroll
      for (int s = 0; s < os_n; ++s) {
        const float interp = (float)(s * recip);
        const float one_minus = (float)(1.0 - s * recip);
        const float in_i = add(mul(interp, old), mul(one_minus, in_s));
        const float u = tanhf(sub(in_i, mul(mul(sub(z1[3], mul(pbg, in_i)), k), q)));
        float stages[4];
        float prev = u;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float ft = sub(add(mul(prev, kC1), mul(kC2, z0[m])), z1[m]);
          ft = add(mul(ft, a), z1[m]);
          z1[m] = ft;
          z0[m] = prev;
          stages[m] = ft;
          prev = ft;
        }
        total = add(total, mul(mode_mix(mode, u, stages), os_recip));
      }
      st.y[i][lane] = total;
      old = in_s;
      in_s = in_next;
      decay = decay_next;
    }
    mbar_arrive(&done[j % kStages]);
  }
  if (live) {
    for (int k = 0; k < 4; ++k) {
      state_out[k * C + c] = z0[k];
      state_out[(4 + k) * C + c] = z1[k];
    }
    state_out[8 * C + c] = old;
  }
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: x / y (T, C) f32, al / qa / ki / dsc (T,)
// f32, state_in / state_out (9, C) f32; ckpt (ceil(T / every), 9, C) f32
// or null (no checkpoints), every a multiple of 32.
int ladder_scan_launch(const float* x, const float* al, const float* qa,
                       const float* ki, const float* dsc,
                       const float* state_in, float* y, float* state_out, float* ckpt,
                       int every, int T, int C, int os_n, float pbg, int mode_index,
                       float input_threshold, float state_decay,
                       cudaStream_t stream) {
  if (ckpt != nullptr && (every < kChunk || every % kChunk != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kLanes - 1) / kLanes), block(2 * kLanes);
#define PGT_LADDER(OS)                                                                  \
  ladder_scan<OS><<<grid, block, 0, stream>>>(x, al, qa, ki, dsc, state_in, y, state_out, \
                                              ckpt, every, T, C, os_n, pbg, mode_index,  \
                                              input_threshold, state_decay)
  switch (os_n) {
    case 1: PGT_LADDER(1); break;
    case 2: PGT_LADDER(2); break;
    case 4: PGT_LADDER(4); break;
    default: PGT_LADDER(0);
  }
#undef PGT_LADDER
  return (int)cudaGetLastError();
}

}  // extern "C"
