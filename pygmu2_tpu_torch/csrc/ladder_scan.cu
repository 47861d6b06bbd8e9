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
// previous sample's 9 states, and one sample is os_n = 2 steps of input
// interpolation and feedback (~28 cycles), tanhf (~40) and four stages of
// five dependent float ops (~80): ~300 cycles, a serial floor of ~2.5 ms
// per 16384 samples at 1.98 GHz whatever C. Measured on an H100 SXM
// (700 W): 5.5 ms at C = 1, 7.3 ms at C = 128.
//
// What the design does about it: one thread per channel loops over T with
// the 9 states in registers; the (T,) coefficient columns are read by
// every thread (broadcast loads, L1-resident), and x / y are (T, C)
// row-major, so a warp's accesses at one t are coalesced. The chain's
// latency is not hidden: a C = 1 patch runs one thread on the whole card.
// The arithmetic uses explicitly rounded float ops (__fmul_rn, __fadd_rn)
// so that FMA contraction cannot change a rounding against the plain
// PyTorch version; with tanhf, the function PyTorch's own CUDA tanh calls,
// the kernel equals the plain version on the card bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per CUDA block
constexpr float kC1 = 0.76923077f;  // trapezoidal stage weights
constexpr float kC2 = 0.23076923f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

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

__global__ void ladder_scan(const float* __restrict__ x,
                            const float* __restrict__ al,
                            const float* __restrict__ qa,
                            const float* __restrict__ ki,
                            const float* __restrict__ dsc,
                            const float* __restrict__ state_in,
                            float* __restrict__ y, float* __restrict__ state_out,
                            int T, int C, int os_n, float pbg, int mode,
                            float threshold, float state_decay) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float z0[4], z1[4];
  for (int k = 0; k < 4; ++k) {
    z0[k] = state_in[k * C + c];
    z1[k] = state_in[(4 + k) * C + c];
  }
  float old = state_in[8 * C + c];
  // the plain version's Python doubles: os_recip = 1/os_n,
  // interp = s * os_recip and 1 - interp, each rounded to float once
  const double recip = 1.0 / os_n;
  const float os_recip = (float)recip;

  for (int t = 0; t < T; ++t) {
    const long row = (long)t * C;
    const float a = al[t], q = qa[t], k = ki[t];
    const float in_s = mul(x[row + c], dsc[t]);
    const float decay = fabsf(in_s) < threshold ? state_decay : 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      z0[i] = mul(z0[i], decay);
      z1[i] = mul(z1[i], decay);
    }
    old = mul(old, decay);

    float total = 0.0f;
    for (int s = 0; s < os_n; ++s) {
      const float interp = (float)(s * recip);
      const float one_minus = (float)(1.0 - s * recip);
      const float in_i = add(mul(interp, old), mul(one_minus, in_s));
      const float u = tanhf(sub(in_i, mul(mul(sub(z1[3], mul(pbg, in_i)), k), q)));
      float stages[4];
      float prev = u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ft = sub(add(mul(prev, kC1), mul(kC2, z0[i])), z1[i]);
        ft = add(mul(ft, a), z1[i]);
        z1[i] = ft;
        z0[i] = prev;
        stages[i] = ft;
        prev = ft;
      }
      total = add(total, mul(mode_mix(mode, u, stages), os_recip));
    }
    y[row + c] = total;
    old = in_s;
  }
  for (int k = 0; k < 4; ++k) {
    state_out[k * C + c] = z0[k];
    state_out[(4 + k) * C + c] = z1[k];
  }
  state_out[8 * C + c] = old;
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: x / y (T, C) f32, al / qa / ki / dsc (T,)
// f32, state_in / state_out (9, C) f32.
int ladder_scan_launch(const float* x, const float* al, const float* qa,
                       const float* ki, const float* dsc,
                       const float* state_in, float* y, float* state_out,
                       int T, int C, int os_n, float pbg, int mode_index,
                       float input_threshold, float state_decay,
                       cudaStream_t stream) {
  const int block = C < kThreads ? C : kThreads;
  ladder_scan<<<(C + block - 1) / block, block, 0, stream>>>(
      x, al, qa, ki, dsc, state_in, y, state_out, T, C, os_n, pbg, mode_index,
      input_threshold, state_decay);
  return (int)cudaGetLastError();
}

}  // extern "C"
