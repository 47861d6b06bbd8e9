// Asymmetric attack/release envelope follower, serial in time, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pygmu2_tpu/ops/envelope_pallas.py:
// envelope_ar_pallas (:97), which keeps the envelope of 128 lanes in vector
// registers and walks a sequential grid of time chunks.
//
// What it computes (the op order of envelope_ar_scan_ref, float32), per
// sample t and channel c:
//   coeff = x[t, c] > e ? atk : rel
//   e     = e + coeff * (x[t, c] - e);   env[t, c] = e
//
// What bounds it on this card: the dependent chain. At the main path's
// block (T = 16384) it moves 8 bytes per sample and channel (16.8 MB at
// C = 128: roofline 5.0 us at 3.35 TB/s) and does 4 ops per sample and
// channel. Each sample's compare, select, subtract, multiply and add
// depend on the previous sample's envelope: ~20 cycles, a serial floor of
// ~0.17 ms per 16384 samples at 1.98 GHz, whatever C. Measured
// (chip_smoke.py, H100 80GB HBM3, 700 W): 0.47 ms at C = 1, 0.54 ms at
// C = 128.
//
// What the design does about it: one thread per channel with the
// envelope in a register; neighbouring threads read neighbouring
// channels, so each sample's row is one coalesced load, and the loads do
// not depend on the chain, so the unrolled loop issues them ahead of it.
// Blocks of 32 channels spread a wide batch over SMs. Explicitly rounded
// float ops keep the kernel equal to the plain PyTorch version bit for bit
// (the coefficient switches on x > e: one ulp can flip a sample).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void envelope_ar_scan(const float* __restrict__ x,
                                 const float* __restrict__ env0,
                                 float* __restrict__ env,
                                 float* __restrict__ env_final, int T, int C,
                                 float atk, float rel) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float e = env0[c];
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const long i = (long)t * C + c;
    const float xi = x[i];
    const float coeff = xi > e ? atk : rel;
    e = __fadd_rn(e, __fmul_rn(coeff, __fsub_rn(xi, e)));
    env[i] = e;
  }
  env_final[c] = e;
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: x / env (T, C) f32, env0 / env_final (C,)
// f32.
int envelope_ar_scan_launch(const float* x, const float* env0, float* env,
                            float* env_final, int T, int C, float atk,
                            float rel, cudaStream_t stream) {
  const int block = C < kThreads ? C : kThreads;
  envelope_ar_scan<<<(C + block - 1) / block, block, 0, stream>>>(
      x, env0, env, env_final, T, C, atk, rel);
  return (int)cudaGetLastError();
}

}  // extern "C"
