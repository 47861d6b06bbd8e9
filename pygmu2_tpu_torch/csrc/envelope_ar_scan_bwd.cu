// Adjoint of the attack/release envelope follower (csrc/envelope_ar_scan.cu)
// for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel
// pygmu2_tpu/ops/envelope_pallas.py:envelope_ar_pallas (:97), whose custom
// VJP (:134, ops/diffable.kernel_with_scan_vjp) replays jax.vjp of the
// lax.scan reference envelope_ar_scan_ref.
//
// What it computes. The forward, per channel: c_t = atk if x_t > e_{t-1}
// else rel, e_t = fma(c_t, x_t - e_{t-1}, e_{t-1}). The backward, with the
// residuals x, env (the forward's output) and env0, and the cotangents g
// of env and g_final of env_final:
//   lambda_t = g_t + (1 - c_{t+1}) lambda_{t+1},  lambda_{T-1} += g_final,
//   gx_t = c_t lambda_t,  genv0 = (1 - c_0) lambda_0.
// The coefficients are recomputed in parallel from the residuals (the
// forward's compares exactly); the recurrence runs as order1_adjoint.cuh's
// chunked reverse scan.
//
// What bounds it on this card: the bytes. At the fx bank's block
// (T = 16384, C = 128) it reads x, env and g and writes gx: 33.6 MB, 10 us
// at 3.35 TB/s; the chain per thread is kSeg = 16 samples and a
// 5-step scan a tile.

#include <cuda_runtime.h>

#include "order1_adjoint.cuh"

namespace {

struct Follower {
  const float* x;
  const float* env;
  const float* env0;
  float atk, rel;
  int C;
  __device__ __forceinline__ float at(int t, int c) const {
    const float prev = t > 0 ? env[(long)(t - 1) * C + c] : env0[c];
    return x[(long)t * C + c] > prev ? atk : rel;
  }
};

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: x / env / genv / gx (T, C) f32; env0 /
// genv_final / genv0 (C,) f32.
int envelope_ar_scan_bwd_launch(const float* x, const float* env0, const float* env,
                                const float* genv, const float* genv_final, float* gx,
                                float* genv0, int T, int C, float atk, float rel,
                                cudaStream_t stream) {
  const Follower op{x, env, env0, atk, rel, C};
  return (int)order1::launch(op, genv, genv_final, gx, genv0, T, C, stream);
}

}  // extern "C"
