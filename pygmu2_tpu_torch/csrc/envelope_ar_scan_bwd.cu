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
// forward's compares exactly); the recurrence runs as order1_grid.cuh's
// adjoint over the card: 256-sample chunks x tiles of channels, the chunks'
// maps carried in a fixed order (ops/envelope.envelope_ar_scan_bwd_chunked
// is its order in torch ops, equal to it bit for bit).
//
// What bounds it on this card: the bytes. At the fx bank's block
// (T = 16384, C = 128) it reads x, env and g and writes gx: 33.6 MB, 10 us
// at 3.35 TB/s; at the fit chain's (C = 1) 196 KB, where the launch and its
// dependent steps set the time. (The first design ran one CUDA block of
// 1024 threads per C / 32 channels: one SM at C = 1.)

#include <cuda_runtime.h>

#include "order1_grid.cuh"

namespace {

struct Follower {
  float atk, rel;
  __device__ __forceinline__ float k(float x, float prev) const {
    return x > prev ? atk : rel;
  }
};

}  // namespace

extern "C" {

// Enqueues the call on `stream` (a memset of `flags`, then the kernel);
// returns the cudaError_t of the first step that failed (0: both
// accepted). Device pointers: x / env / genv / gx (T, C) f32; env0 /
// genv_final / genv0 (C,) f32; agg (2, ceil(T / 256), C) f32 and flags
// 1 + ceil(T / 256) * ceil(C / W) int32 scratch, W = C rounded up to a
// power of two, at most 32.
int envelope_ar_scan_bwd_launch(const float* x, const float* env0, const float* env,
                                const float* genv, const float* genv_final, float* gx,
                                float* genv0, float* agg, int* flags, int T, int C, float atk,
                                float rel, cudaStream_t stream) {
  return (int)order1_grid::launch(Follower{atk, rel}, x, env, env0, genv, genv_final, gx, genv0,
                                  agg, flags, T, C, stream);
}

}  // extern "C"
