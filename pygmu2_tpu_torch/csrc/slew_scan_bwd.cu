// Adjoint of the two-sided slew limiter (csrc/slew_scan.cu) for Hopper
// (sm_90a).
//
// Replaces the backward of the TPU kernel
// pygmu2_tpu/ops/slew_pallas.py:slew_scan_pallas (:107), whose custom VJP
// (:145, ops/diffable.kernel_with_scan_vjp) replays jax.vjp of the lax.scan
// reference slew_scan_ref.
//
// What it computes. The forward: err_t = x_t - y_{t-1} (y_{-1} = cur0),
//   LINEAR:       y_t = y_{t-1} + min(max(err_t, -p_fall), p_rise)
//   EXPONENTIAL:  y_t = y_{t-1} + k_t * err_t, k_t = err_t > 0 ? p_rise : p_fall.
// The limits and the choice of k_t are constants to the gradient, so
// y_t = y_{t-1} + k_t * (x_t - y_{t-1}) with, in the linear mode, k_t the
// clip's slope: 1 inside the limits, 0 outside, and 1/2 where err_t equals
// a limit exactly (autograd of torch.minimum / torch.maximum and jax.vjp of
// jnp.clip both split the gradient at a tie). The backward is then
// order1_adjoint.cuh's recurrence at one channel, err_t recomputed from x
// and the saved output with the forward's rounding.
//
// What bounds it on this card: at the chain's block (T = 16384) it reads
// x, y and g and writes gx: 256 KB, 0.08 us at 3.35 TB/s; one CUDA block of
// 1024 lanes, 16 samples each, and a 10-step scan.

#include <cuda_runtime.h>

#include "order1_adjoint.cuh"

namespace {

struct Slew {
  const float* x;
  const float* y;
  const float* cur0;
  float p_rise, p_fall;
  bool linear;
  __device__ __forceinline__ float at(int t, int) const {
    const float err = __fsub_rn(x[t], t > 0 ? y[t - 1] : *cur0);
    if (!linear) return err > 0.0f ? p_rise : p_fall;
    if (err == p_rise || err == -p_fall) return 0.5f;  // a tie: the gradient split
    return err < p_rise && err > -p_fall ? 1.0f : 0.0f;
  }
};

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: x / y / gy / gx (T,) f32; cur_in / gcur_out /
// gcur_in () f32.
int slew_scan_bwd_launch(const float* x, const float* cur_in, const float* y, const float* gy,
                         const float* gcur_out, float* gx, float* gcur_in, int T, int linear,
                         float p_rise, float p_fall, cudaStream_t stream) {
  const Slew op{x, y, cur_in, p_rise, p_fall, linear != 0};
  return (int)order1::launch(op, gy, gcur_out, gx, gcur_in, T, 1, stream);
}

}  // extern "C"
