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
// order1_grid.cuh's adjoint at one channel, err_t recomputed from x and the
// saved output with the forward's rounding
// (ops/slew.slew_scan_bwd_chunked is its order in torch ops, equal to it
// bit for bit).
//
// What bounds it on this card: at the chain's block (T = 16384) it reads
// x, y and g and writes gx: 256 KB, 0.08 us at 3.35 TB/s; the launch and
// its dependent steps set the time. The grid spreads the call over 64 CUDA
// blocks of 256-sample chunks (the first design ran one CUDA block of 1024
// threads, 16 samples each, on one SM). Measured
// (kernel_times.py, the kernel alone by torch.profiler; NVIDIA H100 80GB
// HBM3, 700 W): 0.0064-0.0066 ms at T = 16384 in both modes, and the
// memset's 0.0009; the first design 0.0276-0.0278.

#include <cuda_runtime.h>

#include "order1_grid.cuh"

namespace {

struct Slew {
  float p_rise, p_fall;
  bool linear;
  __device__ __forceinline__ float k(float x, float prev) const {
    const float err = __fsub_rn(x, prev);
    if (!linear) return err > 0.0f ? p_rise : p_fall;
    if (err == p_rise || err == -p_fall) return 0.5f;  // a tie: the gradient split
    return err < p_rise && err > -p_fall ? 1.0f : 0.0f;
  }
};

}  // namespace

extern "C" {

// Enqueues the call on `stream` (a memset of `flags`, then the kernel);
// returns the cudaError_t of the first step that failed (0: both
// accepted). Device pointers: x / y / gy / gx (T,) f32; cur_in / gcur_out /
// gcur_in () f32; agg (2, ceil(T / 256)) f32 and flags 1 + ceil(T / 256)
// int32 scratch.
int slew_scan_bwd_launch(const float* x, const float* cur_in, const float* y, const float* gy,
                         const float* gcur_out, float* gx, float* gcur_in, float* agg,
                         int* flags, int T, int linear, float p_rise, float p_fall,
                         cudaStream_t stream) {
  return (int)order1_grid::launch(Slew{p_rise, p_fall, linear != 0}, x, y, cur_in, gy, gcur_out,
                                  gx, gcur_in, agg, flags, T, 1, stream);
}

}  // extern "C"
