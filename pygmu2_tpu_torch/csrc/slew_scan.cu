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
// does 3 ops per sample; each sample's subtract, clamp (or compare,
// select and multiply) and add depend on the previous sample's value:
// ~12-16 cycles, a serial floor of ~0.1-0.13 ms per 16384 samples at
// 1.98 GHz. Measured (chip_smoke.py, H100 80GB HBM3, 700 W): 0.50 ms in
// either mode. The composed per-step maps (slopes 0 and 1) grow
// staircases, so no fixed-size associative form splits the chain.
//
// What the design does about it: one thread with the value in a
// register; the input loads do not depend on the chain, so the unrolled
// loop issues them ahead of it. Explicitly rounded float ops keep the
// kernel equal to the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

__global__ void slew_scan(const float* __restrict__ x,
                          const float* __restrict__ cur_in,
                          float* __restrict__ y, float* __restrict__ cur_out,
                          int T, bool linear, float p_rise, float p_fall) {
  float cur = *cur_in;
  if (linear) {
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      cur = __fadd_rn(cur, fminf(fmaxf(__fsub_rn(x[t], cur), -p_fall), p_rise));
      y[t] = cur;
    }
  } else {
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      const float err = __fsub_rn(x[t], cur);
      cur = __fadd_rn(cur, __fmul_rn(err > 0.0f ? p_rise : p_fall, err));
      y[t] = cur;
    }
  }
  *cur_out = cur;
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: x / y (T,) f32, cur_in / cur_out () f32.
int slew_scan_launch(const float* x, const float* cur_in, float* y,
                     float* cur_out, int T, int linear, float p_rise,
                     float p_fall, cudaStream_t stream) {
  slew_scan<<<1, 1, 0, stream>>>(x, cur_in, y, cur_out, T, linear != 0,
                                 p_rise, p_fall);
  return (int)cudaGetLastError();
}

}  // extern "C"
