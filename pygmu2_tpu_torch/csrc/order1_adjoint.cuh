// The adjoint of a first-order recurrence, chunked, for Hopper (sm_90a):
// the backward of the slew limiter (slew_scan_bwd.cu) and the comb's
// smoother (comb_scan_bwd.cu). (The follower's runs order1_grid.cuh, the
// design meant to take this one's place.)
//
// The forwards are y_t = y_{t-1} + k_t * (x_t - y_{t-1}) per channel,
// with k_t chosen per sample by a compare against the previous output
// (the slew limiter: p_rise or p_fall, or in its linear mode the clip's
// slope, 1 inside, 0 outside, 1/2 at a tie).
// The compares carry no gradient, so the backward is linear: with
// m_t = 1 - k_t and the cotangent lambda_t of y_t,
//   lambda_t = g_t + m_{t+1} * lambda_{t+1},
//   lambda_{T-1} = g_{T-1} + (the cotangent of the state out),
//   gx_t = k_t * lambda_t,   gy0 = m_0 * lambda_0 (the state in).
// Op::at(t, c) gives k_t, recomputed in parallel from the residuals (the
// input and the saved output: the forward's compares exactly); m_t is
// 1 - k_t rounded. A null g is all zeros: the comb's smoother
// (comb_scan_bwd.cu), whose only cotangent is the state out's.
//
// Design: one CUDA block per group of `width` channels, 1024 threads,
// (width channels) x (1024 / width lanes along time); width = C / 32
// within [1, 32], so a bank of 128 channels takes 32 SMs (4 channels a
// block), not 4. A tile of lanes x kSeg samples is taken from the end of
// the call to its start:
// 1. each thread loads its kSeg samples (k and g in registers) and walks
//    them backward from a zero carry: its segment as an affine map of the
//    carry entering from its right, out = A * in + B (A the product of
//    its m, B its walk's result);
// 2. a suffix scan of the maps over the lanes in shared memory
//    (Hillis-Steele, log2(lanes) steps) gives each segment its true carry
//    from the tile's (the carry out of the tile after it);
// 3. each thread walks its segment again from its carry and writes gx.
// No sample waits on a serial chain longer than kSeg + log2(lanes) steps.
// The sums run in another order than the plain adjoint's serial walk
// (ops/slew.slew_scan_bwd_ref, ops/envelope.order1_adjoint_ref), so
// the two agree to a few float32 roundings, not bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace order1 {

constexpr int kThreads = 1024;
constexpr int kSeg = 16;  // samples a thread walks in a tile
constexpr int kMaxWidth = 32;

template <class Op>
__global__ void __launch_bounds__(kThreads) adjoint(Op op, const float* __restrict__ g,
                                                    const float* __restrict__ g_final,
                                                    float* __restrict__ gx,
                                                    float* __restrict__ g_state_in, int T,
                                                    int C) {
  __shared__ float s_a[kThreads], s_b[kThreads];
  const int width = blockDim.x, lanes = blockDim.y;
  const int x = threadIdx.x, y = threadIdx.y, me = y * width + x;
  const int c = blockIdx.x * width + x;
  const bool live = c < C;
  const int tile = lanes * kSeg;
  float carry = live ? g_final[c] : 0.0f;  // what enters the tile's last sample
  for (int t_end = T; t_end > 0; t_end -= tile) {
    const int t0 = max(t_end - tile, 0);
    const int s0 = t_end - (lanes - y) * kSeg;  // this lane's first sample (may be < t0)
    float k[kSeg], gv[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int t = s0 + i;
      k[i] = 0.0f, gv[i] = 0.0f;  // outside the call: the identity (m = 1)
      if (live && t >= t0) {
        k[i] = op.at(t, c);
        gv[i] = g != nullptr ? g[(long)t * C + c] : 0.0f;
      }
    }
    // 1. the segment's map from a zero carry
    float a = 1.0f, b = 0.0f;
#pragma unroll
    for (int i = kSeg - 1; i >= 0; --i) {
      const float m = __fsub_rn(1.0f, k[i]);
      b = __fmul_rn(m, __fadd_rn(gv[i], b));
      a = __fmul_rn(a, m);
    }
    s_a[me] = a, s_b[me] = b;
    __syncthreads();
    // 2. suffix scan over the lanes: lane y holds F_y o F_{y+1} o ... o F_last
    for (int d = 1; d < lanes; d <<= 1) {
      float na = s_a[me], nb = s_b[me];
      if (y + d < lanes) {
        const int o = me + d * width;
        nb = __fmaf_rn(na, s_b[o], nb);
        na = __fmul_rn(na, s_a[o]);
      }
      __syncthreads();
      s_a[me] = na, s_b[me] = nb;
      __syncthreads();
    }
    float in = carry;
    if (y + 1 < lanes) in = __fmaf_rn(s_a[me + width], carry, s_b[me + width]);
    // 3. the segment again from its carry
#pragma unroll
    for (int i = kSeg - 1; i >= 0; --i) {
      const float lam = __fadd_rn(gv[i], in);
      if (live && s0 + i >= t0) gx[(long)(s0 + i) * C + c] = __fmul_rn(k[i], lam);
      in = __fmul_rn(__fsub_rn(1.0f, k[i]), lam);
    }
    carry = __fmaf_rn(s_a[x], carry, s_b[x]);  // out of lane 0: into the tile before
    __syncthreads();
  }
  if (live && threadIdx.y == 0) g_state_in[c] = carry;
}

// Enqueues the adjoint on `stream` for C channels.
template <class Op>
cudaError_t launch(const Op& op, const float* g, const float* g_final, float* gx,
                   float* g_state_in, int T, int C, cudaStream_t stream) {
  if (T < 1 || C < 1) return cudaErrorInvalidValue;
  const int width = C / 32 < 1 ? 1 : (C / 32 > kMaxWidth ? kMaxWidth : C / 32);
  const dim3 threads(width, kThreads / width);
  adjoint<Op><<<(C + width - 1) / width, threads, 0, stream>>>(op, g, g_final, gx, g_state_in,
                                                               T, C);
  return cudaGetLastError();
}

}  // namespace order1
