// Adjoint of the feedback comb (csrc/comb_scan.cu) for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel
// pygmu2_tpu/ops/comb_pallas.py:comb_scan_pallas (:125), whose custom VJP
// (:185, ops/diffable.kernel_with_scan_vjp) replays jax.vjp of the
// lax.scan reference comb_scan_ref.
//
// What it computes. The forward, on the tape Y (L + T rows: the ring handed
// in, rolled to start at pos, then y):
//   y_t = x_t + fb_t * Y[L + t - delay_t],  Y[L + t] = y_t,
// delay_t = clip(rint(sr / max(sf_t, 1)), 1, L - 1) from the one-pole
// smoother sf_t = sf_{t-1} < 0 ? f_t : sf_{t-1} + (f_t - sf_{t-1}) * alpha.
// The backward, with G the tape's cotangent (G[L + t] starts as gy_t, plus
// the cotangent of buf_out on the ring's last L positions):
//   for t = T - 1 down to 0: gx_t = G[L + t];
//     G[L + t - delay_t] += fb_t * G[L + t];
//     gfb_t = sum over c of G[L + t, c] * Y[L + t - delay_t, c];
// the entering ring's cotangent is G[0, L) rolled back by pos. The delay
// is a rounding: no gradient reaches freq or sf through it; they get only
// the cotangent of the carried smoothed frequency sf_out, walked back
// through the smoother (as jax.vjp of comb_scan_ref does).
//
// Design (simple and right first):
// 1. comb_bwd_control, one thread: the smoother forward (the forward's
//    rounded ops, so the same delays), keeping each sample's entering
//    smoothed value, then its adjoint backward: gfreq and gsf.
// 2. comb_bwd_walk, one thread per channel: fills its column of G, walks
//    t backward serially (two reads and a read-modify-write of G a sample,
//    in global memory), writes gx, the per-channel parts of gfb, and the
//    entering ring's cotangent.
// 3. channel_sum (channel_sum.cuh) adds the parts over the channels in
//    channel order: no atomics, so two runs give the same bits.
//
// What bounds it on this card: the serial walk, a dependent chain through
// global memory (a sample's read of G may be the write of a later sample
// just processed), ~1 us a sample. Bytes at T = 16384, C = 128,
// L = 2206: x's, y's and gy's rows, G written and read, the parts, ~45 MB
// (13 us at 3.35 TB/s). The window-parallel reverse (the forward's own
// design run backward) is later work (ROADMAP queue 2).

#include <cuda_runtime.h>

#include "channel_sum.cuh"

namespace {

constexpr int kThreads = 32;  // channels per CUDA block of the walk

__global__ void comb_bwd_control(const float* __restrict__ freq, const float* __restrict__ sf_in,
                                 const float* __restrict__ gsf, float* __restrict__ gfreq,
                                 float* __restrict__ gsf_in, int* __restrict__ delay,
                                 float* __restrict__ sf_prev, int T, int L, float sr,
                                 float alpha) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  float sf = *sf_in;
  for (int t = 0; t < T; ++t) {
    const float f = freq[t];
    sf_prev[t] = sf;
    sf = sf < 0.0f ? f : __fadd_rn(sf, __fmul_rn(__fsub_rn(f, sf), alpha));
    const int d = (int)rintf(__fdiv_rn(sr, fmaxf(sf, 1.0f)));
    delay[t] = min(max(d, 1), L - 1);
  }
  float g = *gsf;  // the cotangent of the smoothed value after sample t
  for (int t = T - 1; t >= 0; --t) {
    if (sf_prev[t] < 0.0f) {  // the select took f: sf_prev gets nothing
      gfreq[t] = g;
      g = 0.0f;
    } else {
      const float ga = g * alpha;
      gfreq[t] = ga;
      g = g - ga;
    }
  }
  *gsf_in = g;
}

__global__ void __launch_bounds__(kThreads) comb_bwd_walk(
    const float* __restrict__ fb, const float* __restrict__ buf_in, const int* __restrict__ pos_in,
    const float* __restrict__ y, const float* __restrict__ gy, const float* __restrict__ gbuf,
    const int* __restrict__ delay, float* __restrict__ gx, float* __restrict__ gbuf_in,
    float* __restrict__ G, float* __restrict__ part, int T, int C, int L) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int p0 = *pos_in;
  // the tape's cotangent: gy on rows L.., buf_out's on the last L rows
  for (int q = 0; q < L + T; ++q) {
    float v = q >= L ? gy[(long)(q - L) * C + c] : 0.0f;
    if (q >= T) v += gbuf[(long)((p0 + q) % L) * C + c];
    G[(long)q * C + c] = v;
  }
  for (int t = T - 1; t >= 0; --t) {
    const float g = G[(long)(L + t) * C + c];
    const int src = L + t - delay[t];
    const float val = src >= L ? y[(long)(src - L) * C + c] : buf_in[(long)((p0 + src) % L) * C + c];
    gx[(long)t * C + c] = g;
    part[(long)t * C + c] = g * val;
    G[(long)src * C + c] += fb[t] * g;
  }
  for (int q = 0; q < L; ++q) gbuf_in[(long)((p0 + q) % L) * C + c] = G[(long)q * C + c];
}

}  // namespace

extern "C" {

// Enqueues the control pass, the walk and the channel sum on `stream`;
// returns the first cudaError_t (0 when all were accepted). Device
// pointers: freq / fb / gfreq / gfb (T,) f32; buf_in / gbuf / gbuf_in (L, C)
// f32; pos_in () i32; sf_in / gsf / gsf_in () f32; y / gy / gx (T, C) f32;
// scratch delay (T,) i32, sf_prev (T,) f32, G (L + T, C) f32, part (T, C)
// f32. Needs L >= 2.
int comb_scan_bwd_launch(const float* freq, const float* fb, const float* buf_in,
                         const int* pos_in, const float* sf_in, const float* y, const float* gy,
                         const float* gbuf, const float* gsf, float* gx, float* gfreq,
                         float* gfb, float* gbuf_in, float* gsf_in, int* delay, float* sf_prev,
                         float* G, float* part, int T, int C, int L, float sr,
                         float smooth_alpha, cudaStream_t stream) {
  if (T < 1 || C < 1 || L < 2) return (int)cudaErrorInvalidValue;
  comb_bwd_control<<<1, 32, 0, stream>>>(freq, sf_in, gsf, gfreq, gsf_in, delay, sf_prev, T, L,
                                         sr, smooth_alpha);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  comb_bwd_walk<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      fb, buf_in, pos_in, y, gy, gbuf, delay, gx, gbuf_in, G, part, T, C, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_channel_sum(part, gfb, T, C, stream);
}

}  // extern "C"
