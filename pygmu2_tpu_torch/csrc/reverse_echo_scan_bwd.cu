// Adjoint of the reverse pitch echo (csrc/reverse_echo_scan.cu) for Hopper
// (sm_90a).
//
// Replaces the backward of the TPU kernel
// pygmu2_tpu/ops/reverse_echo_pallas.py:reverse_echo_scan_pallas (:338),
// whose custom VJP (:406, ops/diffable.kernel_with_scan_vjp) replays
// jax.vjp of the lax.scan reference reverse_echo_scan_ref.
//
// What it computes. The forward, per sample t and channel: the pitch line
// takes x_t; pitched_t = f (w0 p0 + w1 p1) + (1 - f)(w2 p2 + w3 p3) from
// four taps of the line (x_t itself near unity pitch); wet_t = the previous
// block's row rrow_t times the window; the current block's row wrow_t =
// pitched_t + wet_t fb_t; y_t = wet_t. The taps' weights and the crossfade
// f follow the read position p_rpos, a running sum of the ratio; the block
// length and the alternation enter only through roundings and compares
// (zero cotangents, as jax.vjp of the reference gives them). The backward,
// with lambda the cotangents of the two block buffers (entering as those of
// buf_a' and buf_b'), walks the periods in reverse; in each, every (t, c):
//   gc = lambda_cur[wrow_t]; lambda_cur[wrow_t] = 0  (the row was written)
//   replaying: gwet = gy_t + fb_t gc, lambda_prev[rrow_t] += window_t gwet,
//              gfb part = gc y_t (y_t is wet_t: the rings were overwritten)
//   gpitched = gc: to x_t near unity, else to the four taps of the line
//   (the line is [pitch line in ; x], so to pitch_buf or x), and to
//   p_rpos: f (p1 - p0) + (1 - f)(p3 - p2) + (s1 - s2) dsgn / half.
// A period's write rows are distinct, as its replay rows, and the two
// buffers differ, so a period's samples are independent; the periods are
// walked in order with a barrier between them, as in the forward. Around
// the launch, torch ops turn the per-sample cotangent of p_rpos into the
// ratio's (a reverse cumulative sum: p_rpos after sample t is the sum of
// the ratios up to t) and misc's.
//
// Design: three launches on the caller's stream.
// 1. echo_control (reverse_echo_control.cuh) again: the table and the
//    period bounds are recomputed (~0.6 ms at T = 16384, serial) rather
//    than kept from the forward (64 bytes a sample held across the whole
//    backward graph);
// 2. echo_audio_bwd, one CUDA block per group of up to 8 channels, 1024
//    threads along time and channel: the pitch line's final cotangent
//    first, then the periods in reverse. The taps' cotangents are added to
//    the line's by atomicAdd (a slot is read by many samples): two runs
//    may differ in the last bits;
// 3. channel_sum (channel_sum.cuh): the feedback's and the read
//    position's parts over the channels, in channel order.
//
// What bounds it on this card: bytes. At the fx bank's block (T = 16384,
// C = 128, cap 22050, plen 735) the gradient reads x, y, gy and the line in
// and writes gx: ~34 MB with the rings' cotangents, ~10 us at 3.35 TB/s;
// the recomputed control pass's serial chain is the floor of this design.

#include <cuda_runtime.h>

#include "channel_sum.cuh"
#include "reverse_echo_control.cuh"

namespace {

__device__ __forceinline__ long line_row(int t, int wslot, int i, int plen) {
  int d = wslot - i;
  if (d < 0) d += plen;
  const int src = t - d;
  return src >= 0 ? (long)plen + src : (long)i;
}

__global__ void __launch_bounds__(kAudioThreads) echo_audio_bwd(
    const float* __restrict__ x, const float* __restrict__ fb, const float* __restrict__ y,
    const float* __restrict__ gy, const Tab* __restrict__ tab, const int* __restrict__ bounds,
    const int* __restrict__ n_periods, float* lam_a, float* lam_b,
    const float* __restrict__ pb_in, const float* __restrict__ gpb_out, float* gline,
    float* __restrict__ gfb_part, float* __restrict__ gp_part, int T, int C, int plen,
    float inv_half) {
  const int c = blockIdx.x * kGroup + threadIdx.x;
  const bool live = c < C;
  const int lanes = blockDim.y;
  if (live) {  // the pitch line out: slot i holds one line row, a different one each
    const int wslot = tab[T - 1].rows.z;
    for (int i = threadIdx.y; i < plen; i += lanes)
      gline[line_row(T - 1, wslot, i, plen) * C + c] += gpb_out[(long)i * C + c];
  }
  __syncthreads();
  const int np = *n_periods;
  for (int k = np - 1; k >= 0; --k) {
    const int end = bounds[k + 1];
    for (int t = bounds[k] + threadIdx.y; t < end; t += lanes) {
      if (!live) continue;
      const Tab s = tab[t];
      const long row = (long)t * C + c;
      float* cur = (s.rows.w & kCurIsA) ? lam_a : lam_b;
      float* prev = (s.rows.w & kCurIsA) ? lam_b : lam_a;
      const long wrow = (long)s.rows.y * C + c;
      const float gc = cur[wrow];
      cur[wrow] = 0.0f;
      float gfb = 0.0f;
      if (s.rows.x >= 0) {
        const float gwet = __fmaf_rn(gc, fb[t], gy[row]);
        gfb = __fmul_rn(gc, y[row]);
        const long rrow = (long)s.rows.x * C + c;
        prev[rrow] = __fmaf_rn(gwet, s.mix.z, prev[rrow]);
      }
      gfb_part[row] = gfb;
      float gp = 0.0f;
      if (s.rows.w & kNearUnity) {
        atomicAdd(&gline[((long)plen + t) * C + c], gc);
      } else {
        const int ws = s.rows.z;
        const long r0 = line_row(t, ws, s.taps.x, plen) * C + c;
        const long r1 = line_row(t, ws, s.taps.y, plen) * C + c;
        const long r2 = line_row(t, ws, s.taps.z, plen) * C + c;
        const long r3 = line_row(t, ws, s.taps.w, plen) * C + c;
        const float p0 = line_at(x, pb_in, t, ws, s.taps.x, plen, C, c);
        const float p1 = line_at(x, pb_in, t, ws, s.taps.y, plen, C, c);
        const float p2 = line_at(x, pb_in, t, ws, s.taps.z, plen, C, c);
        const float p3 = line_at(x, pb_in, t, ws, s.taps.w, plen, C, c);
        const float gs1 = __fmul_rn(gc, s.mix.x), gs2 = __fmul_rn(gc, s.mix.y);
        atomicAdd(&gline[r0], __fmul_rn(gs1, s.wts.x));
        atomicAdd(&gline[r1], __fmul_rn(gs1, s.wts.y));
        atomicAdd(&gline[r2], __fmul_rn(gs2, s.wts.z));
        atomicAdd(&gline[r3], __fmul_rn(gs2, s.wts.w));
        const float s1 = __fadd_rn(__fmul_rn(s.wts.x, p0), __fmul_rn(s.wts.y, p1));
        const float s2 = __fadd_rn(__fmul_rn(s.wts.z, p2), __fmul_rn(s.wts.w, p3));
        const float gfrac = __fmul_rn(gs1, __fsub_rn(p1, p0));
        const float gfrac2 = __fmul_rn(gs2, __fsub_rn(p3, p2));
        const float gdist = __fmul_rn(__fmul_rn(gc, __fsub_rn(s1, s2)), inv_half);
        gp = __fadd_rn(__fadd_rn(gfrac, gfrac2), __fmul_rn(gdist, s.mix.w));
      }
      gp_part[row] = gp;
    }
    __syncthreads();  // this period's replay rows are the period before's writes
  }
}

}  // namespace

extern "C" {

// Enqueues the three launches on `stream`; returns the first cudaError_t
// (0 when all were accepted). Device pointers: x / y / gy (T, C) f32; blk,
// ratio, fb, alt (T,) f32; pb_in / gpb_out (plen, C) f32; misc_in (9,) f32;
// lam_a / lam_b (cap, C) f32: the cotangents of buf_a' and buf_b' in, of
// buf_a and buf_b out (updated in place); gline (plen + T, C) f32, zeroed
// by the caller: the cotangents of pitch_buf (rows 0 .. plen - 1) and x;
// gfb / gp (T,) f32 out: the feedback's cotangent and p_rpos's per sample;
// scratch: tab (T, 16) f32, bounds (T + 1,) i32, n_periods (1,) i32,
// misc_out (9,) f32, gfb_part / gp_part (T, C) f32. The geometry as the
// forward's.
int reverse_echo_scan_bwd_launch(const float* x, const float* blk, const float* ratio,
                                 const float* fb, const float* alt, const float* pb_in,
                                 const float* misc_in, const float* y, const float* gy,
                                 float* lam_a, float* lam_b, const float* gpb_out,
                                 float* gline, float* gfb, float* gp, float* tab, int* bounds,
                                 int* n_periods, float* misc_out, float* gfb_part,
                                 float* gp_part, int T, int C, float sr, int plen, int cap,
                                 int min_block, int max_block, float smooth_alpha,
                                 float inv_plen, float half, float inv_half,
                                 cudaStream_t stream) {
  if (T < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Geometry g{sr, smooth_alpha, inv_plen, (float)plen, half, inv_half,
                   plen, cap, min_block, max_block};
  Tab* table = reinterpret_cast<Tab*>(tab);
  echo_control<<<1, kCtlThreads, 0, stream>>>(blk, ratio, alt, misc_in, table, bounds,
                                              n_periods, misc_out, T, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = C < kGroup ? C : kGroup;
  const dim3 threads(width, kAudioThreads / width);
  echo_audio_bwd<<<(C + kGroup - 1) / kGroup, threads, 0, stream>>>(
      x, fb, y, gy, table, bounds, n_periods, lam_a, lam_b, pb_in, gpb_out, gline, gfb_part,
      gp_part, T, C, plen, inv_half);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_channel_sum(gfb_part, gfb, T, C, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_channel_sum(gp_part, gp, T, C, stream);
}

}  // extern "C"
