// Reverse pitch echo for Hopper (sm_90a): a serial control pass shared by
// the channels, then an audio pass parallel within each block period.
//
// Replaces the TPU kernel pygmu2_tpu/ops/reverse_echo_pallas.py:
// reverse_echo_scan_pallas (:338), which keeps all three rings of 128
// lanes in VMEM scratch (so the block buffers' capacity was capped at
// about 9500 rows) and walks a sequential grid of time chunks.
//
// What it computes (the op order of reverse_echo_scan_ref, float32), per
// sample t: a control machine shared by all channels (the smoothed block
// length, rounded half to even; the pitch line's write position and
// fractional read position; the block buffers' write and read indices;
// which buffer is current, the previous block's length and the
// direction), and per channel
//   pb[p_wpos] = x;  pitched = two read heads 180 degrees apart, linearly
//     interpolated, crossfaded by their distance from the write head
//     (x itself at a ratio within 1e-4 of 1)
//   wet = the previous block read backwards (or forwards) under a Hann
//     window 0.5 - 0.5 cos(2 pi r / (prev - 1)), 0 when not playing
//   current block[w_idx] = pitched + wet * fb;  y[t] = wet
// and the buffers swap when the current block is full.
//
// What bounds it on this card: the control machine's dependent chain. At
// the main path's shapes (T = 16384, cap = 22050, plen = 735), replaying,
// the call moves about 16 bytes per sample and channel (the input, the
// output, one block-buffer row read and one written) and the pitch line
// once (C = 128: 33.6 MB; roofline ~10 us at 3.35 TB/s). The per-channel
// audio is not serial: the write head fills one buffer while the read
// head replays the other, which is complete, so a sample's wet output
// depends only on the previous period's block; and the pitch line holds
// only input samples, so slot i at time t holds x[t - ((wslot_t - i) mod
// plen)] (or the line handed in, before the call). Only the scalars are
// serial, and the longest chain is the read position, p_rpos =
// wrap(p_rpos + ratio) (add, mul, floor, mul, sub), beside the 3-op
// block-length smoother: estimated ~25 cycles a sample, a serial floor of
// ~0.2 ms per 16384 samples at 1.98 GHz, whatever C.
//
// What the design does about it: two launches on the caller's stream.
// 1. echo_control (reverse_echo_control.cuh; its table, bounds and count
//    are the backward's residuals when the launch is recorded for one),
//    one CUDA block: thread 0 runs only the serial scalars.
//    Within a period the block length is fixed, so it walks each period
//    (or the rest of a chunk) as a run of samples with no branch but the
//    loop's, and records per sample the read position and the period
//    counters in a shared-memory ring; it writes the period boundaries to
//    global memory. The block's other warps stage ratio and alt into
//    shared memory ahead of it with cp.async, and the smoother's rounded
//    target from blk, in double-buffered chunks of 512 samples (the serial
//    thread never waits on a global load), and derive in parallel, one
//    chunk behind, everything else the audio needs per sample: the pitch
//    line's write slot, taps and weights, the crossfade, the pass-through
//    flag, the Hann window (cosf) and the replay and write rows.
// 2. echo_audio, one CUDA block per group of up to 8 channels (a bank of
//    128 on 16 SMs), 1024 threads along time and channel: for each period
//    in order, every (t, c) of the period gathers its pitch-line taps
//    from [pitch line ; x], reads the previous block's row, and writes y
//    and the current block's row; a __syncthreads() between periods makes
//    a period's writes visible to the next period's reads (the dependency
//    is per channel, so no grid-wide barrier is needed). The block buffers
//    stay in global memory laid out (cap, C), updated in place, so a
//    warp's row access is coalesced; the pitch line's final state is
//    gathered the same way.
// Per-sample arithmetic is that of the plain version, in explicitly
// rounded float ops, rintf and cosf (the function the plain version's
// torch.cos calls on the card); only the order in which independent
// samples are computed changes, so the kernel equals the plain PyTorch
// version bit for bit (the window within 1e-6).
//
// Measured (chip_smoke.py's timed case, replaying a 0.3 s block from the
// first sample; H100 80GB HBM3, 700 W): 0.6715 ms at C = 1 and 0.8073 ms
// at C = 128, of which the control pass takes ~0.63 ms (~70 cycles a
// sample, not the ~25 estimated) and the audio pass 0.025 ms (C = 1) and
// 0.163 ms (C = 128). The first design, one thread per channel walking
// every sample with each sample waiting on a global load of the replayed
// row, took 6.90 ms and 13.67 ms.

#include <cuda_runtime.h>

#include "reverse_echo_control.cuh"

namespace {

__global__ void __launch_bounds__(kAudioThreads) echo_audio(
    const float* __restrict__ x, const float* __restrict__ fb,
    const Tab* __restrict__ tab, const int* __restrict__ bounds,
    const int* __restrict__ n_periods, float* buf_a, float* buf_b,
    const float* __restrict__ pb_in, float* __restrict__ y,
    float* __restrict__ pb_out, int T, int C, int plen) {
  const int c = blockIdx.x * kGroup + threadIdx.x;
  const bool live = c < C;
  const int lanes = blockDim.y;
  const int np = *n_periods;
  for (int k = 0; k < np; ++k) {
    const int end = bounds[k + 1];
    for (int t = bounds[k] + threadIdx.y; t < end; t += lanes) {
      if (!live) continue;
      const Tab s = tab[t];
      const long row = (long)t * C + c;
      const float xi = x[row];
      float pitched = xi;
      if (!(s.rows.w & kNearUnity)) {
        const int ws = s.rows.z;
        const float p0 = line_at(x, pb_in, t, ws, s.taps.x, plen, C, c);
        const float p1 = line_at(x, pb_in, t, ws, s.taps.y, plen, C, c);
        const float p2 = line_at(x, pb_in, t, ws, s.taps.z, plen, C, c);
        const float p3 = line_at(x, pb_in, t, ws, s.taps.w, plen, C, c);
        const float s1 = __fadd_rn(__fmul_rn(s.wts.x, p0), __fmul_rn(s.wts.y, p1));
        const float s2 = __fadd_rn(__fmul_rn(s.wts.z, p2), __fmul_rn(s.wts.w, p3));
        pitched = __fadd_rn(__fmul_rn(s.mix.x, s1), __fmul_rn(s.mix.y, s2));
      }
      float* cur = (s.rows.w & kCurIsA) ? buf_a : buf_b;
      const float* prev = (s.rows.w & kCurIsA) ? buf_b : buf_a;
      const long wrow = (long)s.rows.y * C + c;
      if (s.rows.x >= 0) {
        const float wet = __fmul_rn(prev[(long)s.rows.x * C + c], s.mix.z);
        y[row] = wet;
        cur[wrow] = __fadd_rn(pitched, __fmul_rn(wet, fb[t]));
      } else {
        y[row] = 0.0f;
        cur[wrow] = pitched;
      }
    }
    __syncthreads();  // this period's rows are the next period's replay
  }
  if (live) {
    const int wslot = tab[T - 1].rows.z;
    for (int i = threadIdx.y; i < plen; i += lanes)
      pb_out[(long)i * C + c] = line_at(x, pb_in, T - 1, wslot, i, plen, C, c);
  }
}

}  // namespace

extern "C" {

// Enqueues the two launches on `stream`; returns the first cudaError_t
// (0 when both were accepted). Device pointers: x / y (T, C) f32; blk,
// ratio, fb, alt (T,) f32; buf_a, buf_b (cap, C) f32, updated in place;
// pb_in / pb_out (plen, C) f32; misc_in / misc_out (9,) f32 in the
// reference's MISC_FIELDS order; scratch: tab (T, 16) f32, bounds (T + 1,)
// i32, n_periods (1,) i32. inv_plen, half and inv_half are float32(1 /
// plen), plen / 2 and float32(1 / half), as the reference rounds them.
// Requires max_block <= cap - 1 (a period's write rows are distinct).
int reverse_echo_scan_launch(const float* x, const float* blk,
                             const float* ratio, const float* fb,
                             const float* alt, float* buf_a, float* buf_b,
                             const float* pb_in, const float* misc_in,
                             float* y, float* pb_out, float* misc_out,
                             float* tab, int* bounds, int* n_periods, int T,
                             int C, float sr, int plen, int cap, int min_block,
                             int max_block, float smooth_alpha, float inv_plen,
                             float half, float inv_half, cudaStream_t stream) {
  const Geometry g{sr, smooth_alpha, inv_plen, (float)plen, half, inv_half,
                   plen, cap, min_block, max_block};
  Tab* table = reinterpret_cast<Tab*>(tab);
  echo_control<<<1, kCtlThreads, 0, stream>>>(blk, ratio, alt, misc_in, table, bounds,
                                              n_periods, misc_out, T, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = C < kGroup ? C : kGroup;
  const dim3 threads(width, kAudioThreads / width);
  echo_audio<<<(C + kGroup - 1) / kGroup, threads, 0, stream>>>(
      x, fb, table, bounds, n_periods, buf_a, buf_b, pb_in, y, pb_out, T, C, plen);
  return (int)cudaGetLastError();
}

}  // extern "C"
