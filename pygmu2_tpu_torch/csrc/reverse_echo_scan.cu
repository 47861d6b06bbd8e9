// Reverse pitch echo, serial in time, for Hopper (sm_90a).
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
// What bounds it on this card: the dependent chain. At the main path's
// shapes (T = 16384, cap = 22050, plen = 735), replaying, it moves about
// 16 bytes per sample and channel (the input, the output, one block-buffer
// row read and one written) and the pitch line once (C = 128: 33.6 MB;
// roofline ~10 us at 3.35 TB/s) and does ~60 ops per sample. Each
// sample's read of the previous block depends on the previous sample's
// write (a swap replays the row written one sample earlier), so the
// global load (~250-300 cycles from L2), the pitch line's four
// shared-memory reads (~30 each, independent), the control machine's
// smoother and wrap arithmetic (~40), cosf (~40) and the write chain
// make ~400 cycles per sample: a
// serial floor of ~3 ms per 16384 samples at 1.98 GHz, whatever C.
// Measured (chip_smoke.py, H100 80GB HBM3, 700 W), replaying a previous
// block from the first sample as on the main path: 6.92 ms at C = 1 and
// 13.73 ms at C = 128; why C = 128 takes twice as long is not measured.
//
// What the design does about it: one thread per channel; every thread
// runs the control machine alike, in registers, and one writes it out.
// The pitch line (plen floats per channel, 2.9 KB at 44.1 kHz) lives in
// shared memory for up to 32 channels per CUDA block, loaded and stored
// once per call. The block buffers, 88 KB each per channel at 0.5 s and
// 1.7 MB at the default 10 s, stay in global memory laid out (cap, C), so
// each sample's row is one coalesced access, and the kernel updates them
// in place (the caller hands them over; the engine keeps only the
// result). The rounded block length, the floor of the read heads and
// the window use explicitly rounded float ops, rintf and cosf (the
// function the plain version's torch.cos calls on the card), so the
// kernel equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 200 * 1024;  // of the 227 KB a block may use
constexpr int kMaxThreads = 32;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);

struct Geometry {
  float sr, alpha, inv_plen, fplen, half, inv_half;
  int plen, cap, min_block, max_block;
};

// p - floor(p / plen) * plen, as the reference computes it
__device__ __forceinline__ float wrap(float p, const Geometry& g) {
  return __fsub_rn(p, __fmul_rn(floorf(__fmul_rn(p, g.inv_plen)), g.fplen));
}

__global__ void reverse_echo_scan(
    const float* __restrict__ x, const float* __restrict__ blk,
    const float* __restrict__ ratio, const float* __restrict__ fb,
    const float* __restrict__ alt, float* buf_a, float* buf_b,
    const float* __restrict__ pb_in, const float* __restrict__ misc_in,
    float* __restrict__ y, float* __restrict__ pb_out,
    float* __restrict__ misc_out, int T, int C, Geometry g) {
  extern __shared__ float pb[];  // pb[l * width + lane]: channel c0+lane, slot l
  const int c0 = blockIdx.x * blockDim.x;
  const int lane = threadIdx.x;
  const int c = c0 + lane;
  const int width = min((int)blockDim.x, C - c0);
  const bool live = lane < width;
  if (live)
    for (int l = 0; l < g.plen; ++l) pb[l * width + lane] = pb_in[(long)l * C + c];

  // float to int as the reference's astype: truncation
  int cur_is_a = (int)misc_in[0], p_wpos = (int)misc_in[1];
  float p_rpos = misc_in[2];
  int w_idx = (int)misc_in[3], r_idx = (int)misc_in[4];
  float smoothed = misc_in[5];
  int cur_block = (int)misc_in[6], prev_block = (int)misc_in[7],
      reverse = (int)misc_in[8];
  const float fmin_block = (float)g.min_block, fmax_block = (float)g.max_block;

  for (int t = 0; t < T; ++t) {
    // ---- the control machine (alike in every thread) ----
    float tt = __fmul_rn(blk[t], g.sr);
    if (tt != tt) tt = fmin_block;  // NaN
    const float target = rintf(fminf(fmaxf(tt, fmin_block), fmax_block));
    smoothed = __fadd_rn(smoothed, __fmul_rn(__fsub_rn(target, smoothed), g.alpha));
    if (w_idx == 0)
      cur_block = (int)fminf(fmaxf(rintf(smoothed), fmin_block), fmax_block);

    const int wslot = p_wpos;
    p_wpos = p_wpos + 1 == g.plen ? 0 : p_wpos + 1;
    const float pos = wrap(p_rpos, g);
    const int i0 = min(max((int)floorf(pos), 0), g.plen - 1);
    const int i1 = i0 + 1 == g.plen ? 0 : i0 + 1;
    const float frac = __fsub_rn(pos, (float)i0);
    const float pos2 = wrap(__fadd_rn(pos, g.half), g);
    const int i2 = min(max((int)floorf(pos2), 0), g.plen - 1);
    const int i3 = i2 + 1 == g.plen ? 0 : i2 + 1;
    const float frac2 = __fsub_rn(pos2, (float)i2);
    float dist = fabsf(__fsub_rn(p_rpos, (float)p_wpos));
    if (dist > g.half) dist = __fsub_rn(g.fplen, dist);
    const float f = __fmul_rn(dist, g.inv_half);
    const float rt = ratio[t];
    const bool near_unity = fabsf(__fsub_rn(rt, 1.0f)) < 1e-4f;
    p_rpos = wrap(__fadd_rn(p_rpos, rt), g);

    const int idx = reverse == 1 ? prev_block - 1 - r_idx : r_idx;
    const bool playing = prev_block > 0 && r_idx < prev_block && idx >= 0 &&
                         idx < prev_block;
    const float wpos =
        prev_block > 1 ? __fdiv_rn((float)r_idx, (float)max(prev_block - 1, 1)) : 0.0f;
    const float window = __fsub_rn(0.5f, __fmul_rn(0.5f, cosf(__fmul_rn(kTwoPi, wpos))));
    const long rrow = min(max(idx, 0), g.cap - 1);
    const long wrow = min(w_idx, g.cap - 1);  // the reference's clamped update
    float* cur_buf = cur_is_a == 1 ? buf_a : buf_b;
    const float* prev_buf = cur_is_a == 1 ? buf_b : buf_a;

    // ---- the audio of this thread's channel ----
    if (live) {
      const long row = (long)t * C + c;
      const float xi = x[row];
      pb[wslot * width + lane] = xi;
      const float s1 = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, frac), pb[i0 * width + lane]),
                                 __fmul_rn(frac, pb[i1 * width + lane]));
      const float s2 = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, frac2), pb[i2 * width + lane]),
                                 __fmul_rn(frac2, pb[i3 * width + lane]));
      const float pitched =
          near_unity ? xi : __fadd_rn(__fmul_rn(f, s1), __fmul_rn(__fsub_rn(1.0f, f), s2));
      const float wet = playing ? __fmul_rn(prev_buf[rrow * C + c], window) : 0.0f;
      y[row] = wet;
      cur_buf[wrow * C + c] = __fadd_rn(pitched, __fmul_rn(wet, fb[t]));
    }

    // ---- advance; swap buffers when the block completes ----
    ++w_idx;
    ++r_idx;
    if (w_idx >= cur_block) {
      cur_is_a = 1 - cur_is_a;
      prev_block = cur_block;
      reverse = alt[t] >= 0.5f ? 1 - reverse : 1;
      w_idx = 0;
      r_idx = 0;
    }
  }

  if (live)
    for (int l = 0; l < g.plen; ++l) pb_out[(long)l * C + c] = pb[l * width + lane];
  if (blockIdx.x == 0 && lane == 0) {
    misc_out[0] = (float)cur_is_a;
    misc_out[1] = (float)p_wpos;
    misc_out[2] = p_rpos;
    misc_out[3] = (float)w_idx;
    misc_out[4] = (float)r_idx;
    misc_out[5] = smoothed;
    misc_out[6] = (float)cur_block;
    misc_out[7] = (float)prev_block;
    misc_out[8] = (float)reverse;
  }
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: x / y (T, C) f32; blk, ratio, fb, alt (T,)
// f32; buf_a, buf_b (cap, C) f32, updated in place; pb_in / pb_out
// (plen, C) f32; misc_in / misc_out (9,) f32 in the reference's
// MISC_FIELDS order. inv_plen, half and inv_half are float32(1 / plen),
// plen / 2 and float32(1 / half), as the reference rounds them.
int reverse_echo_scan_launch(const float* x, const float* blk,
                             const float* ratio, const float* fb,
                             const float* alt, float* buf_a, float* buf_b,
                             const float* pb_in, const float* misc_in,
                             float* y, float* pb_out, float* misc_out, int T,
                             int C, float sr, int plen, int cap, int min_block,
                             int max_block, float smooth_alpha, float inv_plen,
                             float half, float inv_half, cudaStream_t stream) {
  const long ring_bytes = (long)plen * sizeof(float);
  const int per_block = (int)(kMaxSharedBytes / ring_bytes);
  if (per_block < 1) return (int)cudaErrorInvalidValue;
  int block = per_block < kMaxThreads ? per_block : kMaxThreads;
  if (block > C) block = C;
  const size_t smem = (size_t)(ring_bytes * block);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reverse_echo_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Geometry g{sr, smooth_alpha, inv_plen, (float)plen, half, inv_half,
                   plen, cap, min_block, max_block};
  reverse_echo_scan<<<(C + block - 1) / block, block, smem, stream>>>(
      x, blk, ratio, fb, alt, buf_a, buf_b, pb_in, misc_in, y, pb_out,
      misc_out, T, C, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
