// Feedback comb over a ring buffer, serial in time, for Hopper (sm_90a).
//
// Replaces the TPU kernel pygmu2_tpu/ops/comb_pallas.py:comb_scan_pallas
// (:125), which keeps the (L, 128) ring buffer in VMEM scratch and walks a
// sequential grid of time chunks.
//
// What it computes (the op order of comb_scan_ref, float32), per sample t:
//   sf    = sf < 0 ? f[t] : sf + (f[t] - sf) * alpha    one-pole smoothing
//   delay = clip(rint(sr / max(sf, 1)), 1, L - 1)        half to even
//   y     = x[t, c] + fb[t] * buf[(pos - delay + L) % L, c]
//   buf[pos, c] = y; pos = (pos + 1) % L
// `pos` and `sf` are shared by all channels: every thread computes them
// identically, and one thread writes them out.
//
// What bounds it on this card: the dependent chain, not bytes or
// operations. At the main path's block (T = 16384, C = 128, L = 2206) it
// moves 19 MB (roofline 5.7 us at 3.35 TB/s) and does 13 ops per sample
// plus 2 per sample and channel. Every sample's read may hit the value
// written one sample earlier (delay >= 1), and one warp issues each
// sample's chain in order: smoother (~12 cycles), IEEE division (~40),
// rounding and clipping (~16), integer modulo (~25), a shared-memory read
// (~30), the multiply-add and the write: ~150-200 cycles, a serial floor
// of ~1.2-1.7 ms per 16384 samples at 1.98 GHz. Measured on an H100 SXM
// (700 W): 3.4 ms at C = 1, 5.4-5.6 ms at C = 128.
//
// What the design does about it: one thread per channel. The ring lives in
// shared memory when it fits (L floats per channel; L = 2206 is 8.8 KB, so
// up to 23 channels share a CUDA block's ~200 KB), loaded from and stored
// back to global memory once per call; past that it stays in global
// memory (L2-resident). The smoother uses explicitly rounded float ops and
// rintf, so the integer delay equals the plain PyTorch version's.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 200 * 1024;  // of the 227 KB a block may use
constexpr int kGlobalThreads = 128;

__global__ void comb_scan(const float* __restrict__ x,
                          const float* __restrict__ freq,
                          const float* __restrict__ fb,
                          const float* __restrict__ buf_in,
                          const int* __restrict__ pos_in,
                          const float* __restrict__ sf_in,
                          float* __restrict__ y, float* __restrict__ buf_out,
                          int* __restrict__ pos_out, float* __restrict__ sf_out,
                          int T, int C, int L, float sr, float alpha,
                          bool ring_in_shared) {
  extern __shared__ float shared_ring[];
  const int c0 = blockIdx.x * blockDim.x;
  const int lane = threadIdx.x;
  const int c = c0 + lane;
  const int width = min((int)blockDim.x, C - c0);  // channels of this block
  const bool live = lane < width;

  // ring[l * ld + lane] is channel c's slot l
  float* ring = ring_in_shared ? shared_ring : buf_out + c0;
  const int ld = ring_in_shared ? width : C;
  if (live)
    for (int l = 0; l < L; ++l) ring[l * ld + lane] = buf_in[(long)l * C + c];

  int pos = *pos_in;
  float sf = *sf_in;
  for (int t = 0; t < T; ++t) {
    const float fi = freq[t];
    sf = sf < 0.0f ? fi : __fadd_rn(sf, __fmul_rn(__fsub_rn(fi, sf), alpha));
    int delay = (int)rintf(__fdiv_rn(sr, fmaxf(sf, 1.0f)));
    delay = min(max(delay, 1), L - 1);
    const int read = (pos - delay + L) % L;  // both terms in [1, 2L-1]
    if (live) {
      const long row = (long)t * C;
      const float out = __fadd_rn(x[row + c], __fmul_rn(fb[t], ring[read * ld + lane]));
      y[row + c] = out;
      ring[pos * ld + lane] = out;
    }
    pos = pos + 1 == L ? 0 : pos + 1;
  }
  if (ring_in_shared && live)
    for (int l = 0; l < L; ++l) buf_out[(long)l * C + c] = ring[l * ld + lane];
  if (blockIdx.x == 0 && lane == 0) {
    *pos_out = pos;
    *sf_out = sf;
  }
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: x / y (T, C) f32, freq / fb (T,) f32,
// buf_in / buf_out (L, C) f32, pos_in / pos_out () i32, sf_in / sf_out ()
// f32. Needs L >= 2.
int comb_scan_launch(const float* x, const float* freq, const float* fb,
                     const float* buf_in, const int* pos_in,
                     const float* sf_in, float* y, float* buf_out, int* pos_out,
                     float* sf_out, int T, int C, int L, float sr,
                     float smooth_alpha, cudaStream_t stream) {
  const long ring_bytes = (long)L * sizeof(float);
  const int per_block = (int)(kMaxSharedBytes / ring_bytes);
  const bool shared = per_block >= 1;
  int block = shared ? (per_block < 32 ? per_block : 32) : kGlobalThreads;
  if (block > C) block = C;
  const size_t smem = shared ? (size_t)(ring_bytes * block) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        comb_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  comb_scan<<<(C + block - 1) / block, block, smem, stream>>>(
      x, freq, fb, buf_in, pos_in, sf_in, y, buf_out, pos_out, sf_out, T, C,
      L, sr, smooth_alpha, shared);
  return (int)cudaGetLastError();
}

}  // extern "C"
