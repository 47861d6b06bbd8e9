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
// 1. echo_control, one CUDA block: thread 0 runs only the serial scalars.
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

namespace {

constexpr int kChunk = 512;         // samples per staged chunk of the control pass
constexpr int kCtlThreads = 256;    // warp 0: the serial thread; warps 1-7 stage and derive
constexpr int kAudioThreads = 1024;
constexpr int kGroup = 8;           // channels per CUDA block of the audio pass
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);

struct Geometry {
  float sr, alpha, inv_plen, fplen, half, inv_half;
  int plen, cap, min_block, max_block;
};

// the serial pass's record of one sample, before the sample's update: the
// read position, and (w_idx, r_idx, prev_block, reverse | cur_is_a << 1)
struct Ctl {
  float p_rpos;
  int4 v;
};

// what the audio pass reads per sample
struct Tab {
  int4 taps;     // i0, i1, i2, i3
  float4 wts;    // 1 - frac, frac, 1 - frac2, frac2
  float4 mix;    // f, 1 - f, window, (unused)
  int4 rows;     // replay row (-1: not playing), write row, write slot, flags
};
constexpr int kNearUnity = 1, kCurIsA = 2;

// p - floor(p / plen) * plen, as the reference computes it
__device__ __forceinline__ float wrap(float p, const Geometry& g) {
  return __fsub_rn(p, __fmul_rn(floorf(__fmul_rn(p, g.inv_plen)), g.fplen));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// the smoother's target: the block length in samples, rounded half to even
__device__ __forceinline__ float block_target(float blk, const Geometry& g) {
  float tt = __fmul_rn(blk, g.sr);
  if (tt != tt) tt = (float)g.min_block;  // NaN
  return rintf(fminf(fmaxf(tt, (float)g.min_block), (float)g.max_block));
}

__device__ Tab derive(const Ctl& c, int t, int p_wpos0, float rt, const Geometry& g) {
  const int wslot = (p_wpos0 + t) % g.plen;
  const int p_wpos = wslot + 1 == g.plen ? 0 : wslot + 1;
  const float pos = wrap(c.p_rpos, g);
  const int i0 = min(max((int)floorf(pos), 0), g.plen - 1);
  const int i1 = i0 + 1 == g.plen ? 0 : i0 + 1;
  const float frac = __fsub_rn(pos, (float)i0);
  const float pos2 = wrap(__fadd_rn(pos, g.half), g);
  const int i2 = min(max((int)floorf(pos2), 0), g.plen - 1);
  const int i3 = i2 + 1 == g.plen ? 0 : i2 + 1;
  const float frac2 = __fsub_rn(pos2, (float)i2);
  float dist = fabsf(__fsub_rn(c.p_rpos, (float)p_wpos));
  if (dist > g.half) dist = __fsub_rn(g.fplen, dist);
  const float f = __fmul_rn(dist, g.inv_half);
  const bool near_unity = fabsf(__fsub_rn(rt, 1.0f)) < 1e-4f;

  const int w_idx = c.v.x, r_idx = c.v.y, prev_block = c.v.z, flags = c.v.w;
  const int reverse = flags & 1;
  const int idx = reverse == 1 ? prev_block - 1 - r_idx : r_idx;
  const bool playing = prev_block > 0 && r_idx < prev_block && idx >= 0 && idx < prev_block;
  const float wpos =
      prev_block > 1 ? __fdiv_rn((float)r_idx, (float)max(prev_block - 1, 1)) : 0.0f;
  const float window = __fsub_rn(0.5f, __fmul_rn(0.5f, cosf(__fmul_rn(kTwoPi, wpos))));
  Tab tab;
  tab.taps = make_int4(i0, i1, i2, i3);
  tab.wts = make_float4(__fsub_rn(1.0f, frac), frac, __fsub_rn(1.0f, frac2), frac2);
  tab.mix = make_float4(f, __fsub_rn(1.0f, f), window, 0.0f);
  tab.rows = make_int4(playing ? min(max(idx, 0), g.cap - 1) : -1,
                       min(w_idx, g.cap - 1),  // the reference's clamped update
                       wslot,
                       (near_unity ? kNearUnity : 0) | ((flags & 2) ? kCurIsA : 0));
  return tab;
}

__global__ void __launch_bounds__(kCtlThreads) echo_control(
    const float* __restrict__ blk, const float* __restrict__ ratio,
    const float* __restrict__ alt, const float* __restrict__ misc_in,
    Tab* __restrict__ tab, int* __restrict__ bounds, int* __restrict__ n_periods,
    float* __restrict__ misc_out, int T, Geometry g) {
  __shared__ float s_target[2][kChunk], s_ratio[2][kChunk], s_alt[2][kChunk];
  __shared__ Ctl s_ctl[2][kChunk];
  const int tid = threadIdx.x;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int p_wpos0 = (int)misc_in[1];

  auto stage = [&](int j) {  // warps 1-7: chunk j's inputs into buffer j & 1
    const int base = j * kChunk, n = min(kChunk, T - base), b = j & 1;
    for (int i = tid - 32; i < n; i += kCtlThreads - 32) {
      cp_async4(&s_ratio[b][i], ratio + base + i);
      cp_async4(&s_alt[b][i], alt + base + i);
      s_target[b][i] = block_target(blk[base + i], g);
    }
    cp_async_commit();
  };
  auto post = [&](int j) {  // warps 1-7: chunk j's records into the table
    const int base = j * kChunk, n = min(kChunk, T - base), b = j & 1;
    for (int i = tid - 32; i < n; i += kCtlThreads - 32)
      tab[base + i] = derive(s_ctl[b][i], base + i, p_wpos0, ratio[base + i], g);
  };

  if (tid >= 32) {
    stage(0);
    cp_async_wait_all();
  }
  __syncthreads();

  // the serial state, in thread 0's registers; float to int as the
  // reference's astype: truncation
  int cur_is_a = (int)misc_in[0];
  float p_rpos = misc_in[2];
  int w_idx = (int)misc_in[3], r_idx = (int)misc_in[4];
  float smoothed = misc_in[5];
  int cur_block = (int)misc_in[6], prev_block = (int)misc_in[7], reverse = (int)misc_in[8];
  int nb = 0;

  for (int j = 0; j <= n_chunks; ++j) {
    if (tid == 0 && j < n_chunks) {
      const int base = j * kChunk, n = min(kChunk, T - base), b = j & 1;
      // one sample of the two serial chains (the smoother and the read
      // position), recorded with the period counters it saw
      auto step = [&](int i, int w, int r, int flags) {
        smoothed = __fadd_rn(smoothed, __fmul_rn(__fsub_rn(s_target[b][i], smoothed), g.alpha));
        s_ctl[b][i] = Ctl{p_rpos, make_int4(w, r, prev_block, flags)};
        p_rpos = wrap(__fadd_rn(p_rpos, s_ratio[b][i]), g);
      };
      int i = 0;
      while (i < n) {
        const int flags = reverse | (cur_is_a << 1);
        if (w_idx == 0) {  // a period's first smoothed value sets its length
          step(i, w_idx, r_idx, flags);
          cur_block = (int)fminf(fmaxf(rintf(smoothed), (float)g.min_block),
                                 (float)g.max_block);
          ++w_idx;
          ++r_idx;
          ++i;
        } else {  // the rest of the period (or of the chunk): no branch per sample
          const int run = min(n - i, max(cur_block - w_idx, 1));
#pragma unroll 4
          for (int k = 0; k < run; ++k) step(i + k, w_idx + k, r_idx + k, flags);
          w_idx += run;
          r_idx += run;
          i += run;
        }
        if (w_idx >= cur_block) {  // swap: the next sample starts a period
          cur_is_a = 1 - cur_is_a;
          prev_block = cur_block;
          reverse = s_alt[b][i - 1] >= 0.5f ? 1 - reverse : 1;
          w_idx = 0;
          r_idx = 0;
          if (base + i < T) bounds[++nb] = base + i;
        }
      }
    } else if (tid >= 32) {
      if (j + 1 < n_chunks) stage(j + 1);
      if (j >= 1) post(j - 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  if (tid == 0) {
    bounds[0] = 0;
    bounds[nb + 1] = T;
    *n_periods = nb + 1;
    misc_out[0] = (float)cur_is_a;
    misc_out[1] = (float)((p_wpos0 + T) % g.plen);
    misc_out[2] = p_rpos;
    misc_out[3] = (float)w_idx;
    misc_out[4] = (float)r_idx;
    misc_out[5] = smoothed;
    misc_out[6] = (float)cur_block;
    misc_out[7] = (float)prev_block;
    misc_out[8] = (float)reverse;
  }
}

// the pitch line's slot i at time t (write slot wslot): the input i's
// distance behind the write head, or the line handed in before the call
__device__ __forceinline__ float line_at(const float* __restrict__ x,
                                         const float* __restrict__ pb_in, int t,
                                         int wslot, int i, int plen, int C, int c) {
  int d = wslot - i;
  if (d < 0) d += plen;
  const int src = t - d;
  return src >= 0 ? x[(long)src * C + c] : pb_in[(long)i * C + c];
}

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
