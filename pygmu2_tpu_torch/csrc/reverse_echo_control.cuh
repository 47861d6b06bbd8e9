// The reverse echo's control pass (csrc/reverse_echo_scan.cu) and what its
// two audio passes share: the forward's (reverse_echo_scan.cu) and the
// backward's (reverse_echo_scan_bwd.cu), which reads the table, the period
// bounds and their count that the forward's control pass wrote (kept as
// residuals of the forward launch) and runs no control pass of its own.
//
// echo_control, one CUDA block: thread 0 runs only the serial scalars (the
// smoothed block length and the read position), the other warps stage the
// controls ahead of it and derive each sample's table row (see
// reverse_echo_scan.cu). A row also holds, unused by the forward, the sign
// of the crossfade's slope in the read position (mix.w): the backward's
// ratio gradient.
#pragma once

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
  float4 mix;    // f, 1 - f, window, d dist / d p_rpos (the backward's)
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
  const float dd = __fsub_rn(c.p_rpos, (float)p_wpos);
  float dist = fabsf(dd);
  float sgn = dd >= 0.0f ? 1.0f : -1.0f;  // d|dd| / d p_rpos, 1 at 0 (as jax.vjp of abs)
  if (dist > g.half) {
    dist = __fsub_rn(g.fplen, dist);
    sgn = -sgn;
  }
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
  tab.mix = make_float4(f, __fsub_rn(1.0f, f), window, sgn);
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

}  // namespace
