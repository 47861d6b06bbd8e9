// The adjoint of a first-order recurrence spread over the card, for Hopper
// (sm_90a): the backward of the envelope follower (envelope_ar_scan_bwd.cu),
// of the slew limiter (slew_scan_bwd.cu) and of the comb's smoother
// (comb_scan_bwd.cu).
//
// The forward is y_t = y_{t-1} + k_t * (x_t - y_{t-1}) per channel, k_t
// chosen per sample by a compare of x_t against y_{t-1} (Op::k(x_t,
// y_{t-1})). The compares carry no gradient, so the backward is linear:
// with m_t = 1 - k_t (rounded) and the cotangent lambda_t of y_t,
//   lambda_t = g_t + m_{t+1} * lambda_{t+1},
//   lambda_{T-1} = g_{T-1} + g_final (the cotangent of the state out),
//   gx_t = k_t * lambda_t,   g_state_in = m_0 * lambda_0.
// A segment of samples walked backward from a carry `in` entering at its
// right is the affine map in -> a * in + b of the carry it hands on (a the
// product of its m, b its walk from zero); two adjacent segments compose as
// (a_l a_r, fma(a_l, b_r, b_l)). A null x is not read (Op::k is given 0:
// the comb's smoother chooses by y_{t-1} alone); a null g is all zeros (the
// smoother's only cotangent is the state out's).
//
// What bounds it on this card: bytes (x, y and g read, gx written: 33.6 MB
// at T = 16384, C = 128, 10 us at 3.35 TB/s) and, at one channel (196 KB,
// 0.06 us), the latency of its dependent steps.
//
// Design: one launch over a grid of (256-sample chunks) x (tiles of W
// channels), W = C rounded up to a power of two, at most 32 (a call of
// 16384 samples is 64 CUDA blocks at C = 1, 256 at C = 128). A block of 256
// threads:
// 1. takes a ticket (the chunks in reverse time order, tile by tile), stages
//    its chunk's rows of x, y and g in shared memory by cp.async (16 bytes a
//    copy where the rows allow it, as staged_ring.cuh's users stage theirs),
//    all arriving on one mbarrier;
// 2. gives each thread one channel and a segment of W samples (lane = s W +
//    c: a warp holds 32 / W segments of each of its W channels, the block
//    kWarps times that) and walks it from a zero carry: its map (a, b);
// 3. composes the maps of a channel's segments in a warp by a suffix scan
//    of warp shuffles (log2(32 / W) steps, none at W = 32), then the warps'
//    totals in shared memory from the last warp to the first: the chunk's
//    map, published with a flag for the chunks before it in time;
// 4. walks the carry entering the chunk: g_final through the maps of every
//    chunk after it, from the last, in that fixed order (the maps staged in
//    shared memory by all the threads, one channel's walk a thread);
// 5. hands the carry to each warp (the warps' totals, from the last), to
//    each segment (its right neighbour's suffix map), walks each segment
//    again writing gx into the staged x rows, and stores the rows (16 bytes
//    a store where they allow it).
// No atomics but the ticket: two calls give the same bits. The order in
// torch ops: ops/envelope.order1_adjoint_grid.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "staged_ring.cuh"

namespace order1_grid {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;        // samples a chunk, at every width
constexpr int kWalk = 4 * kThreads;  // chunk maps staged at once for the carry's walk

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// How a chunk's rows move between a (T, C) plane and a stage of rows of W
// floats: kFlat4, the tile is every channel (W == C), one run of n * C
// floats, 16 bytes a copy; kRows4, rows of `width` floats C apart, 16
// bytes a copy (C % 4 == 0, W % 4 == 0); kRows, 4 bytes a copy.
enum Layout { kFlat4, kRows4, kRows };

template <int W>
__device__ __forceinline__ void stage_in(float* dst, const float* src, Layout layout, int n,
                                         int C, int width, int tid) {
  if (layout == kFlat4) {
    const int m = n * C, m4 = m & ~3;
    for (int f = 4 * tid; f < m4; f += 4 * kThreads) cp_async16(dst + f, src + f);
    for (int f = m4 + tid; f < m; f += kThreads) cp_async4(dst + f, src + f);
  } else if (layout == kRows4) {
    const int per = width / 4;
    for (int q = tid; q < n * per; q += kThreads) {
      const int row = q / per, col = (q - row * per) * 4;
      cp_async16(dst + row * W + col, src + (long)row * C + col);
    }
  } else {
    for (int q = tid; q < n * width; q += kThreads) {
      const int row = q / width, col = q - row * width;
      cp_async4(dst + row * W + col, src + (long)row * C + col);
    }
  }
}

template <int W>
__device__ __forceinline__ void stage_out(float* dst, const float* src, Layout layout, int n,
                                          int C, int width, int tid) {
  if (layout == kFlat4) {
    const int m = n * C, m4 = m & ~3;
    for (int f = 4 * tid; f < m4; f += 4 * kThreads)
      *reinterpret_cast<float4*>(dst + f) = *reinterpret_cast<const float4*>(src + f);
    for (int f = m4 + tid; f < m; f += kThreads) dst[f] = src[f];
  } else if (layout == kRows4) {
    const int per = width / 4;
    for (int q = tid; q < n * per; q += kThreads) {
      const int row = q / per, col = (q - row * per) * 4;
      *reinterpret_cast<float4*>(dst + (long)row * C + col) =
          *reinterpret_cast<const float4*>(src + row * W + col);
    }
  } else {
    for (int q = tid; q < n * width; q += kThreads) {
      const int row = q / width, col = q - row * width;
      dst[(long)row * C + col] = src[row * W + col];
    }
  }
}

// flags[0] is the ticket counter, flags[1 + q * tiles + tile] is set once
// the map of the q-th chunk from the end (in time) of a tile is in agg
// ((2, L, C): a, then b); all zeroed before the launch.
template <int W, class Op>
__global__ void __launch_bounds__(kThreads, 2)
    grid_adjoint(const Op op, const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ y0, const float* __restrict__ g,
                 const float* __restrict__ g_final, float* __restrict__ gx,
                 float* __restrict__ g_state_in, float* __restrict__ agg,
                 int* __restrict__ flags, int T, int C, int L, Layout layout) {
  constexpr int G = 32 / W;  // segments of a channel in a warp
  constexpr int kSeg = W;    // samples a segment: kChunk / (kThreads / W)
  extern __shared__ __align__(16) float stage[];  // x (then gx), y, g: kChunk x W each
  float* sx = stage;
  float* sy = stage + kChunk * W;
  float* sg = sy + kChunk * W;
  __shared__ float wa[kWarps][W], wb[kWarps][W], win[kWarps][W];
  __shared__ float walk_a[kWalk], walk_b[kWalk];
  __shared__ uint64_t full;
  __shared__ int ticket;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (C + W - 1) / W;
  if (tid == 0) {
    ticket = atomicAdd(flags, 1);  // the last chunk in time first
    mbar_init(&full, kThreads);
  }
  __syncthreads();
  const int tile = ticket % tiles, q = ticket / tiles;
  const int t0 = (L - 1 - q) * kChunk, n = min(kChunk, T - t0);
  const int c0 = tile * W, width = min(W, C - c0);

  // 1. the chunk's rows
  const long off = (long)t0 * C + c0;
  if (x != nullptr) stage_in<W>(sx, x + off, layout, n, C, width, tid);
  stage_in<W>(sy, y + off, layout, n, C, width, tid);
  if (g != nullptr) stage_in<W>(sg, g + off, layout, n, C, width, tid);
  cp_async_arrive(&full);
  mbar_wait(&full, 0);

  // 2. this thread's segment, from a zero carry (outside the call or the
  // tile: k = 0, g = 0, the identity)
  const int s = lane / W, c = lane - s * W;
  const int r0 = (warp * G + s) * kSeg;
  const bool live = c < width;
  float k[kSeg], gv[kSeg];
#pragma unroll
  for (int i = 0; i < kSeg; ++i) {
    const int r = r0 + i;
    k[i] = 0.0f, gv[i] = 0.0f;
    if (live && r < n) {
      const float prev = r > 0    ? sy[(r - 1) * W + c]
                         : t0 > 0 ? y[off - C + c]
                                  : y0[c0 + c];
      k[i] = op.k(x != nullptr ? sx[r * W + c] : 0.0f, prev);
      gv[i] = g != nullptr ? sg[r * W + c] : 0.0f;
    }
  }
  float a = 1.0f, b = 0.0f;
#pragma unroll
  for (int i = kSeg - 1; i >= 0; --i) {
    const float m = __fsub_rn(1.0f, k[i]);
    b = __fmul_rn(m, __fadd_rn(gv[i], b));
    a = __fmul_rn(a, m);
  }

  // 3. the suffix maps of the channel's segments in this warp, and the
  // right neighbour's (for the carry into this segment)
  float na = 1.0f, nb = 0.0f;
  if constexpr (G > 1) {
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const float oa = __shfl_down_sync(0xffffffffu, a, d * W);
      const float ob = __shfl_down_sync(0xffffffffu, b, d * W);
      if (s + d < G) {
        b = __fmaf_rn(a, ob, b);
        a = __fmul_rn(a, oa);
      }
    }
    na = __shfl_down_sync(0xffffffffu, a, W);
    nb = __shfl_down_sync(0xffffffffu, b, W);
  }
  if (s == 0) wa[warp][c] = a, wb[warp][c] = b;
  __syncthreads();
  if (warp == 0) {  // the chunk's map, from the last warp to the first
    if (lane < W && q + 1 < L) {
      float A = wa[kWarps - 1][lane], B = wb[kWarps - 1][lane];
#pragma unroll
      for (int w = kWarps - 2; w >= 0; --w) {
        B = __fmaf_rn(wa[w][lane], B, wb[w][lane]);
        A = __fmul_rn(wa[w][lane], A);
      }
      if (lane < width) {
        agg[(long)q * C + c0 + lane] = A;
        agg[((long)L + q) * C + c0 + lane] = B;
      }
      __threadfence();
    }
    __syncwarp();
    if (lane == 0 && q + 1 < L) store_release(flags + 1 + q * tiles + tile, 1);
  }

  // 4. the carry entering the chunk: g_final through every later chunk's
  // map, from the last; the maps published by blocks that took their
  // tickets before this one and that wait on nothing after publishing
  for (int p = tid; p < q; p += kThreads)
    while (load_acquire(flags + 1 + p * tiles + tile) == 0) __nanosleep(32);
  __threadfence();
  __syncthreads();
  float carry = tid < width ? g_final[c0 + tid] : 0.0f;
  constexpr int kPer = kWalk / W;  // chunks a round of the walk stages
  for (int p0 = 0; p0 < q; p0 += kPer) {
    const int np = min(kPer, q - p0);
    for (int e = tid; e < np * W; e += kThreads) {
      const int p = p0 + e / W, cc = e - (e / W) * W;
      const bool in = cc < width;
      walk_a[e] = in ? __ldcg(agg + (long)p * C + c0 + cc) : 1.0f;
      walk_b[e] = in ? __ldcg(agg + ((long)L + p) * C + c0 + cc) : 0.0f;
    }
    __syncthreads();
    if (tid < W)
      for (int i = 0; i < np; ++i)
        carry = __fmaf_rn(walk_a[i * W + tid], carry, walk_b[i * W + tid]);
    __syncthreads();
  }

  // 5. the carry into each warp, from the last; into each segment; the
  // segments walked again
  if (tid < W) {
    float in = carry;
    win[kWarps - 1][tid] = in;
#pragma unroll
    for (int w = kWarps - 2; w >= 0; --w) {
      in = __fmaf_rn(wa[w + 1][tid], in, wb[w + 1][tid]);
      win[w][tid] = in;
    }
  }
  __syncthreads();
  float in = win[warp][c];
  if (s + 1 < G) in = __fmaf_rn(na, in, nb);
#pragma unroll
  for (int i = kSeg - 1; i >= 0; --i) {
    const float lam = __fadd_rn(gv[i], in);
    if (live && r0 + i < n) sx[(r0 + i) * W + c] = __fmul_rn(k[i], lam);
    in = __fmul_rn(__fsub_rn(1.0f, k[i]), lam);
  }
  if (t0 == 0 && r0 == 0 && live) g_state_in[c0 + c] = in;
  __syncthreads();
  stage_out<W>(gx + off, sx, layout, n, C, width, tid);
}

template <int W, class Op>
cudaError_t launch_width(const Op& op, const float* x, const float* y, const float* y0,
                         const float* g, const float* g_final, float* gx, float* g_state_in,
                         float* agg, int* flags, int T, int C, cudaStream_t stream) {
  const int L = (T + kChunk - 1) / kChunk, tiles = (C + W - 1) / W;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * (1 + (size_t)L * tiles), stream);
  if (err != cudaSuccess) return err;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(gx)) &
                        15) == 0;
  const Layout layout = !aligned ? kRows : W == C ? kFlat4 : C % 4 == 0 && W % 4 == 0 ? kRows4
                                                                                       : kRows;
  const size_t smem = sizeof(float) * 3 * kChunk * W;
  auto kernel = grid_adjoint<W, Op>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<L * tiles, kThreads, smem, stream>>>(op, x, y, y0, g, g_final, gx, g_state_in, agg,
                                                flags, T, C, L, layout);
  return cudaGetLastError();
}

// The tile width of C channels: C rounded up to a power of two, at most 32.
inline int width_of(int C) {
  int w = 1;
  while (w < C && w < 32) w <<= 1;
  return w;
}

// Enqueues the adjoint on `stream` (a memset of `flags`, then the kernel):
// x, y, g, gx (T, C) (x or g may be null); y0, g_final, g_state_in (C,);
// agg (2, ceil(T / 256), C) and flags (1 + ceil(T / 256) * ceil(C /
// width_of(C))) scratch.
template <class Op>
cudaError_t launch(const Op& op, const float* x, const float* y, const float* y0,
                   const float* g, const float* g_final, float* gx, float* g_state_in,
                   float* agg, int* flags, int T, int C, cudaStream_t stream) {
  if (T < 1 || C < 1) return cudaErrorInvalidValue;
  switch (width_of(C)) {
#define PGT_WIDTH(W) \
  case W:            \
    return launch_width<W>(op, x, y, y0, g, g_final, gx, g_state_in, agg, flags, T, C, stream);
    PGT_WIDTH(1) PGT_WIDTH(2) PGT_WIDTH(4) PGT_WIDTH(8) PGT_WIDTH(16) PGT_WIDTH(32)
#undef PGT_WIDTH
  }
  return cudaErrorInvalidValue;
}

}  // namespace order1_grid
