// Order-2 time-varying affine scan over (T, C) planes, for Hopper (sm_90a).
//
// Replaces pygmu2_tpu/ops/linrec_pallas.py:affine_scan_2_pallas (body in
// _scan_kernel): s[t] = A[t] s[t-1] + u[t] with A = [[a11, a12], [a21, a22]],
// u = [u1, u2], an optional state s0 before step 0, in chunks of `chunk`
// samples: a Kogge-Stone scan of the affine maps within each chunk (shifted-in
// rows are the identity map), then the state entering the chunk applied to
// every row, the chunk's last row carried to the next chunk.
//
// What bounds it on this card: bytes. Per (sample, channel) it reads two
// input floats and writes two (33 MB at T = 16384, C = 128 when the four
// matrix planes are one column shared by the channels, as for BiquadPE and
// SVFilterPE; 67 MB with six full planes) and does ~20 flops per
// Kogge-Stone pass, 10 passes at chunk 1024: ~0.01 ms of bytes against
// ~0.006 ms of flops at the data sheet's rates. The scan's serial dependence
// is across chunks only, 16 steps at T = 16384.
//
// What the design does about it (the first design ran one CUDA block per
// channel, a thread per row reading rows C floats apart, and walked the
// channel's chunks in order with a barrier of 1024 threads per pass):
//   tiles    a CUDA block takes one chunk and a tile of K channels: each row
//            of the tile is K contiguous floats (K = 8 with shared matrix
//            planes: one 32-byte sector), read and written with 16-byte
//            loads and stores straight to and from registers. The grid
//            covers (chunk x tile): 256 blocks of 256 threads at T = 16384,
//            C = 128, two a SM.
//   rows     a thread holds R rows of the chunk, row r * NT + t (NT =
//            chunk / R threads): the passes with s >= NT take their partner
//            row from the same thread's registers; the others exchange rows
//            through shared memory, one barrier to publish and one to reuse.
//   shared   with the four matrix planes shared by the channels, a thread
//   planes   forms each pass's matrix once per row for its K channels; each
//            channel's (v1, v2) pass uses the row's matrix before the pass
//            updates it, as the plain version does.
//   carry    one launch: the blocks take tickets from an atomic counter,
//            chunk by chunk. A block scans its chunk, publishes the chunk's
//            last row (a flag per chunk and tile), waits for the earlier
//            chunks' rows (published by blocks that took their tickets
//            before it and wait on nothing after their scan), walks them in
//            the plain version's order (its serial carry, <= 15 steps at
//            T = 16384), applies the entering state and writes the rows. The
//            order is fixed, so two calls give the same bits. (Two launches,
//            the chunks' last rows by their Kogge-Stone tree alone and then
//            the scan with the walk, measured slower on both layouts.)

// The adjoint (the backward of the JAX custom VJP, linrec_pallas.py:95-108,
// which replays jax.vjp of linrec.affine_scan_2): lam[t] = g[t] +
// A[t+1]^T lam[t+1] is this scan run backward in time on the transposed
// matrices, so the same chunk code runs it (ADJ), reading its rows by index
// from the forward's planes with no copy: scan row r is time T - 1 - r, its
// matrix A[T - r]^T (row 0 the zero matrix: it multiplies the zero state
// after the last sample), its input (g1, g2)[T - 1 - r]; the padding falls
// before t = 0. Its epilogue writes, in forward time, gu = lam, gA[t] =
// lam[t] p[t]^T with p = s[t - 1] (s0 or zero at t = 0), and gs0 = A[0]^T
// lam[0] (two products and a sum, no fused multiply-add, as the plain
// version rounds them). A plane that every channel shares gets its column:
// each tile's channels added in channel order from zero, then (a second
// launch, channel_sum.cuh) the tiles in tile order from zero. No atomics:
// two calls give the same bits. Bytes at the fit bank's shapes (T = 16384,
// C = 128, the matrices shared): g, s and gu, six (T, C) planes, 50 MB; the
// tiles' partial sums 4 MB more, written and read.

// Explicitly rounded ops in the plain version's order
// (ops/linrec_kernel.affine_scan_2_chunked_ref): every a*b + c*d is
// __fmaf_rn(a, b, __fmul_rn(c, d)), the one fused multiply-add XLA's CPU
// backend makes of it in the JAX package's reference, every other sum
// __fadd_rn. Any schedule that forms the same expressions gives the same
// bits: the kernel equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

#include "channel_sum.cuh"

namespace {

constexpr int kMaxChunk = 1024;

// a*b + c*d as XLA's CPU backend contracts it in the JAX reference
__device__ __forceinline__ float dot2(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, __fmul_rn(c, d));
}

// A 2x2 matrix as (m11, m12, m21, m22): the product c p.
__device__ __forceinline__ float4 mat_mul(const float4& c, const float4& p) {
  return make_float4(dot2(c.x, p.x, c.y, p.z), dot2(c.x, p.y, c.y, p.w),
                     dot2(c.z, p.x, c.w, p.z), dot2(c.z, p.y, c.w, p.w));
}

struct Planes {
  const float* p[6];  // a11, a12, a21, a22, u1, u2 (the adjoint: a11, a21, a12, a22, g1, g2)
  int shared;         // bit k: plane k is a (T,) column shared by the channels
  bool vec;           // C % 4 == 0 and every full plane read or written 16-byte aligned
};

// The adjoint's other operands (unused by the forward).
struct Adjoint {
  const float* s1;  // the forward's outputs, (T, C): p[t] = s[t - 1]
  const float* s2;
  float* out[6];    // ga11, ga12, ga21, ga22, gu1, gu2: (T, C), or null where summed
  float* part;      // the summed outputs' tile sums, (popcount(summed), T, tiles)
  int summed;       // bit j: output j is a column shared by the channels
  float* gs01;      // (C,) each, or null without an entering state
  float* gs02;
};

// K values of a full (T, C) plane at `row`, channels c0 .. c0 + K - 1 (0 past C).
template <int K>
__device__ __forceinline__ void load_full(const float* p, long row, int C, int c0, bool vec,
                                          float (&out)[K]) {
  const float* q = p + row * C + c0;
  if (vec) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + 4 * j < C) v = __ldg(reinterpret_cast<const float4*>(q) + j);
      out[4 * j] = v.x, out[4 * j + 1] = v.y, out[4 * j + 2] = v.z, out[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) out[j] = c0 + j < C ? __ldg(q + j) : 0.0f;
  }
}

// K values of plane k at `row`, channels c0 .. c0 + K - 1 (0 past C).
template <int K>
__device__ __forceinline__ void load_plane(const Planes& pl, int k, long row, int C, int c0,
                                           float (&out)[K]) {
  if ((pl.shared >> k) & 1) {
    const float x = __ldg(pl.p[k] + row);
#pragma unroll
    for (int j = 0; j < K; ++j) out[j] = x;
    return;
  }
  load_full<K>(pl.p[k], row, C, c0, pl.vec, out);
}

// K values into a full (T, C) plane at `row`, channels c0 .. (none past C).
template <int K>
__device__ __forceinline__ void store_full(float* p, long row, int C, int c0, bool vec,
                                           const float (&v)[K]) {
  float* d = p + row * C + c0;
  if (vec) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j)
      if (c0 + 4 * j < C)
        reinterpret_cast<float4*>(d)[j] =
            make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (c0 + k < C) d[k] = v[k];
  }
}

// The adjoint's outputs at time tt from its K channels' lam (see the note
// at the top): gA = lam p^T, gu = lam, each written as a (T, C) row or, where
// summed, as the tile's sum in channel order; gs0 at tt = 0.
template <int K>
__device__ __forceinline__ void adjoint_row(const Planes& pl, const Adjoint& adj,
                                            const float* s01, const float* s02, long tt, int T,
                                            int C, int c0, int tile, int tiles,
                                            const float (&l1)[K], const float (&l2)[K]) {
  float p1[K], p2[K];
  if (tt > 0) {
    load_full<K>(adj.s1, tt - 1, C, c0, pl.vec, p1);
    load_full<K>(adj.s2, tt - 1, C, c0, pl.vec, p2);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool in = s01 != nullptr && c0 + k < C;
      p1[k] = in ? s01[c0 + k] : 0.0f;
      p2[k] = in ? s02[c0 + k] : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float lam = j == 0 || j == 1 || j == 4 ? l1[k] : l2[k];
      v[k] = j < 4 ? __fmul_rn(lam, j & 1 ? p2[k] : p1[k]) : lam;
    }
    if ((adj.summed >> j) & 1) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (c0 + k < C) s = __fadd_rn(s, v[k]);
      adj.part[((long)__popc(adj.summed & ((1 << j) - 1)) * T + tt) * tiles + tile] = s;
    } else {
      store_full<K>(adj.out[j], tt, C, c0, pl.vec, v);
    }
  }
  if (tt == 0 && adj.gs01 != nullptr) {
    float a[4][K];  // A[0]: a11, a21, a12, a22 (the adjoint's planes)
#pragma unroll
    for (int m = 0; m < 4; ++m) load_plane<K>(pl, m, 0, C, c0, a[m]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (c0 + k < C) {
        adj.gs01[c0 + k] = __fadd_rn(__fmul_rn(a[0][k], l1[k]), __fmul_rn(a[1][k], l2[k]));
        adj.gs02[c0 + k] = __fadd_rn(__fmul_rn(a[2][k], l1[k]), __fmul_rn(a[3][k], l2[k]));
      }
    }
  }
}

// R rows of a thread, K channels each; with shared matrix planes (SH) one
// matrix per row, else one per (row, channel).
template <int K, int R, bool SH>
struct Rows {
  static constexpr int MK = SH ? 1 : K;
  // float4 fields of a row in the exchange buffer: the matrices, v1, v2
  static constexpr int F = MK + K / 2;
  float4 m[R][MK];
  float v1[R][K], v2[R][K];

  // row r := row r after prev (m, q1, q2): the pass of the plain version
  __device__ __forceinline__ void combine(int r, const float4 (&pm)[MK], const float (&q1)[K],
                                          const float (&q2)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4& c = m[r][SH ? 0 : k];
      const float n1 = __fadd_rn(dot2(c.x, q1[k], c.y, q2[k]), v1[r][k]);
      const float n2 = __fadd_rn(dot2(c.z, q1[k], c.w, q2[k]), v2[r][k]);
      v1[r][k] = n1, v2[r][k] = n2;
    }
#pragma unroll
    for (int j = 0; j < MK; ++j) m[r][j] = mat_mul(m[r][j], pm[j]);
  }

  // A partner row's values, (pm, q1, q2): the identity map (shifted in
  // before the chunk's first row), this thread's row rp, or a row published
  // in the exchange buffer.
  __device__ __forceinline__ static void identity(float4 (&pm)[MK], float (&q1)[K],
                                                  float (&q2)[K]) {
#pragma unroll
    for (int j = 0; j < MK; ++j) pm[j] = make_float4(1.0f, 0.0f, 0.0f, 1.0f);
#pragma unroll
    for (int k = 0; k < K; ++k) q1[k] = 0.0f, q2[k] = 0.0f;
  }

  __device__ __forceinline__ void own(int rp, float4 (&pm)[MK], float (&q1)[K],
                                      float (&q2)[K]) const {
#pragma unroll
    for (int j = 0; j < MK; ++j) pm[j] = m[rp][j];
#pragma unroll
    for (int k = 0; k < K; ++k) q1[k] = v1[rp][k], q2[k] = v2[rp][k];
  }

  // the exchange buffer: field f of row (r, t) at xb[(f * R + r) * nt + t]
  __device__ __forceinline__ void publish(float4* xb, int r, int t, int nt) const {
#pragma unroll
    for (int j = 0; j < MK; ++j) xb[(j * R + r) * nt + t] = m[r][j];
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      xb[((MK + j) * R + r) * nt + t] =
          make_float4(v1[r][4 * j], v1[r][4 * j + 1], v1[r][4 * j + 2], v1[r][4 * j + 3]);
      xb[((MK + K / 4 + j) * R + r) * nt + t] =
          make_float4(v2[r][4 * j], v2[r][4 * j + 1], v2[r][4 * j + 2], v2[r][4 * j + 3]);
    }
  }

  __device__ __forceinline__ static void published(const float4* xb, int rp, int tp, int nt,
                                                   float4 (&pm)[MK], float (&q1)[K],
                                                   float (&q2)[K]) {
#pragma unroll
    for (int j = 0; j < MK; ++j) pm[j] = xb[(j * R + rp) * nt + tp];
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const float4 a = xb[((MK + j) * R + rp) * nt + tp];
      const float4 b = xb[((MK + K / 4 + j) * R + rp) * nt + tp];
      q1[4 * j] = a.x, q1[4 * j + 1] = a.y, q1[4 * j + 2] = a.z, q1[4 * j + 3] = a.w;
      q2[4 * j] = b.x, q2[4 * j + 1] = b.y, q2[4 * j + 2] = b.z, q2[4 * j + 3] = b.w;
    }
  }
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One CUDA block per (chunk, tile), in ticket order: load, scan, publish the
// chunk's last row, take the entering state from the earlier chunks' rows,
// apply, write. flags[0] is the ticket counter, flags[1 + ch * tiles + tile]
// is set once chunk ch's last row of the tile is in agg (all zeroed before
// the launch). ADJ: the adjoint, its rows read by index and its epilogue
// adjoint_row's.
template <int K, int R, bool SH, bool ADJ>
__global__ void __launch_bounds__(SH ? 256 : 512, SH ? 2 : 1)
    affine_scan_2(const __grid_constant__ Planes pl, const __grid_constant__ Adjoint adj,
                  const float* __restrict__ s01, const float* __restrict__ s02,
                  float* __restrict__ s1_out, float* __restrict__ s2_out,
                  float* __restrict__ agg, int* __restrict__ flags, int T, int C, int chunk,
                  int L) {
  extern __shared__ float4 xb[];  // Rows::F x chunk float4; then the entering state
  __shared__ int ticket;
  using RowsT = Rows<K, R, SH>;
  const int nt = chunk / R;
  const int t = threadIdx.x;
  const int tiles = (C + K - 1) / K;
  if (t == 0) ticket = atomicAdd(flags, 1);  // chunk by chunk, in launch order
  __syncthreads();
  const int tile = ticket % tiles, ch = ticket / tiles;
  const int c0 = tile * K;
  const long base = (long)ch * chunk, plane = (long)L * C;
  float* cin = reinterpret_cast<float*>(xb + RowsT::F * chunk);  // [2][K]

  RowsT rows;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long row = base + r * nt + t;
    if (row < T) {
      // the adjoint's row: the matrix A[T - row]^T (zero at row 0), the
      // input at T - 1 - row
      const long mrow = ADJ ? T - row : row, urow = ADJ ? T - 1 - row : row;
      const bool zero = ADJ && row == 0;
      float v[K];
      if (SH) {
        rows.m[r][0] = zero ? make_float4(0.f, 0.f, 0.f, 0.f)
                            : make_float4(__ldg(pl.p[0] + mrow), __ldg(pl.p[1] + mrow),
                                          __ldg(pl.p[2] + mrow), __ldg(pl.p[3] + mrow));
      } else {
        float a[4][K];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (zero) {
#pragma unroll
            for (int j = 0; j < K; ++j) a[k][j] = 0.0f;
          } else {
            load_plane<K>(pl, k, mrow, C, c0, a[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          rows.m[r][SH ? 0 : k] = make_float4(a[0][k], a[1][k], a[2][k], a[3][k]);
      }
      load_plane<K>(pl, 4, urow, C, c0, v);
#pragma unroll
      for (int k = 0; k < K; ++k) rows.v1[r][k] = v[k];
      load_plane<K>(pl, 5, urow, C, c0, v);
#pragma unroll
      for (int k = 0; k < K; ++k) rows.v2[r][k] = v[k];
    } else {  // the plain version's zero padding
#pragma unroll
      for (int j = 0; j < RowsT::MK; ++j) rows.m[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < K; ++k) rows.v1[r][k] = 0.0f, rows.v2[r][k] = 0.0f;
    }
  }
  if (!ADJ && ch == 0 && t == 0 && s01 != nullptr) {  // fold s0 into u[0]
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (c0 + k < C) {
        const float4& m = rows.m[0][SH ? 0 : k];
        const float a = s01[c0 + k], b = s02[c0 + k];
        rows.v1[0][k] = __fadd_rn(rows.v1[0][k], dot2(m.x, a, m.y, b));
        rows.v2[0][k] = __fadd_rn(rows.v2[0][k], dot2(m.z, a, m.w, b));
      }
    }
  }

  for (int s = 1; s < chunk; s <<= 1) {
    float4 pm[RowsT::MK];
    float q1[K], q2[K];
    if (s < nt) {
      // partner row (r, t - s), or (r - 1, t - s + nt) across the wrap,
      // through the exchange buffer
      __syncthreads();  // the previous pass's reads are done
#pragma unroll
      for (int r = 0; r < R; ++r) rows.publish(xb, r, t, nt);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int tp = t - s, rp = r;
        if (tp < 0) tp += nt, rp = r - 1;
        if (rp >= 0) RowsT::published(xb, rp, tp, nt, pm, q1, q2);
        else RowsT::identity(pm, q1, q2);
        rows.combine(r, pm, q1, q2);
      }
    } else {
      // partner row r - s / nt of the same thread, not yet updated
      // (register arrays take compile-time indices: q runs over all rows,
      // a constant trip count, so that both loops unroll)
      const int d = s / nt;
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        if (r < d) RowsT::identity(pm, q1, q2);
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (q + d == r) rows.own(q, pm, q1, q2);
        rows.combine(r, pm, q1, q2);
      }
    }
  }

  // the chunk's last row (row R - 1 of thread nt - 1), for the chunks after
  if (t == nt - 1 && ch + 1 < L) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k;
      if (c < C) {
        const long at = (long)ch * C + c;
        const float4& m = rows.m[R - 1][SH ? 0 : k];
        agg[at] = m.x, agg[plane + at] = m.y, agg[2 * plane + at] = m.z;
        agg[3 * plane + at] = m.w, agg[4 * plane + at] = rows.v1[R - 1][k];
        agg[5 * plane + at] = rows.v2[R - 1][k];
      }
    }
    __threadfence();
    store_release(flags + 1 + ch * tiles + tile, 1);
  }
  // the earlier chunks' rows: published by blocks that took their tickets
  // before this one, and that wait on nothing after their scan
  for (int j = t; j < ch; j += nt)
    while (load_acquire(flags + 1 + j * tiles + tile) == 0) __nanosleep(32);
  __threadfence();
  __syncthreads();
  // the state entering the chunk: those rows in the plain version's order,
  // one channel a thread (unrolled by 4: four chunks' loads in flight)
  for (int kk = t; kk < K; kk += nt) {
    float e1 = 0.0f, e2 = 0.0f;
    const int c = c0 + kk;
#pragma unroll 4
    for (int j = 0; j < ch && c < C; ++j) {
      const float* a = agg + (long)j * C + c;
      const float m11 = __ldcg(a), m12 = __ldcg(a + plane), m21 = __ldcg(a + 2 * plane),
                  m22 = __ldcg(a + 3 * plane), v1 = __ldcg(a + 4 * plane),
                  v2 = __ldcg(a + 5 * plane);
      const float n1 = __fadd_rn(dot2(m11, e1, m12, e2), v1);
      e2 = __fadd_rn(dot2(m21, e1, m22, e2), v2);
      e1 = n1;
    }
    cin[kk] = e1;
    cin[K + kk] = e2;
  }

  __syncthreads();  // the entering state
  float e1[K], e2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) e1[k] = cin[k], e2[k] = cin[K + k];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long row = base + r * nt + t;
    float o1[K], o2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4& m = rows.m[r][SH ? 0 : k];
      o1[k] = __fadd_rn(dot2(m.x, e1[k], m.y, e2[k]), rows.v1[r][k]);
      o2[k] = __fadd_rn(dot2(m.z, e1[k], m.w, e2[k]), rows.v2[r][k]);
    }
    float* d1 = s1_out + row * C + c0;
    float* d2 = s2_out + row * C + c0;
    if (row >= T) {
      // past the end: the plain version's padding, not written
    } else if (ADJ) {
      adjoint_row<K>(pl, adj, s01, s02, T - 1 - row, T, C, c0, tile, tiles, o1, o2);
    } else if (pl.vec) {
#pragma unroll
      for (int j = 0; j < K / 4; ++j) {
        if (c0 + 4 * j < C) {
          reinterpret_cast<float4*>(d1)[j] =
              make_float4(o1[4 * j], o1[4 * j + 1], o1[4 * j + 2], o1[4 * j + 3]);
          reinterpret_cast<float4*>(d2)[j] =
              make_float4(o2[4 * j], o2[4 * j + 1], o2[4 * j + 2], o2[4 * j + 3]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (c0 + k < C) d1[k] = o1[k], d2[k] = o2[k];
    }
  }
}

template <int K, int R, bool SH, bool ADJ>
cudaError_t launch(const Planes& pl, const Adjoint& adj, const float* s01, const float* s02,
                   float* s1, float* s2, float* agg, int* flags, int T, int C, int chunk,
                   cudaStream_t stream) {
  using RowsT = Rows<K, R, SH>;
  const int L = (T + chunk - 1) / chunk, tiles = (C + K - 1) / K;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * (1 + (size_t)L * tiles), stream);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float4) * RowsT::F * chunk + sizeof(float) * 2 * K;
  auto kernel = affine_scan_2<K, R, SH, ADJ>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<L * tiles, chunk / R, smem, stream>>>(pl, adj, s01, s02, s1, s2, agg, flags, T, C,
                                                 chunk, L);
  return cudaGetLastError();
}

// The forward's or the adjoint's launch at its tile width: K = 8 channels a
// tile where the four matrix planes are one column (BiquadPE, SVFilterPE),
// else 4.
template <bool ADJ>
cudaError_t dispatch(const Planes& pl, const Adjoint& adj, const float* s01, const float* s02,
                     float* s1, float* s2, float* agg, int* flags, int T, int C, int chunk,
                     cudaStream_t stream) {
  if ((pl.shared & 15) == 15)
    return chunk >= 4
               ? launch<8, 4, true, ADJ>(pl, adj, s01, s02, s1, s2, agg, flags, T, C, chunk,
                                         stream)
               : launch<8, 2, true, ADJ>(pl, adj, s01, s02, s1, s2, agg, flags, T, C, chunk,
                                         stream);
  return launch<4, 2, false, ADJ>(pl, adj, s01, s02, s1, s2, agg, flags, T, C, chunk, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool valid(int T, int C, int chunk) {
  return T >= 1 && C >= 1 && chunk >= 2 && chunk <= kMaxChunk && !(chunk & (chunk - 1));
}

}  // namespace

extern "C" {

// Enqueues the call on `stream` (a memset of `flags`, then the kernel);
// returns the cudaError_t of the first step that failed (0: both accepted).
// Pointers are device pointers: the six planes, each (T, C) f32 or, where
// its bit k of `shared` is set, a (T,) f32 column shared by the channels;
// s01 / s02 (C,) f32 or both null; s1 / s2 (T, C) f32 outputs; agg a (6,
// ceil(T / chunk), C) f32 scratch (the chunks' last rows) and flags one of
// 1 + ceil(T / chunk) * C ints. Needs chunk a power of two in [2, 1024].
int affine_scan_2_launch(const float* a11, const float* a12, const float* a21,
                         const float* a22, const float* u1, const float* u2,
                         const float* s01, const float* s02, float* s1, float* s2, float* agg,
                         int* flags, int T, int C, int chunk, int shared, cudaStream_t stream) {
  if (!valid(T, C, chunk)) return (int)cudaErrorInvalidValue;
  Planes pl{{a11, a12, a21, a22, u1, u2}, shared, C % 4 == 0};
  for (int k = 0; k < 6; ++k)
    if (!((shared >> k) & 1) && !aligned16(pl.p[k])) pl.vec = false;
  if (!aligned16(s1) || !aligned16(s2)) pl.vec = false;
  return (int)dispatch<false>(pl, Adjoint{}, s01, s02, s1, s2, agg, flags, T, C, chunk, stream);
}

// The adjoint of a call (its planes, its entering state s01 / s02 or both
// null, its outputs s1 / s2 and their cotangents g1 / g2, `shared` in the
// forward's bits, g1's and g2's bits 4 and 5): enqueues the memset of
// `flags`, the adjoint's launch and, where `summed` (bit j: output j of
// ga11, ga12, ga21, ga22, gu1, gu2 is a column shared by the channels; its
// plane's bit must be in `shared`) is not 0, channel_sum's launch; returns
// the cudaError_t of the first step that failed. Outputs: the six (T, C)
// planes, each null where summed; gs01 / gs02 (C,), null without s0; col
// (popcount(summed), T), the summed outputs in bit order; part
// (popcount(summed), T, ceil(C / K)) f32 scratch, K = 8 where the four
// matrix planes are shared, else 4; agg and flags as the forward's.
int affine_scan_2_bwd_launch(const float* a11, const float* a12, const float* a21,
                             const float* a22, const float* g1, const float* g2,
                             const float* s01, const float* s02, const float* s1,
                             const float* s2, float* ga11, float* ga12, float* ga21,
                             float* ga22, float* gu1, float* gu2, float* gs01, float* gs02,
                             float* part, float* col, float* agg, int* flags, int T, int C,
                             int chunk, int shared, int summed, cudaStream_t stream) {
  if (!valid(T, C, chunk) || (summed & ~shared & 15)) return (int)cudaErrorInvalidValue;
  // the adjoint's planes: A^T, (a11, a21, a12, a22), then g1, g2
  const int bits = (shared & 1) | ((shared >> 2) & 1) << 1 | ((shared >> 1) & 1) << 2 |
                   (shared & 56);
  Planes pl{{a11, a21, a12, a22, g1, g2}, bits, C % 4 == 0};
  Adjoint adj{s1, s2, {ga11, ga12, ga21, ga22, gu1, gu2}, part, summed, gs01, gs02};
  for (int k = 0; k < 6; ++k) {
    if (!((bits >> k) & 1) && !aligned16(pl.p[k])) pl.vec = false;
    if (!((summed >> k) & 1) && !aligned16(adj.out[k])) pl.vec = false;
  }
  if (!aligned16(s1) || !aligned16(s2)) pl.vec = false;
  cudaError_t err =
      dispatch<true>(pl, adj, s01, s02, nullptr, nullptr, agg, flags, T, C, chunk, stream);
  if (err != cudaSuccess || summed == 0) return (int)err;
  const int K = (bits & 15) == 15 ? 8 : 4;
  return (int)launch_channel_sum(part, col, __builtin_popcount(summed) * T, (C + K - 1) / K,
                                 stream);
}

}  // extern "C"
