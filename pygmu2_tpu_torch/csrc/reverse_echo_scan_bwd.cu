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
// buffers differ, so a period's samples are independent; across periods a
// period's replays add to the rows the period before wrote. The
// per-sample cotangent of p_rpos gives the ratio's by a reverse running
// sum (p_rpos after sample t is the sum of the ratios up to t) and misc's.
//
// What bounds it on this card: bytes. At the fx bank's block (T = 16384,
// C = 128, cap 22050, plen 735) the gradient reads x, y, gy and the line in
// and writes gx: ~34 MB with the rings' cotangents, ~10 us at 3.35 TB/s.
//
// The design: the forward's control results are residuals (its table,
// period bounds and count, csrc/reverse_echo_control.cuh): no control pass
// here, and the host never reads the count. Five passes on the caller's
// stream, no atomics (two launches on the same inputs give the same bits):
// 1. echo_index, once a call (shared by the channels): each line row's
//    readers (the T x 4 taps and T pass-throughs) in the order the plain
//    version adds them: periods last first; in a period the pass-throughs,
//    then tap 0, 1, 2, 3, each in time order. A tap of sample t reads the
//    input of a time in [t - plen + 1, t] (or the line handed in), so a
//    CUDA block takes 256 rows (by input time), reads once into shared
//    memory which of its rows each reader of the plen + 255 samples that
//    may read them reads, and ranks them a chunk of 256 at a time in that
//    order: a warp's equal rows found by __match_any_sync, the warps'
//    counts summed in warp order (a stable counting sort, two passes: the
//    counts, then the places). Which row each candidate reads takes 5 x 2
//    bytes a sample of the plen + 255: in shared memory up to 200 KB (a
//    pitch line of 20225 rows), past that in device scratch the wrapper
//    allocates, a slice a CUDA block (the same passes, the same order);
// 2. echo_walk, a cooperative launch over the whole card (grid sized by
//    the occupancy API): the periods in reverse, each period's samples and
//    channels spread over every thread (four channels a lane in 16-byte
//    pieces where C % 4 == 0), a grid-wide barrier between periods; each
//    (t, c) keeps its gc in scratch for the gather;
// 3. echo_gather over (line row, channel): the final pitch line's
//    cotangent first, then the row's readers in the index's order;
// 4. channel_sum (channel_sum.cuh): the feedback's and the read
//    position's parts over the channels, in channel order;
// 5. echo_ratio, one CUDA block: the ratio's cotangent, a reverse running
//    sum of the read position's (rows of 1024 samples from the end, each
//    row's suffix sums by warp shuffles and a carry), and misc's.
// The rings' cotangents are copied into the outputs before the walk
// updates them there. No torch op runs around the launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "channel_sum.cuh"
#include "reverse_echo_control.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 256;    // line rows (by input time) a CUDA block of echo_index
constexpr int kIndexThreads = 256;
constexpr int kIndexWarps = kIndexThreads / 32;
constexpr int kWalkThreads = 256;
constexpr int kGatherThreads = 256;
constexpr int kPass = 0;          // a reader's kind: the pass-through; 1 + i: tap i

// the input time a reader of kind `kind` at sample t reads (below 0: the
// line handed in); -plen - 1 when the sample has no reader of that kind
__device__ __forceinline__ int reader_time(const Tab& s, int t, int kind, int plen) {
  const bool near = s.rows.w & kNearUnity;
  if (kind == kPass) return near ? t : -plen - 1;
  if (near) return -plen - 1;
  const int i = kind == 1 ? s.taps.x : kind == 2 ? s.taps.y : kind == 3 ? s.taps.z : s.taps.w;
  int d = s.rows.z - i;
  if (d < 0) d += plen;
  return t - d;
}

__global__ void __launch_bounds__(kIndexThreads) echo_index(
    const Tab* __restrict__ tab, const int* __restrict__ bounds,
    const int* __restrict__ n_periods, int* __restrict__ first, int* __restrict__ count,
    int* __restrict__ list, short* __restrict__ rows_g, int T, int plen, int tile_cap) {
  // each candidate reader's row in the tile (-1: another tile's), by kind
  // and sample: s_row[kind * n_cap + t - ta]; in shared memory, or in this
  // CUDA block's slice of rows_g (a pitch line past 20225 rows)
  extern __shared__ short s_row_shared[];
  __shared__ int s_warp[kIndexWarps][kTileRows];  // a chunk's readers per warp and row
  __shared__ int s_run[kTileRows], s_off[kTileRows], s_sum[kIndexWarps];
  __shared__ int s_p[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * kTileRows - plen;  // the tile's first input time
  const int ta = max(s0, 0), tb = min(s0 + kTileRows + plen - 1, T);  // its readers' samples
  const int n_cap = kTileRows + plen - 1;
  short* s_row = rows_g ? rows_g + (long)blockIdx.x * 5 * n_cap : s_row_shared;
  int* out = list + (long)blockIdx.x * tile_cap;
  for (int t = ta + tid; t < tb; t += kIndexThreads) {
    const Tab s = tab[t];
#pragma unroll
    for (int kind = 0; kind < 5; ++kind) {
      const int src = reader_time(s, t, kind, plen);
      s_row[kind * n_cap + t - ta] = src >= s0 && src < s0 + kTileRows ? src - s0 : -1;
    }
  }
  if (tid == 0) {  // the periods holding ta and tb - 1
    const int np = *n_periods;
    int lo = 0, hi = 0;
    for (int step = 1 << 30; step > 0; step >>= 1) {
      if (lo + step < np && bounds[lo + step] <= ta) lo += step;
      if (hi + step < np && bounds[hi + step] <= tb - 1) hi += step;
    }
    s_p[0] = lo;
    s_p[1] = hi;
  }
  for (int pass = 0; pass < 2; ++pass) {
    s_run[tid] = 0;
#pragma unroll
    for (int w = 0; w < kIndexWarps; ++w) s_warp[w][tid] = 0;
    __syncthreads();
    for (int p = ta < tb ? s_p[1] : -1; p >= s_p[0]; --p) {
      const int a = max(ta, bounds[p]), b = min(tb, bounds[p + 1]);
      for (int kind = 0; kind < 5; ++kind) {
        for (int base = a; base < b; base += kIndexThreads) {
          const int t = base + tid;
          const int j = t < b ? s_row[kind * n_cap + t - ta] : -1;  // the reader's row in the tile
          const unsigned peers = __match_any_sync(0xffffffffu, j);
          const int rank = __popc(peers & ((1u << lane) - 1u));
          if (j >= 0 && rank == 0) s_warp[warp][j] = __popc(peers);
          __syncthreads();
          if (j >= 0) {
            int before = s_run[j] + rank;
            for (int w = 0; w < warp; ++w) before += s_warp[w][j];
            if (pass == 1) out[s_off[j] + before] = t * 8 + kind;
          }
          __syncthreads();
          int sum = 0;
#pragma unroll
          for (int w = 0; w < kIndexWarps; ++w) {
            sum += s_warp[w][tid];
            s_warp[w][tid] = 0;
          }
          s_run[tid] += sum;
          __syncthreads();
        }
      }
    }
    if (pass == 0) {  // the rows' places in the tile: an exclusive scan of the counts
      const int v = s_run[tid];
      int incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      if (lane == 31) s_sum[warp] = incl;
      __syncthreads();
      int base = 0;
      for (int w = 0; w < warp; ++w) base += s_sum[w];
      s_off[tid] = base + incl - v;
      const int row = blockIdx.x * kTileRows + tid;  // input time + plen
      if (row < T + plen) {
        first[row] = (int)((long)blockIdx.x * tile_cap) + base + incl - v;
        count[row] = v;
      }
      __syncthreads();
    }
  }
}

// V channels (1, or 4 as one 16-byte piece) at p
template <int V>
struct Lanes {
  float v[V];
  __device__ __forceinline__ static Lanes load(const float* p) {
    Lanes r;
    if constexpr (V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
    } else {
      r.v[0] = *p;
    }
    return r;
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *p = v[0];
  }
};

// the line's slot i at time t (write slot wslot), channels c .. c + V - 1
template <int V>
__device__ __forceinline__ Lanes<V> tap_at(const float* __restrict__ x,
                                           const float* __restrict__ pb_in, int t, int wslot,
                                           int i, int plen, int C, int c) {
  int d = wslot - i;
  if (d < 0) d += plen;
  const int src = t - d;
  return Lanes<V>::load(src >= 0 ? x + (long)src * C + c : pb_in + (long)i * C + c);
}

template <int V>
__device__ __forceinline__ void walk_item(
    const float* __restrict__ x, const float* __restrict__ fb, const float* __restrict__ y,
    const float* __restrict__ gy, const Tab* __restrict__ tab, float* lam_a, float* lam_b,
    const float* __restrict__ pb_in, float* __restrict__ gcs, float* __restrict__ gfb_part,
    float* __restrict__ gp_part, int t, int c, int C, int plen, float inv_half) {
  const Tab s = tab[t];
  const long row = (long)t * C + c;
  float* cur = (s.rows.w & kCurIsA) ? lam_a : lam_b;
  float* prev = (s.rows.w & kCurIsA) ? lam_b : lam_a;
  float* wp = cur + (long)s.rows.y * C + c;
  const Lanes<V> gc = Lanes<V>::load(wp);
  Lanes<V> zero, gfb, gp;
#pragma unroll
  for (int u = 0; u < V; ++u) zero.v[u] = gfb.v[u] = gp.v[u] = 0.0f;
  zero.store(wp);
  gc.store(gcs + row);
  if (s.rows.x >= 0) {
    float* rp = prev + (long)s.rows.x * C + c;
    const Lanes<V> g = Lanes<V>::load(gy + row), yy = Lanes<V>::load(y + row);
    Lanes<V> pr = Lanes<V>::load(rp);
    const float f = fb[t];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float gwet = __fmaf_rn(gc.v[u], f, g.v[u]);
      gfb.v[u] = __fmul_rn(gc.v[u], yy.v[u]);
      pr.v[u] = __fmaf_rn(gwet, s.mix.z, pr.v[u]);
    }
    pr.store(rp);
  }
  gfb.store(gfb_part + row);
  if (!(s.rows.w & kNearUnity)) {
    const int ws = s.rows.z;
    const Lanes<V> p0 = tap_at<V>(x, pb_in, t, ws, s.taps.x, plen, C, c);
    const Lanes<V> p1 = tap_at<V>(x, pb_in, t, ws, s.taps.y, plen, C, c);
    const Lanes<V> p2 = tap_at<V>(x, pb_in, t, ws, s.taps.z, plen, C, c);
    const Lanes<V> p3 = tap_at<V>(x, pb_in, t, ws, s.taps.w, plen, C, c);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float gs1 = __fmul_rn(gc.v[u], s.mix.x), gs2 = __fmul_rn(gc.v[u], s.mix.y);
      const float s1 = __fadd_rn(__fmul_rn(s.wts.x, p0.v[u]), __fmul_rn(s.wts.y, p1.v[u]));
      const float s2 = __fadd_rn(__fmul_rn(s.wts.z, p2.v[u]), __fmul_rn(s.wts.w, p3.v[u]));
      const float gfrac = __fmul_rn(gs1, __fsub_rn(p1.v[u], p0.v[u]));
      const float gfrac2 = __fmul_rn(gs2, __fsub_rn(p3.v[u], p2.v[u]));
      const float gdist = __fmul_rn(__fmul_rn(gc.v[u], __fsub_rn(s1, s2)), inv_half);
      gp.v[u] = __fadd_rn(__fadd_rn(gfrac, gfrac2), __fmul_rn(gdist, s.mix.w));
    }
  }
  gp.store(gp_part + row);
}

// The periods in reverse over the whole grid; V channels a lane (C % V == 0)
template <int V>
__global__ void __launch_bounds__(kWalkThreads) echo_walk(
    const float* __restrict__ x, const float* __restrict__ fb, const float* __restrict__ y,
    const float* __restrict__ gy, const Tab* __restrict__ tab, const int* __restrict__ bounds,
    const int* __restrict__ n_periods, float* lam_a, float* lam_b,
    const float* __restrict__ pb_in, float* __restrict__ gcs, float* __restrict__ gfb_part,
    float* __restrict__ gp_part, int T, int C, int plen, float inv_half) {
  cg::grid_group grid = cg::this_grid();
  const int Cv = C / V;
  const long stride = (long)gridDim.x * blockDim.x;
  for (int k = *n_periods - 1; k >= 0; --k) {
    const int a = bounds[k];
    const long n = (long)(bounds[k + 1] - a) * Cv;
    for (long q = (long)blockIdx.x * blockDim.x + threadIdx.x; q < n; q += stride) {
      const int t = a + (int)(q / Cv), c = (int)(q % Cv) * V;
      walk_item<V>(x, fb, y, gy, tab, lam_a, lam_b, pb_in, gcs, gfb_part, gp_part, t, c, C,
                   plen, inv_half);
    }
    grid.sync();  // this period's replays are the period before's writes
  }
}

// Each line row's cotangent: the final line's first, then its readers in
// the index's order; V channels a lane
template <int V>
__global__ void __launch_bounds__(kGatherThreads) echo_gather(
    const Tab* __restrict__ tab, const float* __restrict__ gcs, const float* __restrict__ gpb_out,
    const int* __restrict__ first, const int* __restrict__ count, const int* __restrict__ list,
    float* __restrict__ gline, int T, int C, int plen) {
  const int Cv = C / V;
  const int wslot0 = tab[0].rows.z;
  const long n = (long)(T + plen) * Cv;
  for (long q = (long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += (long)gridDim.x * blockDim.x) {
    const int key = (int)(q / Cv), c = (int)(q % Cv) * V;
    const int src = key - plen;  // the input time the row holds (below 0: the line in)
    const int slot = (src + wslot0 + plen) % plen;
    Lanes<V> g;
#pragma unroll
    for (int u = 0; u < V; ++u) g.v[u] = 0.0f;
    if (src >= T - plen) {  // the row is in the line after the call
      const Lanes<V> o = Lanes<V>::load(gpb_out + (long)slot * C + c);
#pragma unroll
      for (int u = 0; u < V; ++u) g.v[u] = __fadd_rn(g.v[u], o.v[u]);
    }
    const int* it = list + first[key];
    for (int i = 0, m = count[key]; i < m; ++i) {
      const int item = it[i], t = item >> 3, kind = item & 7;
      const Lanes<V> gc = Lanes<V>::load(gcs + (long)t * C + c);
      if (kind == kPass) {
#pragma unroll
        for (int u = 0; u < V; ++u) g.v[u] = __fadd_rn(g.v[u], gc.v[u]);
      } else {
        const Tab& s = tab[t];
        const float mix = kind <= 2 ? s.mix.x : s.mix.y;
        const float w = kind == 1 ? s.wts.x : kind == 2 ? s.wts.y : kind == 3 ? s.wts.z : s.wts.w;
#pragma unroll
        for (int u = 0; u < V; ++u)
          g.v[u] = __fadd_rn(g.v[u], __fmul_rn(__fmul_rn(gc.v[u], mix), w));
      }
    }
    g.store(gline + (long)(src >= 0 ? plen + src : slot) * C + c);
  }
}

constexpr int kRatioLanes = 1024;
constexpr int kRatioRows = 16;  // rows of 1024 samples a tile

// gratio[t] = (the sum of gp over s > t) + g_rpos, gm = 0 but gm[2] = (the
// sum of all gp) + g_rpos and gm[5] = gmisc[5] decay (the smoothed
// length's cotangent passed back T samples: decay = (1 - alpha)^T). The
// sums run over rows of 1024 samples from the end of the call: in a row,
// each warp's suffix sums by shuffles (v += v[lane + d], d = 1, 2, 4, 8,
// 16), the warps' totals likewise in warp 0, then each sample's sum is v
// plus (the carry from the rows after it plus the later warps' totals).
__global__ void __launch_bounds__(kRatioLanes) echo_ratio(const float* __restrict__ gp,
                                                          const float* __restrict__ gmisc,
                                                          float* __restrict__ gratio,
                                                          float* __restrict__ gm, int T,
                                                          float decay) {
  __shared__ float s_tot[32], s_off[32], s_row;
  const int y = threadIdx.x, lane = y & 31, warp = y >> 5;
  const float g_rpos = gmisc[2];
  float carry = 0.0f;  // the sum of gp after the row
  for (int r_end = T; r_end > 0; r_end -= kRatioLanes * kRatioRows) {  // tiles of 16 rows
    float v[kRatioRows];  // the tile's rows, loaded at once
#pragma unroll
    for (int r = 0; r < kRatioRows; ++r) {
      const int t = r_end - (r + 1) * kRatioLanes + y;
      v[r] = t >= 0 ? gp[t] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRatioRows; ++r) {  // the row ending at r_end - r * 1024
      float u = v[r];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float w = __shfl_down_sync(0xffffffffu, u, d);
        if (lane + d < 32) u = __fadd_rn(u, w);
      }
      if (lane == 0) s_tot[warp] = u;
      __syncthreads();
      if (warp == 0) {
        float tv = s_tot[lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const float w = __shfl_down_sync(0xffffffffu, tv, d);
          if (lane + d < 32) tv = __fadd_rn(tv, w);
        }
        const float later = __shfl_down_sync(0xffffffffu, tv, 1);
        s_off[lane] = lane + 1 < 32 ? __fadd_rn(carry, later) : carry;
        if (lane == 0) s_row = tv;
      }
      __syncthreads();
      const float after = __fadd_rn(u, s_off[warp]);  // the sum of gp over s >= t
      const int t = r_end - (r + 1) * kRatioLanes + y;
      if (t > 0)
        gratio[t - 1] = __fadd_rn(after, g_rpos);
      else if (t == 0)
        gm[2] = __fadd_rn(after, g_rpos);
      carry = __fadd_rn(carry, s_row);
      __syncthreads();  // s_tot, s_off and s_row are the next row's
    }
  }
  if (y == 0) gratio[T - 1] = __fadd_rn(0.0f, g_rpos);
  if (y < 9 && y != 2) gm[y] = y == 5 ? __fmul_rn(gmisc[5], decay) : 0.0f;
}

template <int V>
cudaError_t launch_passes(const float* x, const float* fb, const float* y, const float* gy,
                          const Tab* tab, const int* bounds, const int* n_periods,
                          float* lam_a, float* lam_b, const float* pb_in,
                          const float* gpb_out, float* gline, float* gcs, float* gfb_part,
                          float* gp_part, const int* first, const int* count, const int* list,
                          int T, int C, int plen, float inv_half, cudaStream_t stream) {
  // the walk's grid: every thread resident (a grid-wide barrier), no more
  // than the longest period could use
  static int resident[64];  // blocks a card, per device (0: not asked yet)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, echo_walk<V>, kWalkThreads, 0);
    if (err != cudaSuccess) return err;
    resident[dev] = sms * per_sm;
  }
  const long work = (long)T * (C / V);
  const int grid = (int)min((long)resident[dev], (work + kWalkThreads - 1) / kWalkThreads);
  void* args[] = {(void*)&x, (void*)&fb, (void*)&y, (void*)&gy, (void*)&tab, (void*)&bounds,
                  (void*)&n_periods, (void*)&lam_a, (void*)&lam_b, (void*)&pb_in,
                  (void*)&gcs, (void*)&gfb_part, (void*)&gp_part, (void*)&T, (void*)&C,
                  (void*)&plen, (void*)&inv_half};
  err = cudaLaunchCooperativeKernel((const void*)echo_walk<V>, dim3(grid > 0 ? grid : 1),
                                    dim3(kWalkThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  const long rows = (long)(T + plen) * (C / V);
  const int blocks = (int)min(4096L, (rows + kGatherThreads - 1) / kGatherThreads);
  echo_gather<V><<<blocks, kGatherThreads, 0, stream>>>(tab, gcs, gpb_out, first, count, list,
                                                        gline, T, C, plen);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues the passes on `stream`; returns the first cudaError_t (0 when
// all were accepted). Device pointers: x / y / gy (T, C) f32; fb (T,) f32;
// tab (T, 16) 32-bit, bounds (T + 1,) i32, n_periods (1,) i32: the
// forward launch's control results; pb_in / gpb_out (plen, C) f32; gbuf_a
// / gbuf_b (cap, C) f32: the cotangents of buf_a' and buf_b'; gmisc (9,)
// f32: misc''s. Out: lam_a / lam_b (cap, C) f32, the cotangents of buf_a
// and buf_b; gline (plen + T, C) f32, those of pitch_buf (rows 0 .. plen -
// 1) and x; gfb / gratio (T,) f32, the feedback's and the ratio's; gm (9,)
// f32, misc's. Scratch: gcs, gfb_part, gp_part (T, C) f32, gp (T,) f32,
// first / count (T + plen,) i32, list (ceil((T + plen) / 256), tile_cap)
// i32 with tile_cap = 4 (plen + 256); rows: null, or (ceil((T + plen) /
// 256), 5 (plen + 255)) i16, the readers' rows in device memory (needed
// past a pitch line of 20225 rows, where they outgrow shared memory).
// decay: float32((1 - alpha)^T).
int reverse_echo_scan_bwd_launch(const float* x, const float* fb, const float* y,
                                 const float* gy, const float* tab, const int* bounds,
                                 const int* n_periods, const float* gbuf_a,
                                 const float* gbuf_b, const float* gmisc, float* lam_a,
                                 float* lam_b, const float* pb_in, const float* gpb_out,
                                 float* gline, float* gfb, float* gratio, float* gm, float* gp,
                                 float* gcs, float* gfb_part, float* gp_part, int* first,
                                 int* count, int* list, short* rows, int T, int C, int cap,
                                 int plen, int tile_cap, float inv_half, float decay,
                                 cudaStream_t stream) {
  if (T < 1 || C < 1 || plen < 2 || tile_cap < 4 * (plen + kTileRows - 1))
    return (int)cudaErrorInvalidValue;
  const Tab* table = reinterpret_cast<const Tab*>(tab);
  const size_t ring_bytes = (size_t)cap * C * sizeof(float);
  cudaError_t err = cudaMemcpyAsync(lam_a, gbuf_a, ring_bytes, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(lam_b, gbuf_b, ring_bytes, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (T + plen + kTileRows - 1) / kTileRows;
  const size_t rows_bytes = (size_t)5 * (kTileRows + plen - 1) * sizeof(short);
  // shared memory up to 200 KB (a pitch line of 20225 rows); the rows in
  // device memory when the caller gives them
  if (rows == nullptr && rows_bytes > 200 * 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = rows == nullptr ? rows_bytes : 0;
  if (smem > 32 * 1024) {  // beside the 10 KB of static shared memory
    err = cudaFuncSetAttribute(echo_index, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  echo_index<<<tiles, kIndexThreads, smem, stream>>>(table, bounds, n_periods, first, count,
                                                     list, rows, T, plen, tile_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // four channels a lane where every (T, C) and (rows, C) array's rows are 16-byte pieces
  const bool vec = C % 4 == 0 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                                   reinterpret_cast<uintptr_t>(gy) |
                                   reinterpret_cast<uintptr_t>(pb_in) |
                                   reinterpret_cast<uintptr_t>(gpb_out) |
                                   reinterpret_cast<uintptr_t>(lam_a) |
                                   reinterpret_cast<uintptr_t>(lam_b) |
                                   reinterpret_cast<uintptr_t>(gline) |
                                   reinterpret_cast<uintptr_t>(gcs) |
                                   reinterpret_cast<uintptr_t>(gfb_part) |
                                   reinterpret_cast<uintptr_t>(gp_part)) & 15) == 0;
  err = vec
            ? launch_passes<4>(x, fb, y, gy, table, bounds, n_periods, lam_a, lam_b, pb_in,
                               gpb_out, gline, gcs, gfb_part, gp_part, first, count, list, T,
                               C, plen, inv_half, stream)
            : launch_passes<1>(x, fb, y, gy, table, bounds, n_periods, lam_a, lam_b, pb_in,
                               gpb_out, gline, gcs, gfb_part, gp_part, first, count, list, T,
                               C, plen, inv_half, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_channel_sum(gfb_part, gfb, T, C, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_channel_sum(gp_part, gp, T, C, stream);
  if (err != cudaSuccess) return (int)err;
  echo_ratio<<<1, kRatioLanes, 0, stream>>>(gp, gmisc, gratio, gm, T, decay);
  return (int)cudaGetLastError();
}

}  // extern "C"
