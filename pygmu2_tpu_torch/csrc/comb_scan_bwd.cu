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
// Design (the first design reran the control pass on one thread and
// walked G serially through device memory on one thread a channel: 5.1 ms
// at T = 16384, C = 1 on an H100 80GB HBM3 at 700 W). The forward's control results are residuals (the
// delay table, its greedy windows, the smoothed values), so no control
// pass runs here. Three launches on the caller's stream:
// 1. the smoother's adjoint, a first-order linear recurrence in reverse
//    (coefficient 1 - alpha, or 0 where the select took f): order1_grid.cuh's
//    adjoint at one channel (256-sample chunks over the card, a memset of
//    its flags and one launch), gfreq and gsf_in; its x operand null (the
//    coefficient is chosen by the smoothed value before alone) and its g
//    null (the template's all-zero case: the only cotangent is gsf's);
// 2. comb_bwd_windows, one CUDA block per group of up to 8 channels, 1024
//    threads along time and channel: the forward's windows walked from the
//    last. A forward window has no sample that reads a row the window
//    writes, so in reverse no sample of a window adds into a row of the
//    same window: when the walk reaches a window, all of its rows' G are
//    complete, and all its samples and channels run at once (gx = G,
//    gfb's part = G * value, G[src] += fb * G). Where the delay steps up,
//    samples of a window read one row; such runs of equal t - delay_t are
//    added by one thread, the last sample first, so every row takes its
//    additions in decreasing t, the serial walk's order. A window whose
//    t - delay_t falls somewhere (the delay jumping up by two or more), or
//    shorter than 8 samples (at delay 1 every window is one sample), is
//    walked by one thread a channel, with no barrier inside a run of such
//    windows. G's live rows sit in a ring of 2L rows per channel in shared
//    memory (a window is at most L - 1 samples long and reads at most
//    L - 1 rows back, so 2L rows are never both live); when a thread reads
//    a row's final G, it writes into the row's slot the initial value of
//    the row 2L below, which takes the slot next. Past the shared memory
//    (2L rows of one channel above 227 KB, L > 29056) the ring is in
//    device memory.
// 3. channel_sum (channel_sum.cuh) adds gfb's parts over the channels in
//    channel order.
// Every op is rounded once and no float atomics: two launches give the
// same bits, and the kernel equals ops/comb.comb_scan_bwd_windows (the
// same order in torch ops) bit for bit.
//
// What bounds it on this card: the windows in turn, one barrier and a few
// dependent loads (delay, then the delayed value) each: ~80 windows at
// T = 16384 for a 200-240 Hz sweep at 44.1 kHz. Bytes: y, gy and gx, the
// ring's cotangents, the parts, the delays and windows, ~0.33 MB at
// T = 16384, C = 1.
//
// Measured (chip_smoke.py phase 15, H100 80GB HBM3, 700 W; the launches
// alone by torch.profiler): 0.122 ms at T = 16384, C = 1 (the window walk
// 0.101 of it, the smoother's adjoint 0.020 when it ran the first
// design's one CUDA block), 0.299-0.306 ms at C = 128, 0.018 ms at
// T = 1024. With the smoother on order1_grid.cuh (kernel_times.py, the
// same card): 0.1431-0.1433 -> 0.1297 ms at T = 16384, C = 1, L = 2206,
// the smoother 0.0196 -> 0.0061-0.0062 of it.

#include <cuda_runtime.h>

#include "channel_sum.cuh"
#include "order1_grid.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kGroup = 8;        // channels per CUDA block of the walk
constexpr int kMinParallel = 8;  // shorter windows: one thread per channel
constexpr int kMaxShared = 232448;

// the smoother's coefficient: 1 where the select took f (its entering value
// negative), else alpha
struct Smoother {
  float alpha;
  __device__ __forceinline__ float k(float, float prev) const {
    return prev < 0.0f ? 1.0f : alpha;
  }
};

__global__ void __launch_bounds__(kThreads) comb_bwd_windows(
    const float* __restrict__ fb, const float* __restrict__ buf_in, const int* __restrict__ pos_in,
    const float* __restrict__ y, const float* __restrict__ gy, const float* __restrict__ gbuf,
    const int* __restrict__ delay, const int* __restrict__ bounds,
    const int* __restrict__ n_windows, float* __restrict__ gx, float* __restrict__ gbuf_in,
    float* __restrict__ part, float* ring_global, int T, int C, int L) {
  extern __shared__ float s_ring[];
  const int W = blockDim.x, lanes = blockDim.y, tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * W + tx;
  const bool live = c < C;
  const int R = 2 * L;
  float* ring = ring_global != nullptr ? ring_global + (long)blockIdx.x * R * W : s_ring;
  const int p0 = *pos_in, nw = *n_windows;
  auto slot = [&](int q) -> float& { return ring[(q % R) * W + tx]; };
  auto init = [&](int q) {  // tape row q's cotangent before the walk
    float v = q >= L ? gy[(long)(q - L) * C + c] : 0.0f;
    if (q >= T) v = __fadd_rn(v, gbuf[(long)((p0 + q) % L) * C + c]);
    return v;
  };
  // sample t: its row's cotangent out to gx and the part, its slot handed
  // to the row 2L below, fb * G added into the row it read
  auto sample = [&](int t) {
    const int r = L + t, m = t - delay[t];
    const float g = slot(r);
    const float v = m >= 0 ? y[(long)m * C + c] : buf_in[(long)((p0 + L + m) % L) * C + c];
    gx[(long)t * C + c] = g;
    part[(long)t * C + c] = __fmul_rn(g, v);
    if (r >= R) slot(r) = init(r - R);
    float& s = slot(L + m);
    s = __fadd_rn(s, __fmul_rn(fb[t], g));
  };

  if (live)
    for (int q = max(L + T - R, 0) + ty; q < L + T; q += lanes) slot(q) = init(q);
  __syncthreads();
  bool dirty = false;  // a parallel window wrote since the last barrier
  for (int k = nw - 1; k >= 0; --k) {
    const int a = bounds[k], b = bounds[k + 1];
    bool parallel = false;
    if (b - a >= kMinParallel) {  // the same branch for the whole block
      int falls = 0;  // t - delay_t falls somewhere in the window
      for (int t = a + ty; t + 1 < b; t += lanes) falls |= t + 1 - delay[t + 1] < t - delay[t];
      parallel = !__syncthreads_or(falls);  // also: the later windows' adds are done
      dirty = false;
    }
    if (parallel) {
      if (live)
        for (int t = a + ty; t < b; t += lanes) {
          const int reads = t - delay[t];
          if (t + 1 < b && t + 1 - delay[t + 1] == reads) continue;  // not its run's last
          for (int u = t; u >= a && u - delay[u] == reads; --u) sample(u);
        }
      dirty = true;
    } else {
      if (dirty) __syncthreads();
      dirty = false;
      if (live && ty == 0)
        for (int t = b - 1; t >= a; --t) sample(t);
    }
  }
  __syncthreads();
  if (live)
    for (int q = ty; q < L; q += lanes) gbuf_in[(long)((p0 + q) % L) * C + c] = slot(q);
}

}  // namespace

extern "C" {

// Enqueues the smoother's adjoint (a memset and a launch), the window walk
// and the channel sum on `stream`; returns the first cudaError_t (0 when
// all were accepted). Device pointers: fb / gfreq / gfb (T,) f32; buf_in /
// gbuf / gbuf_in (L, C) f32; pos_in () i32; sf_in / gsf / gsf_in () f32;
// y / gy / gx (T, C) f32; the forward's residuals delay (T,) i32, bounds
// (T + 1,) i32, n_windows (1,) i32, smoothed (T,) f32; scratch part (T, C)
// f32, where 2L floats exceed the shared memory ring (C, 2L) f32 (else
// null), and the smoother's agg (2, ceil(T / 256)) f32 and flags
// 1 + ceil(T / 256) int32. Needs L >= 2.
int comb_scan_bwd_launch(const float* fb, const float* buf_in, const int* pos_in,
                         const float* sf_in, const float* y, const float* gy, const float* gbuf,
                         const float* gsf, const int* delay, const int* bounds,
                         const int* n_windows, const float* smoothed, float* gx, float* gfreq,
                         float* gfb, float* gbuf_in, float* gsf_in, float* part, float* ring,
                         float* agg, int* flags, int T, int C, int L, float smooth_alpha,
                         cudaStream_t stream) {
  if (T < 1 || C < 1 || L < 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = order1_grid::launch(Smoother{smooth_alpha}, nullptr, smoothed, sf_in, nullptr,
                                        gsf, gfreq, gsf_in, agg, flags, T, 1, stream);
  if (err != cudaSuccess) return (int)err;
  int width = C < kGroup ? C : kGroup;
  auto ring_bytes = [&](int w) { return 2 * (long)L * w * (long)sizeof(float); };
  while (width > 1 && ring_bytes(width) > kMaxShared) width /= 2;
  const long bytes = ring_bytes(width);
  const bool in_shared = bytes <= kMaxShared;
  if (!in_shared && ring == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = in_shared ? (int)bytes : 0;
  static int allowed = 48 * 1024;  // the dynamic shared memory allowed so far
  if (smem > allowed) {
    err = cudaFuncSetAttribute(comb_bwd_windows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const dim3 threads(width, kThreads / width);
  comb_bwd_windows<<<(C + width - 1) / width, threads, smem, stream>>>(
      fb, buf_in, pos_in, y, gy, gbuf, delay, bounds, n_windows, gx, gbuf_in, part,
      in_shared ? nullptr : ring, T, C, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_channel_sum(part, gfb, T, C, stream);
}

}  // extern "C"
