// Adjoint of the gated / triggered ADSR (csrc/adsr_scan.cu, both kernels)
// for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel
// pygmu2_tpu/ops/adsr_pallas.py:adsr_scan_pallas (:268), whose custom VJP
// (:313, ops/diffable.kernel_with_scan_vjp) replays jax.vjp of the
// lax.scan reference adsr_scan_ref, and of the port's clock branch
// (adsr_clock, the JAX AdsrTriggeredPE's lax.scan, which XLA
// differentiates).
//
// What it computes. The gate and the stage enter only through compares:
// their cotangents are zero. A sample in ATTACK, DECAY or RELEASE emits
// env = fma(n, d, e0), so e0 and n of the state handed in reach it while
// they are still the ones handed in, or were carried across edges: an edge
// re-anchors e0 to the value emitted there (e0' = fma(n, d, e0), n' = 0),
// so the coefficient of e0_in stays 1 and that of n_in becomes the slope
// at the first edge. A hit (a ramp crossing its clip level), an expiry (the
// triggered sustain count), or an edge in SUSTAIN or IDLE (a constant
// value emitted) replaces e0 and n by constants: the first such sample is
// the cut, after which nothing depends on the state in. So
//   ge0_in = sum over live samples in A/D/R of g_t
//            (+ the cotangents of e0_out and env_next, if never cut),
//   gn_in  = sum over them of (a_n + d_t b_n) g_t (+ likewise),
// with (a_n, b_n) = (0, 1) before the first edge and (d_edge, 0) after.
//
// The weights are simpler than they look: a sample before the first edge
// has (a_n, b_n) = (0, 1), so its n-weight is fma(d_in, 1, 0) = d_in (the
// entering stage's slope), and every sample after it has a_n = d_in,
// b_n = 0. And every sample up to the cut emits a ramp when the entering
// stage does (an edge enters ATTACK or RELEASE), none when it does not (its
// first edge is a cut). So with S the sum of g_t over the samples up to
// and including the cut: ge0_in = S, gn_in = d_in * S when the entering
// stage ramps, else both 0. Only the cut is to be found.
//
// Design (the first design: one warp walking the call in windows of 32
// samples, ~130 ns a window, 512 windows in turn at T = 16384): every
// sample's cut test at once, over the card. One launch of a CUDA block of
// 256 threads a tile of 1024 samples (kPer = 4 consecutive samples a
// thread; a call of 16384 samples is 16 blocks; one block of a single tile
// at the ADSR probe's T = 1024, which then needs no scratch and no memset):
// 1. each block takes a ticket (its tile: the tiles in order), loads its
//    samples' gate, env and genv (16 bytes a load where aligned) and marks
//    the edges (the gate against the one before it, state_in[3] before
//    sample 0; gated 0 -> 1 rising, 1 -> 0 falling; triggered g > 0);
// 2. a block-wide max scan (warp shuffles, the warps' totals in shared
//    memory, scanned by every warp) gives each thread the tile's last edge
//    before its samples; the tile publishes its last edge (index, kind and
//    env in one 64-bit word, nonzero once written) before it waits on
//    anything;
// 3. the tiles before publish theirs the same way: the last of them enters
//    the tile. An edge sets the stage after it (ATTACK or RELEASE), e0 = env
//    at the edge and the count n1 = t - edge + 1 at each later sample; before
//    any edge, the state in's stage and e0 and n1 = min(n_in + t + 1,
//    2**24);
// 4. each sample tests the cut: the forward's rounded candidate fma(n1, d,
//    e0) against its clip level (or the triggered sustain count), and an
//    edge whose entering stage is IDLE or SUSTAIN; the test of a segment is
//    set once where it starts (Segment), so a sample costs a conversion, a
//    fused multiply-add and two compares;
// 5. the tile's first cut is a minimum (a warp's by __reduce_min_sync, then
//    the warps' in shared memory); each thread adds its genv up to its
//    warp's first cut in sample order, the warp by a tree of shuffles, the
//    warps up to the tile's cut by a tree in warp 0;
// 6. the last block to finish (a count of finished tiles) takes the first
//    cut over the tiles, the tiles' sums up to it (each thread the tiles
//    tid, tid + 256, ... in order, then the block's tree) and the call's
//    last edge (the stage out, where nothing cut).
// No float atomics: two launches give the same bits, and
// ops/adsr.adsr_scan_bwd_tiled (the same order in torch ops) equals the
// kernel bit for bit. Every tile is read, in parallel, wherever the cut
// falls: the time does not grow with the samples past it. A state not in
// the closed form (a stage that is not a code, a count that is not an
// integer in [0, 2**24]) is walked per sample by one thread with the plain
// version's ops, as in the first design.
//
// What bounds it on this card: the bytes walked to the cut (gate and genv,
// 8 bytes a sample, and env at the edges: 131 KB at T = 16384 without a
// cut, 0.04 us at 3.35 TB/s); in practice a launch and a few dependent
// steps (a tile's loads, its barriers, the look-back, the last block's).
//
// Measured (kernel_times.py, the kernel alone by torch.profiler; NVIDIA
// H100 80GB HBM3, 700 W): 0.0029 ms at T = 1024 (the first design 0.0110
// on the same gate, cut after 500 samples); 0.0070-0.0071 ms at T = 16384
// (and the memset's 0.0008) whether the cut falls after 500 samples or
// none does (the first design 0.0110 and 0.2670). One CUDA block over all
// 16384 samples (1024 threads, 16 samples each) took 0.0101 ms there,
// all of it on one SM.
//
// The clock branch (adsr_clock_bwd): the envelope is a float64 running
// sum, e' = e + slope, so g(e_in) is the sum of the output's cotangents up
// to the cut (IDLE, SUSTAIN, or a hit, whose values are constants), plus
// that of env_out if no cut. Thread 0 walks the machine to the cut (the
// forward's float64 adds, so the same hit); the block sums the cotangents.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kNMax = 1 << 24;
constexpr int kIdle = 0, kAttack = 1, kDecay = 2, kSustain = 3, kRelease = 4;
constexpr int kClockThreads = 256;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kPer = 4;                  // consecutive samples a thread
constexpr int kTile = kThreads * kPer;   // samples a tile (a CUDA block): 1024
constexpr int kNone = -1;                // no edge
constexpr int kNoCut = 0x7fffffff;       // no cut

struct Params {
  float dA, dD, dR, sus;
  int S;  // the sustain count (triggered), < 0 gated
};

__device__ __forceinline__ float slope_of(float stage, const Params& p) {
  return stage == kAttack ? p.dA : (stage == kDecay ? p.dD : p.dR);
}

__device__ __forceinline__ bool emits_ramp(float stage) {  // env = fma(n, d, e0)
  return !(stage == kIdle || stage == kSustain);
}

// a hit or an expiry at the post-step of a sample with count n1
__device__ __forceinline__ bool cut_at(float stage, float e0, float n1, const Params& p) {
  const float cand = __fmaf_rn(n1, slope_of(stage, p), e0);
  return (stage == kAttack && cand >= 1.0f) || (stage == kDecay && cand <= p.sus) ||
         (stage == kRelease && cand <= 0.0f) ||
         (p.S >= 0 && stage == kSustain && n1 >= (float)p.S);
}

// A segment's cut test, set once where it starts: sample t's count is
// n1 = min(t - base, 2**24), its candidate fma(n1, d, e0), a hit where the
// candidate reaches `level` (from below where `up`, else from above), an
// expiry where n1 reaches `limit`. Exactly cut_at's decisions; a stage that
// cannot hit (IDLE, SUSTAIN) has d = e0 = 0 under level 1.
struct Segment {
  int base;
  float d, e0, level, limit;
  bool up;
};

__device__ __forceinline__ Segment after_edge(bool rising, float env, int edge,
                                              const Params& p) {
  return Segment{edge - 1, rising ? p.dA : p.dR, env, rising ? 1.0f : 0.0f, INFINITY, rising};
}

__device__ __forceinline__ Segment of_state(float stage, float e0, float n, const Params& p) {
  const int base = -1 - (int)n;  // t - base = n + t + 1
  if (stage == kAttack) return Segment{base, p.dA, e0, 1.0f, INFINITY, true};
  if (stage == kDecay) return Segment{base, p.dD, e0, p.sus, INFINITY, false};
  if (stage == kRelease) return Segment{base, p.dR, e0, 0.0f, INFINITY, false};
  const float limit = p.S >= 0 && stage == kSustain ? (float)p.S : INFINITY;
  return Segment{base, 0.0f, 0.0f, 1.0f, limit, true};
}

__device__ __forceinline__ bool edge_of(float pg, float g, bool gated, bool* rising) {
  if (!gated) return *rising = g > 0.0f;
  *rising = pg == 0.0f && g == 1.0f;
  return *rising || (pg == 1.0f && g == 0.0f);
}

// gstate_in from the sums up to the cut: the state out's and env_next's
// cotangents added where nothing cut (live), weighted (a_n, b_n)
__device__ __forceinline__ void finish(float acc_e, float acc_n, bool live, float stage,
                                       float a_n, float b_n, const float* gstate_out,
                                       const float* genv_next, float* gstate_in,
                                       const Params& p) {
  if (live) {  // the state out (and env_next, its value) still carries the state in
    const bool ramp = emits_ramp(stage);
    const float ge = __fadd_rn(gstate_out[1], ramp ? *genv_next : 0.0f);
    const float gn =
        __fadd_rn(gstate_out[2], ramp ? __fmul_rn(slope_of(stage, p), *genv_next) : 0.0f);
    acc_e = __fadd_rn(acc_e, ge);
    acc_n = __fmaf_rn(a_n, ge, __fmaf_rn(b_n, gn, acc_n));
  }
  gstate_in[0] = 0.0f;
  gstate_in[1] = acc_e;
  gstate_in[2] = acc_n;
  gstate_in[3] = 0.0f;
}

// A state outside the closed form, per sample (one thread): the plain
// version's ops.
__device__ void walk_per_sample(const float* __restrict__ gate, const float* __restrict__ genv,
                                float stage, float e0, float n, float pg, int T, const Params& p,
                                const float* gstate_out, const float* genv_next,
                                float* gstate_in) {
  const bool gated = p.S < 0;
  float a_n = 0.0f, b_n = 1.0f, acc_e = 0.0f, acc_n = 0.0f;
  bool live = true;
  for (int t = 0; t < T; ++t) {
    const float g = gate[t];
    const float d = slope_of(stage, p);
    const float value = stage == kIdle ? 0.0f : (stage == kSustain ? p.sus : __fmaf_rn(n, d, e0));
    if (emits_ramp(stage)) {
      acc_e = __fadd_rn(acc_e, genv[t]);
      acc_n = __fmaf_rn(__fmaf_rn(d, b_n, a_n), genv[t], acc_n);
    }
    bool rising;
    if (edge_of(pg, g, gated, &rising)) {
      if (!emits_ramp(stage)) {
        live = false;
        break;
      }
      a_n = __fmaf_rn(d, b_n, a_n);
      b_n = 0.0f;
      e0 = value;
      n = 0.0f;
      stage = rising ? kAttack : kRelease;
    }
    const float n1 = __fadd_rn(n, 1.0f);
    if (cut_at(stage, e0, n1, p)) {
      live = false;
      break;
    }
    n = n1;
    pg = g;
  }
  finish(acc_e, acc_n, live, stage, a_n, b_n, gstate_out, genv_next, gstate_in, p);
}

// this thread's kPer samples from s0 (16 bytes a load where aligned); past
// T zeros
__device__ __forceinline__ void load_samples(float (&v)[kPer], const float* __restrict__ src,
                                             int s0, int T, bool vec) {
  if (vec && s0 + kPer <= T) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src + s0) + q);
      v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = s0 + i < T ? __ldg(src + s0 + i) : 0.0f;
  }
}

// A tile's last edge published in one 64-bit word, nonzero once written:
// its env's bits high, ((edge + 2) << 1 | rising) low (edge kNone for none).
__device__ __forceinline__ unsigned long long edge_word(int edge, bool rising, float env) {
  return (unsigned long long)__float_as_uint(env) << 32 |
         (unsigned)((edge + 2) << 1 | (int)rising);
}
__device__ __forceinline__ void from_word(unsigned long long w, int& edge, bool& rising,
                                          float& env) {
  edge = (int)((unsigned)w >> 1) - 2, rising = w & 1u, env = __uint_as_float(w >> 32);
}
__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ int add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// The sum of v over the block in a fixed order: each warp's 32 lanes by a
// tree of shuffles, then the warps' sums (those with keep false as 0) by a
// tree in warp 0; the result in thread 0. Needs a barrier before s_sum is
// used again.
__device__ __forceinline__ float block_sum(float v, bool keep, float* s_sum, int lane,
                                           int warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) s_sum[warp] = keep ? v : 0.0f;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_sum[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

// The edge with the larger index of (e, rise, env) and (o, o_rise, o_env).
__device__ __forceinline__ void later_edge(int& e, bool& rise, float& env, int o, bool o_rise,
                                           float o_env) {
  if (o > e) e = o, rise = o_rise, env = o_env;
}

// info[k * tiles + tile]: each tile's first cut and sum up to it
enum Info { kCut, kSum };

__global__ void __launch_bounds__(kThreads) adsr_bwd_grid(
    const float* __restrict__ gate, const float* __restrict__ state_in,
    const float* __restrict__ env, const float* __restrict__ genv,
    const float* __restrict__ gstate_out, const float* __restrict__ genv_next,
    float* __restrict__ gstate_in, int* __restrict__ flags, int* __restrict__ info, int T,
    Params p) {
  __shared__ int s_wlast[kWarps];    // each warp's last edge
  __shared__ int s_wcut[kWarps];     // each warp's first cut
  __shared__ float s_sum[kWarps];    // block_sum's
  __shared__ bool s_rise[kThreads];  // each thread's last edge: its kind
  __shared__ float s_env[kThreads];  // and the value emitted there
  __shared__ int s_tile, s_e[kWarps];
  __shared__ bool s_r[kWarps], s_final;
  __shared__ float s_v[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = gridDim.x;
  const bool gated = p.S < 0;
  const float stage_in = state_in[0], e0_in = state_in[1], n_in = state_in[2];
  const float pg0 = state_in[3];
  const bool closed = (stage_in == kIdle || stage_in == kAttack || stage_in == kDecay ||
                       stage_in == kSustain || stage_in == kRelease) &&
                      n_in == floorf(n_in) && n_in >= 0.0f && n_in <= (float)kNMax;
  if (!closed) {
    if (blockIdx.x == 0 && tid == 0)
      walk_per_sample(gate, genv, stage_in, e0_in, n_in, pg0, T, p, gstate_out, genv_next,
                      gstate_in);
    return;
  }
  const bool ramp_in = emits_ramp(stage_in);
  if (tid == 0) s_tile = tiles > 1 ? atomicAdd(flags, 1) : 0;  // the tiles in order
  __syncthreads();
  const int tile = s_tile, t0 = tile * kTile;

  // 1. this thread's samples and edges
  const int s0 = t0 + tid * kPer;
  const bool vec = ((reinterpret_cast<uintptr_t>(gate) | reinterpret_cast<uintptr_t>(env) |
                     reinterpret_cast<uintptr_t>(genv)) & 15) == 0;
  float gv[kPer], ev[kPer], gy[kPer];
  load_samples(gv, gate, s0, T, vec);
  load_samples(ev, env, s0, T, vec);
  load_samples(gy, genv, s0, T, vec);
  float pg = s0 == 0 ? pg0 : (s0 < T ? __ldg(gate + s0 - 1) : 0.0f);
  unsigned edges = 0, rises = 0;
  int mine = kNone;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    bool rising;
    if (s0 + i < T && edge_of(pg, gv[i], gated, &rising)) {
      edges |= 1u << i;
      rises |= (unsigned)rising << i;
      mine = s0 + i;
    }
    pg = gv[i];
  }
  if (mine != kNone) {
    const int i = mine - s0;
    s_rise[tid] = rises >> i & 1u;
    s_env[tid] = ev[i];
  }

  // 2. the last edge before this thread's samples in the tile: a max scan;
  // the tile's last published for the tiles after it
  int inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc = max(inc, o);
  }
  if (lane == 31) s_wlast[warp] = inc;
  __syncthreads();
  int w = lane < kWarps ? s_wlast[lane] : kNone;  // every warp scans the warps' totals
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, w, d);
    if (lane >= d) w = max(w, o);
  }
  const int before_warp = __shfl_sync(0xffffffffu, w, warp > 0 ? warp - 1 : 0);
  const int tile_last = __shfl_sync(0xffffffffu, w, 31);
  const int before_lane = __shfl_up_sync(0xffffffffu, inc, 1);
  int E = max(warp > 0 ? before_warp : kNone, lane > 0 ? before_lane : kNone);
  bool last_rise = false;  // the tile's last edge
  float last_env = 0.0f;
  if (tile_last != kNone) {
    const int owner = (tile_last - t0) / kPer;
    last_rise = s_rise[owner], last_env = s_env[owner];
  }
  unsigned long long* words =
      tiles > 1 ? reinterpret_cast<unsigned long long*>(flags + 2) : nullptr;
  if (tiles > 1 && tid == 0)
    store_release(words + tile, edge_word(tile_last, last_rise, last_env));

  // 3. the last edge of the tiles before (each published without waiting)
  int prev = kNone;
  bool prev_rise = false;
  float prev_env = 0.0f;
  if (tile > 0) {
    for (int j = tid; j < tile; j += kThreads) {
      unsigned long long word;
      while ((word = load_acquire(words + j)) == 0) __nanosleep(32);
      int e;
      bool r;
      float v;
      from_word(word, e, r, v);
      later_edge(prev, prev_rise, prev_env, e, r, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      later_edge(prev, prev_rise, prev_env, __shfl_down_sync(0xffffffffu, prev, o),
                 __shfl_down_sync(0xffffffffu, prev_rise, o),
                 __shfl_down_sync(0xffffffffu, prev_env, o));
    if (lane == 0) s_e[warp] = prev, s_r[warp] = prev_rise, s_v[warp] = prev_env;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWarps; ++k) later_edge(prev, prev_rise, prev_env, s_e[k], s_r[k], s_v[k]);
  }

  // 4. each sample's cut test, from the segment it is in: before any edge
  // the state in's, else the last edge's (an edge of this tile: its
  // owner's kind and env)
  Segment seg = of_state(stage_in, e0_in, n_in, p);
  if (E != kNone) {
    const int owner = (E - t0) / kPer;
    seg = after_edge(s_rise[owner], s_env[owner], E, p);
  } else if (prev != kNone) {
    E = prev;
    seg = after_edge(prev_rise, prev_env, prev, p);
  }
  bool seen = E != kNone;  // an edge before: its entering stage ramps
  unsigned cuts = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = s0 + i;
    if (edges >> i & 1u) {
      if (!seen && !ramp_in) cuts |= 1u << i;  // an edge in IDLE or SUSTAIN
      seen = true;
      seg = after_edge(rises >> i & 1u, ev[i], s, p);
    }
    const float n1 = fminf(__int2float_rn(s - seg.base), (float)kNMax);
    const float cand = __fmaf_rn(n1, seg.d, seg.e0);
    if ((seg.up ? cand >= seg.level : cand <= seg.level) || n1 >= seg.limit) cuts |= 1u << i;
  }
  if (T - s0 < kPer) cuts &= T - s0 > 0 ? (1u << (T - s0)) - 1u : 0u;  // past T
  const int first = cuts ? s0 + __ffs(cuts) - 1 : kNoCut;

  // 5. the tile's first cut, and its cotangents up to it: each thread's
  // samples in order up to its warp's first cut, the warps past the tile's
  // first cut left out
  const int wcut = __reduce_min_sync(0xffffffffu, first);
  if (lane == 0) s_wcut[warp] = wcut;
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (ramp_in && s0 + i < T && s0 + i <= wcut) part = __fadd_rn(part, gy[i]);
  __syncthreads();
  const int tile_cut = __reduce_min_sync(0xffffffffu, lane < kWarps ? s_wcut[lane] : kNoCut);
  const float tile_sum = block_sum(part, t0 + warp * 32 * kPer <= tile_cut, s_sum, lane, warp);

  // 6. one block ends the call: the tiles' first cuts, their sums up to
  // the first (each thread the tiles tid, tid + kThreads, ... in order,
  // then the block's tree) and their last edge
  int cut = tile_cut, last = tile_last;
  float total = tile_sum;
  if (tiles > 1) {
    if (tid == 0) {
      info[kCut * tiles + tile] = tile_cut;
      info[kSum * tiles + tile] = __float_as_int(tile_sum);
      s_final = add_acq_rel(flags + 1, 1) == tiles - 1;
    }
    __syncthreads();
    if (!s_final) return;
    __threadfence();
    cut = kNoCut;
    for (int j = tid; j < tiles; j += kThreads) cut = min(cut, __ldcg(info + kCut * tiles + j));
    cut = __reduce_min_sync(0xffffffffu, cut);
    if (lane == 0) s_wcut[warp] = cut;
    last = kNone;
    for (int j = tid; j < tiles; j += kThreads) {
      int e;
      bool r;
      float v;
      from_word(__ldcg(words + j), e, r, v);
      later_edge(last, last_rise, last_env, e, r, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      later_edge(last, last_rise, last_env, __shfl_down_sync(0xffffffffu, last, o),
                 __shfl_down_sync(0xffffffffu, last_rise, o),
                 __shfl_down_sync(0xffffffffu, last_env, o));
    if (lane == 0) s_e[warp] = last, s_r[warp] = last_rise, s_v[warp] = last_env;
    __syncthreads();
    cut = __reduce_min_sync(0xffffffffu, lane < kWarps ? s_wcut[lane] : kNoCut);
#pragma unroll
    for (int k = 0; k < kWarps; ++k) later_edge(last, last_rise, last_env, s_e[k], s_r[k], s_v[k]);
    float v = 0.0f;
    for (int j = tid; j < tiles && j * kTile <= cut; j += kThreads)
      v = __fadd_rn(v, __int_as_float(__ldcg(info + kSum * tiles + j)));
    total = block_sum(v, true, s_sum, lane, warp);
  }
  if (tid == 0) {
    // without a cut the last edge (if any) sets the stage out; n_in's
    // weight is d_in after an edge, its own (b_n = 1) before
    const float d_in = slope_of(stage_in, p);
    const bool edge = last != kNone;
    const float stage = edge ? (last_rise ? (float)kAttack : (float)kRelease) : stage_in;
    finish(ramp_in ? total : 0.0f, ramp_in ? __fmul_rn(d_in, total) : 0.0f, cut == kNoCut,
           stage, edge ? d_in : 0.0f, edge ? 0.0f : 1.0f, gstate_out, genv_next, gstate_in, p);
  }
}

__global__ void __launch_bounds__(kClockThreads) adsr_clock_bwd(
    const float* __restrict__ trig, const int* __restrict__ stage_in,
    const double* __restrict__ env_in, const float* __restrict__ gy,
    const double* __restrict__ genv_out, double* __restrict__ genv_in, int T, double dA,
    double dD, double dR, double sus) {
  __shared__ int s_cut;
  __shared__ double s_sum[kClockThreads];
  if (threadIdx.x == 0) {
    int stage = *stage_in;
    double e = *env_in;
    int t = 0;
    for (; t < T; ++t) {  // the forward's steps until e becomes a constant
      if (trig[t] > 0.0f) stage = kAttack;
      if (stage == kIdle || stage == kSustain) break;
      const double d = stage == kAttack ? dA : (stage == kDecay ? dD : dR);
      const double e2 = __dadd_rn(e, d);
      if ((stage == kAttack && e2 >= 1.0) || (stage == kDecay && e2 <= sus) ||
          (stage != kAttack && stage != kDecay && e2 <= 0.0))
        break;
      e = e2;
    }
    s_cut = t;  // samples 0 .. t (t < T) emit values that carry env_in; T: none cut
  }
  __syncthreads();
  const int last = min(s_cut, T - 1);
  double s = 0.0;
  for (int t = threadIdx.x; t <= last; t += kClockThreads) s += (double)gy[t];
  s_sum[threadIdx.x] = s;
  __syncthreads();
  for (int o = kClockThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s_sum[threadIdx.x] += s_sum[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) *genv_in = s_sum[0] + (s_cut >= T ? *genv_out : 0.0);
}

}  // namespace

extern "C" {

// Enqueues the call on `stream`: one launch of a CUDA block a tile of
// 1024 samples, after a memset of `flags` where there is more than one
// tile; returns the cudaError_t of the first step that failed (0 when all
// were accepted). Device pointers: gate / env / genv (T,) f32; state_in /
// gstate_out / gstate_in (4,) f32; genv_next () f32; scratch, where T >
// 1024 (else null): flags 2 + 2 * ceil(T / 1024) int32 (8-byte aligned:
// the ticket, the count of finished tiles, a 64-bit word a tile), info
// 2 * ceil(T / 1024) 32-bit words. sustain_samples < 0 selects the gated machine, else
// the count the forward was given.
int adsr_scan_bwd_launch(const float* gate, const float* state_in, const float* env,
                         const float* genv, const float* gstate_out, const float* genv_next,
                         float* gstate_in, int* flags, int* info, int T, float dA, float dD,
                         float dR, float sus, int sustain_samples, cudaStream_t stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (T + kTile - 1) / kTile;
  if (tiles > 1) {
    if (flags == nullptr || info == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        cudaMemsetAsync(flags, 0, sizeof(int) * (2 + 2 * (size_t)tiles), stream);
    if (err != cudaSuccess) return (int)err;
  }
  const Params p{dA, dD, dR, sus, sustain_samples};
  adsr_bwd_grid<<<tiles, kThreads, 0, stream>>>(gate, state_in, env, genv, gstate_out, genv_next,
                                                gstate_in, flags, info, T, p);
  return (int)cudaGetLastError();
}

// Enqueues the clock branch's adjoint (one block) on `stream`. Device
// pointers: trig / gy (T,) f32; stage_in () i32; env_in / genv_out /
// genv_in () f64.
int adsr_clock_bwd_launch(const float* trig, const int* stage_in, const double* env_in,
                          const float* gy, const double* genv_out, double* genv_in, int T,
                          double dA, double dD, double dR, double sus, cudaStream_t stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  adsr_clock_bwd<<<1, kClockThreads, 0, stream>>>(trig, stage_in, env_in, gy, genv_out,
                                                  genv_in, T, dA, dD, dR, sus);
  return (int)cudaGetLastError();
}

}  // extern "C"
