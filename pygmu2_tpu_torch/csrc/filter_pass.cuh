// The SoundFont render's segment pass, for Hopper (sm_90a): biquad + gain
// ramps + stereo mix over segments of MIDI blocks, templated on where its
// input samples come from (the producer role):
//   osc_filter_gain_mix.cu  the fused pass: the wavetable oscillator formed
//                           in the kernel (OscSource)
//   filter_gain_mix.cu      the unfused pass: the oscillator's samples read
//                           from memory, a (T, P) plane (XtSource)
//
// What it computes, per voice p and sample n of MIDI block b (T = B * N):
//   x     the source's sample
//   y     DF1 biquad, coefficients constant within a MIDI block; a block
//         whose `freshf` is set starts a new note epoch with zero state
//   out   L/R = sum over voices of y * per-block gain ramp
// and, where the source carries it (Src::kState), the (4, P) state
// [y1; y2; x[-2]; x[-1]] from/to the caller; else zero state before block 0
// and no state out.
//
// The design: one launch, the input once per sample, the chain alone
// serial. A CUDA block takes a segment of kSeg samples of one MIDI block
// for 32 voices (a ticket from an atomic counter orders the segments, so a
// block only ever waits on blocks that started before it):
//   producers  8 warps write the segment's input samples, tile by tile of 32
//              samples x 32 voices, into a shared-memory segment (64 KB,
//              swizzled: slot()); each tile's arrival is an mbarrier.
//   chain      one warp, a voice a lane: run 1 forms the FIR line and runs
//              the feedback from zero state over the tiles as they arrive,
//              writing the FIR over the samples; it publishes the segment's
//              map s -> zs + M s (end state from zero, M = A^len), takes the
//              entering state (below), and run 2 re-runs the feedback from it
//              over the shared FIR, writing y over it, tile by tile.
//   entering   in a fixed order, so that two calls return the same bits:
//   state      segments form groups of kGroup; a segment composes the maps
//              of its group's earlier segments (the producer warps load and
//              compose them 4 at a time, the chain lane composes the 8
//              results) and applies them to the group's entering state,
//              which the group before publishes from its last segment. A
//              fresh block's map is constant, so a reset ends the wait.
//   mix        the producer warps apply the gain ramps to each tile of y as
//              run 2 releases it and sum the 32 voices with 9 shuffles a
//              lane (a reduce-scatter: each sum a butterfly's pairwise
//              tree); with more than 32 voices, each block of voices writes
//              its partial mix to global memory and the last to finish sums
//              the partials in voice-group order.
// soundfont/filter_kernels.osc_filter_gain_mix_cut and filter_gain_mix_cut
// compute in this order in torch ops.
//
// A source Src provides: kState; kArrivals, the producer threads that
// arrive on each tile's `full` barrier; filter_rows(plane), the 10 (B, P)
// planes of FilterRow; sample(plane, b, p, P, N, n), sample n of block b of
// voice p; ramp(n, N), the gain ramps' position; and a Producer, built by
// each producer thread, whose produce() writes the segment's tiles and
// arrives on their barriers.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "staged_ring.cuh"

namespace {

constexpr float kNonAudible = 1.0e-3f;  // params.NON_AUDIBLE

// The filter and gain rows, (B, P) planes in this order; must match
// filter_kernels._FILTER_ROWS.
enum FilterRow { B0, B1, B2, A1, A2, FRESHF, PGL, GL, PGR, GR };

// Must match filter_kernels.OSC_SEG, OSC_VOICES, OSC_GROUP.
constexpr int kSeg = 512;     // samples of a MIDI block per CUDA block
constexpr int kV = 32;        // voices per CUDA block: the chain warp's lanes
constexpr int kGroup = 32;    // segments per group of the entering states
constexpr int kTileLen = 32;  // samples per produced and released tile
constexpr int kQuads = kSeg / 4;
constexpr int kTiles = kSeg / kTileLen;
constexpr int kProducers = 8;  // warps; a tile is kTileLen / 4 quads, one a warp
constexpr int kThreads = (kProducers + 1) * 32;
constexpr int kSlot = kGroup / kProducers;  // earlier segments a producer warp composes
static_assert(kTileLen / 4 == kProducers, "one quad of a tile per producer warp");

// An affine map of the biquad's output state s = (y[n-1], y[n-2]):
// s -> z + m s.
struct Map {
  float z1, z2, m11, m12, m21, m22;
};

__device__ __forceinline__ Map identity() { return Map{0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 1.0f}; }

// g after f: s -> g.z + g.m (f.z + f.m s)
__device__ __forceinline__ Map then(const Map& f, const Map& g) {
  return Map{fmaf(g.m12, f.z2, fmaf(g.m11, f.z1, g.z1)),
             fmaf(g.m22, f.z2, fmaf(g.m21, f.z1, g.z2)),
             fmaf(g.m12, f.m21, g.m11 * f.m11), fmaf(g.m12, f.m22, g.m11 * f.m12),
             fmaf(g.m22, f.m21, g.m21 * f.m11), fmaf(g.m22, f.m22, g.m21 * f.m12)};
}

__device__ __forceinline__ void apply(const Map& f, float& s1, float& s2) {
  const float n1 = fmaf(f.m12, s2, fmaf(f.m11, s1, f.z1));
  s2 = fmaf(f.m22, s2, fmaf(f.m21, s1, f.z2));
  s1 = n1;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void wait_flag(const int* p) {
  while (load_acquire(p) == 0) __nanosleep(64);
}

// The scratch of one launch, carved from two buffers (sizes:
// filter_kernels._osc_scratch_sizes). Floats: each segment's map per voice
// (8 floats: z1 z2 m11 m12 | m21 m22 - -), each group's entering state per
// voice (2), each segment's partial mix per block of voices (kSeg x 2).
// Ints, zeroed before the launch: the ticket, a count of the finished
// blocks of voices per segment, the maps' and entering states' flags.
struct Work {
  float4* agg;
  float2* gin;
  float* part;
  int *ticket, *count, *aflag, *gflag;
};

// Where quad q (samples 4q .. 4q + 3) of voice p lies in Smem::buf: row q,
// the voices swizzled so that a warp's 8 quads of 4 voices (the producers)
// and its 32 voices of one quad (the chain, the mix) each meet every bank.
__device__ __forceinline__ int slot(int q, int p) { return q * kV + (p ^ (q & (kV - 1))); }

struct Smem {
  float4 buf[kQuads * kV];  // x, then the FIR line, then y: at slot(q, p)
  float maps[kProducers][6][kV];
  float tail[2][kV];        // x[-2], x[-1] of each voice before the segment
  float ramp[kSeg];         // the gain ramps' n / N
  uint64_t full[kTiles], ydone[kTiles];
  int ticket, last;
};

template <typename Src>
__global__ void __launch_bounds__(kThreads, 3)
    filter_pass(Src src, const float* __restrict__ state_in, float* __restrict__ out,
                float* __restrict__ state_out, Work sc, int B, int P, int N, int S, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    sm.ticket = atomicAdd(sc.ticket, 1);
    for (int t = 0; t < kTiles; ++t) {
      mbar_init(&sm.full[t], Src::kArrivals);
      mbar_init(&sm.ydone[t], 32);
    }
  }
  __syncthreads();
  const long plane = (long)B * P;
  const float* fr = src.filter_rows(plane);
  const int nseg = B * S;
  const int seg = sm.ticket / G, g = sm.ticket % G;
  const int b = seg / S, n0 = (seg % S) * kSeg;
  const int len = min(kSeg, N - n0);
  const int nq = (len + 3) / 4, ntiles = (len + kTileLen - 1) / kTileLen;
  const int p = g * kV + lane;
  const bool voice = p < P;
  const long idx = (long)b * P + p;
  const bool fresh = voice && n0 == 0 && fr[FRESHF * plane + idx] > 0.5f;
  const int group = seg / kGroup, first = group * kGroup;

  if (warp < kProducers) {
    // ---- producers: the segment's input samples, tile by tile (the
    // source's role: Src::Producer) ----
    const typename Src::Producer prod(src, plane, b, g, P, N, warp, lane);
    if (warp == 0) {  // the FIR inputs before the segment, voice p a lane
      float xm2 = 0.0f, xm1 = 0.0f;
      if (voice && !fresh) {
        if (n0 > 0) {
          xm2 = src.sample(plane, b, p, P, N, n0 - 2), xm1 = src.sample(plane, b, p, P, N, n0 - 1);
        } else if (b > 0) {
          xm2 = src.sample(plane, b - 1, p, P, N, N - 2);
          xm1 = src.sample(plane, b - 1, p, P, N, N - 1);
        } else if (Src::kState) {
          xm2 = state_in[2 * P + p], xm1 = state_in[3 * P + p];
        }
      }
      sm.tail[0][lane] = xm2;
      sm.tail[1][lane] = xm1;
    }
    for (int i = tid; i < len; i += kProducers * 32)  // the gain ramps' n / N
      sm.ramp[i] = Src::ramp(n0 + i, N);
    prod.produce(sm.buf, sm.full, n0, len, nq, ntiles);

    // ---- the maps of the group's earlier segments, kSlot a warp ----
    Map f = identity();
    for (int i = 0; i < kSlot; ++i) {
      const int k = first + warp * kSlot + i;
      if (k >= seg || !voice) break;
      wait_flag(sc.aflag + (long)k * P + p);
      const float4 a = __ldcg(sc.agg + 2 * ((long)k * P + p));
      const float4 m = __ldcg(sc.agg + 2 * ((long)k * P + p) + 1);
      f = then(f, Map{a.x, a.y, a.z, a.w, m.x, m.y});
    }
    const float fm[6] = {f.z1, f.z2, f.m11, f.m12, f.m21, f.m22};
#pragma unroll
    for (int e = 0; e < 6; ++e) sm.maps[warp][e][lane] = fm[e];
    asm volatile("bar.sync 1, %0;" ::"n"(kThreads));

    // ---- the mix: gain ramps on each tile of y, summed over the voices;
    // a warp takes a quad of the tile, a lane a voice ----
    // gain_at per voice: prev + (cur - prev) * ramp, or constant (cur, or 0
    // when inaudible)
    float pgl = 0.0f, gl = 0.0f, pgr = 0.0f, gr = 0.0f;
    if (voice) {
      pgl = fr[PGL * plane + idx], gl = fr[GL * plane + idx];
      pgr = fr[PGR * plane + idx], gr = fr[GR * plane + idx];
    }
    const bool quiet_l = fmaxf(pgl, gl) < kNonAudible, quiet_r = fmaxf(pgr, gr) < kNonAudible;
    const float dl = __fsub_rn(gl, pgl), dr = __fsub_rn(gr, pgr);
    const bool flat_l = quiet_l || fabsf(dl) < 1.0e-3f, flat_r = quiet_r || fabsf(dr) < 1.0e-3f;
    const float kl = quiet_l ? 0.0f : gl, kr = quiet_r ? 0.0f : gr;
    float* dst = G == 1 ? out + ((long)b * N + n0) * 2
                        : sc.part + ((long)seg * G + g) * (2 * kSeg);
    for (int t = 0; t < ntiles; ++t) {
      const int q = t * kProducers + warp;
      mbar_wait(&sm.ydone[t], 0);
      if (q >= nq) continue;  // a whole warp
      const float4 y4 = sm.buf[slot(q, lane)];
      const float4 r4 = *reinterpret_cast<const float4*>(sm.ramp + 4 * q);
      const float y[4] = {y4.x, y4.y, y4.z, y4.w}, ramp[4] = {r4.x, r4.y, r4.z, r4.w};
      float v[8];  // sample c's left at 2c, right at 2c + 1: the output's order
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool live = voice && 4 * q + c < len;
        const float gl_c = flat_l ? kl : __fadd_rn(pgl, __fmul_rn(dl, ramp[c]));
        const float gr_c = flat_r ? kr : __fadd_rn(pgr, __fmul_rn(dr, ramp[c]));
        v[2 * c] = live ? __fmul_rn(gl_c, y[c]) : 0.0f;
        v[2 * c + 1] = live ? __fmul_rn(gr_c, y[c]) : 0.0f;
      }
      // the sums over the 32 lanes, scattered: each step halves the values
      // a lane keeps (xor distances 16, 8, 4), then two plain steps (2, 1);
      // each sum is the pairwise tree of a butterfly. Lane 4i holds v[i]'s.
      const unsigned all = 0xffffffffu;
      float w4[4], w2[2];
      const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w4[j] = __fadd_rn(h4 ? v[4 + j] : v[j], __shfl_xor_sync(all, h4 ? v[j] : v[4 + j], 16));
#pragma unroll
      for (int j = 0; j < 2; ++j)
        w2[j] = __fadd_rn(h3 ? w4[2 + j] : w4[j], __shfl_xor_sync(all, h3 ? w4[j] : w4[2 + j], 8));
      float w = __fadd_rn(h2 ? w2[1] : w2[0], __shfl_xor_sync(all, h2 ? w2[0] : w2[1], 4));
      w = __fadd_rn(w, __shfl_xor_sync(all, w, 2));
      w = __fadd_rn(w, __shfl_xor_sync(all, w, 1));
      const int i = lane >> 2;
      if ((lane & 3) == 0 && 4 * q + (i >> 1) < len) dst[8 * q + i] = w;
    }
  } else {
    // ---- the chain: one voice a lane ----
    float b0 = 0, b1 = 0, b2 = 0, a1 = 0, a2 = 0;
    if (voice) {
      b0 = fr[B0 * plane + idx], b1 = fr[B1 * plane + idx], b2 = fr[B2 * plane + idx];
      a1 = fr[A1 * plane + idx], a2 = fr[A2 * plane + idx];
    }
    const float na1 = -a1, na2 = -a2;
    float x1 = 0, x2 = 0, y1 = 0.0f, y2 = 0.0f;
    // run 1: the FIR line, and the feedback from zero state
    auto fir_quad = [&](float4& v, int count) {
      float x[4] = {v.x, v.y, v.z, v.w}, fir[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= count) {
          fir[c] = 0.0f;
          continue;
        }
        fir[c] = fmaf(b2, x2, fmaf(b1, x1, b0 * x[c]));
        const float y = fmaf(na1, y1, fmaf(na2, y2, fir[c]));
        x2 = x1, x1 = x[c], y2 = y1, y1 = y;
      }
      v = make_float4(fir[0], fir[1], fir[2], fir[3]);
    };
    // run 2: the feedback from the entering state over the FIR line
    auto y_quad = [&](float4& v, int count) {
      float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= count) break;
        const float y = fmaf(na1, y1, fmaf(na2, y2, f[c]));
        f[c] = y, y2 = y1, y1 = y;
      }
      v = make_float4(f[0], f[1], f[2], f[3]);
    };
    auto walk = [&](auto quad, bool run2) {
      for (int t = 0; t < ntiles; ++t) {
        if (!run2) mbar_wait(&sm.full[t], 0);
        if ((t + 1) * kTileLen <= len) {
          // quad 8t + i of voice `lane` at 32 (8t + i) + (lane ^ (8t + i) % 32)
          float4* v = sm.buf + t * kProducers * kV;
          const int sw = lane ^ (t * kProducers & (kV - 1));
          float4 r[kProducers];
#pragma unroll
          for (int i = 0; i < kProducers; ++i) r[i] = v[i * kV + (sw ^ i)];
#pragma unroll
          for (int i = 0; i < kProducers; ++i) {
            quad(r[i], 4);
            v[i * kV + (sw ^ i)] = r[i];
          }
        } else {  // the segment's last, part tile
          for (int q = t * kProducers; q < nq; ++q) {
            float4 r = sm.buf[slot(q, lane)];
            quad(r, min(4, len - 4 * q));
            sm.buf[slot(q, lane)] = r;
          }
        }
        if (run2) mbar_arrive(&sm.ydone[t]);
      }
    };
    mbar_wait(&sm.full[0], 0);  // the tail: written before producer warp 0's first arrival
    x2 = sm.tail[0][lane];
    x1 = sm.tail[1][lane];
    walk(fir_quad, false);

    // the segment's map: zs + M s, M = A^len for A = [[-a1, -a2], [1, 0]];
    // a fresh block's first segment forgets its entering state (M = 0)
    Map own{y1, y2, 0.0f, 0.0f, 0.0f, 0.0f};
    if (!fresh) {
      float r11 = 1.0f, r12 = 0.0f, r21 = 0.0f, r22 = 1.0f;
      float p11 = na1, p12 = na2, p21 = 1.0f, p22 = 0.0f;
      for (int e = len; e > 0; e >>= 1) {
        if (e & 1) {
          const float t11 = fmaf(r12, p21, r11 * p11), t12 = fmaf(r12, p22, r11 * p12);
          const float t21 = fmaf(r22, p21, r21 * p11), t22 = fmaf(r22, p22, r21 * p12);
          r11 = t11, r12 = t12, r21 = t21, r22 = t22;
        }
        const float s11 = fmaf(p12, p21, p11 * p11), s12 = fmaf(p12, p22, p11 * p12);
        const float s21 = fmaf(p22, p21, p21 * p11), s22 = fmaf(p22, p22, p21 * p12);
        p11 = s11, p12 = s12, p21 = s21, p22 = s22;
      }
      own.m11 = r11, own.m12 = r12, own.m21 = r21, own.m22 = r22;
    }
    if (voice && seg + 1 < nseg && (seg + 1) % kGroup != 0) {  // a later segment of the group reads it
      sc.agg[2 * ((long)seg * P + p)] = make_float4(own.z1, own.z2, own.m11, own.m12);
      sc.agg[2 * ((long)seg * P + p) + 1] = make_float4(own.m21, own.m22, 0.0f, 0.0f);
      store_release(sc.aflag + (long)seg * P + p, 1);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kThreads));

    // the entering state: the group's earlier maps on the group's entering state
    float s1 = 0.0f, s2 = 0.0f;
    if (voice && !fresh) {
      Map f = identity();
      for (int w = 0; w < kProducers && first + w * kSlot < seg; ++w)
        f = then(f, Map{sm.maps[w][0][lane], sm.maps[w][1][lane], sm.maps[w][2][lane],
                        sm.maps[w][3][lane], sm.maps[w][4][lane], sm.maps[w][5][lane]});
      if (f.m11 == 0.0f && f.m12 == 0.0f && f.m21 == 0.0f && f.m22 == 0.0f) {
        s1 = f.z1, s2 = f.z2;  // a reset in the group: no earlier state needed
      } else {
        float g1, g2;
        if (group == 0) {
          g1 = Src::kState ? state_in[p] : 0.0f, g2 = Src::kState ? state_in[P + p] : 0.0f;
        } else {
          wait_flag(sc.gflag + (long)group * P + p);
          const float2 gs = __ldcg(sc.gin + (long)group * P + p);
          g1 = gs.x, g2 = gs.y;
        }
        s1 = g1, s2 = g2;
        apply(f, s1, s2);
      }
    }
    if (voice && (seg + 1) % kGroup == 0 && seg + 1 < nseg) {  // the next group's entering state
      float e1 = s1, e2 = s2;
      apply(own, e1, e2);
      sc.gin[(long)(group + 1) * P + p] = make_float2(e1, e2);
      store_release(sc.gflag + (long)(group + 1) * P + p, 1);
    }
    y1 = s1, y2 = s2;
    walk(y_quad, true);
    if (Src::kState && voice && seg == nseg - 1) {
      state_out[p] = y1;
      state_out[P + p] = y2;
      state_out[2 * P + p] = x2;
      state_out[3 * P + p] = x1;
    }
  }

  // ---- with more than one block of voices: the partials, in order ----
  if (G > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.last = atomicAdd(sc.count + seg, 1) == G - 1;
    __syncthreads();
    if (sm.last) {
      __threadfence();
      const float* part = sc.part + (long)seg * G * (2 * kSeg);
      float* o = out + ((long)b * N + n0) * 2;
      for (int f = tid; f < 2 * len; f += kThreads) {
        float acc = __ldcg(part + f);
        for (int h = 1; h < G; ++h) acc = __fadd_rn(acc, __ldcg(part + h * (2 * kSeg) + f));
        o[f] = acc;
      }
    }
  }
}


// Enqueues the pass on `stream`: a memset of the int scratch, then the
// kernel; returns the cudaError_t of the first step that failed (0 when both
// were accepted). scratch_f / scratch_i: n_f floats and n_i ints, at least
// filter_kernels._osc_scratch_sizes. Needs N >= 2, P >= 1, B >= 1.
template <typename Src>
int launch_filter_pass(const Src& src, const float* state_in, float* out, float* state_out,
                       float* scratch_f, long long n_f, int* scratch_i, long long n_i, int B,
                       int P, int N, cudaStream_t stream) {
  const int S = (N + kSeg - 1) / kSeg, G = (P + kV - 1) / kV;
  const long long nseg = (long long)B * S, groups = (nseg + kGroup - 1) / kGroup;
  const long long need_f = nseg * P * 8 + groups * P * 2 + (G > 1 ? nseg * G * 2 * kSeg : 0);
  const long long need_i = 1 + nseg + nseg * P + groups * P;
  if (N < 2 || P < 1 || B < 1 || n_f < need_f || n_i < need_i)
    return (int)cudaErrorInvalidValue;
  Work sc;
  sc.agg = reinterpret_cast<float4*>(scratch_f);
  sc.gin = reinterpret_cast<float2*>(scratch_f + nseg * P * 8);
  sc.part = scratch_f + nseg * P * 8 + groups * P * 2;
  sc.ticket = scratch_i;
  sc.count = scratch_i + 1;
  sc.aflag = scratch_i + 1 + nseg;
  sc.gflag = scratch_i + 1 + nseg + nseg * P;
  cudaError_t err = cudaMemsetAsync(scratch_i, 0, sizeof(int) * need_i, stream);
  if (err != cudaSuccess) return (int)err;
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(filter_pass<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  filter_pass<Src><<<(unsigned)(nseg * G), kThreads, sizeof(Smem), stream>>>(
      src, state_in, out, state_out, sc, B, P, N, S, G);
  return (int)cudaGetLastError();
}

}  // namespace
