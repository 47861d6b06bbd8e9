// Device code of the unfused SoundFont audio pass (filter_gain_mix.cu: the
// oscillator's samples read from memory); osc_filter_gain_mix.cu takes its
// kNonAudible.
//
// The unfused pass runs a per-voice DF1 biquad whose coefficients are
// constant within a MIDI block of N samples, cut at block boundaries: a
// block's response is affine in its incoming (y1, y2), so
//   1. zero_state: one thread per (block, voice) runs the block from zero
//      y-state and records the end state and the block's transition A^N
//      (zero_state_block);
//   2. carry: one thread per voice composes the true incoming state of every
//      block, serially over B (carry_blocks);
//   3. render: one CUDA block per MIDI block, one thread per voice, re-runs
//      the block from its true state, applies the gain ramps (gain_at) and
//      reduces over voices through shared memory into L/R (mix_tile).
// The longest serial chain is N samples (plus B short steps) instead of T.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kNonAudible = 1.0e-3f;  // params.NON_AUDIBLE
constexpr int kTile = 16;               // samples per mixdown tile
constexpr int kMaxVoices = 256;         // filter_kernels._MAX_VOICES

// Scratch planes, each (B, P).
enum Scratch { TAIL2, TAIL1, ZS1, ZS2, M11, M12, M21, M22, YIN1, YIN2 };

struct Biquad {
  float b0, b1, b2, a1, a2;

  // One DF1 step: input x, state (x1, x2, y1, y2) advanced in place.
  __device__ __forceinline__ float step(float x, float& x1, float& x2,
                                        float& y1, float& y2) const {
    const float y = b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
    x2 = x1;
    x1 = x;
    y2 = y1;
    y1 = y;
    return y;
  }
};

// The coefficients of (block, voice) `idx` from five consecutive (B, P)
// planes b0, b1, b2, a1, a2 starting at `b0_plane`.
__device__ __forceinline__ Biquad load_biquad(const float* b0_plane, long plane,
                                             long idx) {
  const float* r = b0_plane + idx;
  return Biquad{r[0], r[plane], r[2 * plane], r[3 * plane], r[4 * plane]};
}

// Gain ramp within a block, as the JAX package's gain_grid / gain().
__device__ __forceinline__ float gain_at(float prev, float cur, float ramp) {
  if (fmaxf(prev, cur) < kNonAudible) return 0.0f;
  if (fabsf(__fsub_rn(cur, prev)) < 1.0e-3f) return cur;
  return __fadd_rn(prev, __fmul_rn(__fsub_rn(cur, prev), ramp));
}

// Step 1 of the cut: the block from zero y-state with FIR inputs (xm2, xm1)
// before it; `x(n)` gives sample n of the block. Writes the FIR inputs, the
// end state and A^N for A = [[-a1, -a2], [1, 0]] to the scratch planes.
template <typename Src>
__device__ __forceinline__ void zero_state_block(const Biquad& f, Src x, int N,
                                                 float xm2, float xm1,
                                                 long plane, long idx,
                                                 float* __restrict__ scratch) {
  scratch[TAIL2 * plane + idx] = xm2;
  scratch[TAIL1 * plane + idx] = xm1;
  float x1 = xm1, x2 = xm2, y1 = 0.0f, y2 = 0.0f;
  for (int n = 0; n < N; ++n) f.step(x(n), x1, x2, y1, y2);
  scratch[ZS1 * plane + idx] = y1;
  scratch[ZS2 * plane + idx] = y2;

  float r11 = 1.0f, r12 = 0.0f, r21 = 0.0f, r22 = 1.0f;
  float p11 = -f.a1, p12 = -f.a2, p21 = 1.0f, p22 = 0.0f;
  for (int e = N; e > 0; e >>= 1) {
    if (e & 1) {
      const float t11 = r11 * p11 + r12 * p21, t12 = r11 * p12 + r12 * p22;
      const float t21 = r21 * p11 + r22 * p21, t22 = r21 * p12 + r22 * p22;
      r11 = t11; r12 = t12; r21 = t21; r22 = t22;
    }
    const float s11 = p11 * p11 + p12 * p21, s12 = p11 * p12 + p12 * p22;
    const float s21 = p21 * p11 + p22 * p21, s22 = p21 * p12 + p22 * p22;
    p11 = s11; p12 = s12; p21 = s21; p22 = s22;
  }
  scratch[M11 * plane + idx] = r11;
  scratch[M12 * plane + idx] = r12;
  scratch[M21 * plane + idx] = r21;
  scratch[M22 * plane + idx] = r22;
}

// Step 2 for voice p: from (s1, s2) before block 0, the state entering each
// block (zeroed where `freshf`, a (B, P) plane, starts an epoch).
__device__ __forceinline__ void carry_blocks(const float* __restrict__ freshf,
                                             float s1, float s2, int B, int P,
                                             int p, float* __restrict__ scratch) {
  const long plane = (long)B * P;
  for (int b = 0; b < B; ++b) {
    const long idx = (long)b * P + p;
    if (freshf[idx] > 0.5f) {
      s1 = 0.0f;
      s2 = 0.0f;
    }
    scratch[YIN1 * plane + idx] = s1;
    scratch[YIN2 * plane + idx] = s2;
    const float n1 = scratch[ZS1 * plane + idx] +
                     scratch[M11 * plane + idx] * s1 +
                     scratch[M12 * plane + idx] * s2;
    const float n2 = scratch[ZS2 * plane + idx] +
                     scratch[M21 * plane + idx] * s1 +
                     scratch[M22 * plane + idx] * s2;
    s1 = n1;
    s2 = n2;
  }
}

// Step 3's reduction of one tile of `cnt` samples: one warp per output sample
// and channel, lanes striding over the voices' gained outputs in `mix`;
// writes out[(b * N + n0 + t) * 2 + c].
__device__ __forceinline__ void mix_tile(const float (&mix)[2][kTile][kMaxVoices],
                                         int cnt, int lanes, int b, int N, int n0,
                                         float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o2 = warp; o2 < 2 * cnt; o2 += lanes >> 5) {
    const int c = o2 / cnt, t = o2 % cnt;
    float s = 0.0f;
    for (int q = lane; q < lanes; q += 32) s += mix[c][t][q];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[((long)b * N + n0 + t) * 2 + c] = s;
  }
}

}  // namespace
