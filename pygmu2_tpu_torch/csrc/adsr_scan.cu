// Gated / triggered ADSR state machine, serial in time, for Hopper (sm_90a).
//
// Replaces the TPU kernel pygmu2_tpu/ops/adsr_pallas.py:adsr_scan_pallas
// (:268), which broadcasts the scalar machine across 128 lanes (a tiling
// need of the TPU, not of the machine) over a sequential grid of chunks.
//
// What it computes (the op order of adsr_scan_ref, float32): per sample,
// emit env = e0 + n * slope of the current stage (0 when IDLE, sus when
// SUSTAIN); then a gate edge (gated: 0->1 attack, 1->0 release; triggered:
// g > 0 attack) restarts the segment from the emitted value; then one
// linear-segment step whose clip crossing (attack >= 1, decay <= sus,
// release <= 0) or sustain expiry (triggered: n + 1 >= sustain_samples)
// moves to the next stage. The (4,) state is [stage, e0, n, prev_gate].
//
// What bounds it on this card: the dependent chain. At the main path's
// block (T = 16384) it moves 128 KB (roofline 0.04 us at 3.35 TB/s) and
// does 30 ops per sample; every sample's stage, e0 and n depend on the
// previous sample's through ~14 dependent float ops and selects (~55
// cycles): a serial floor of ~0.46 ms per 16384 samples at 1.98 GHz.
// Measured on an H100 SXM (700 W): 1.2 ms.
//
// What the design does about it: one thread, the state in registers, the
// gate read with loads the compiler can issue ahead of the chain. The
// candidate envelope that decides a transition uses explicitly rounded
// float ops (__fmul_rn, __fadd_rn): a contracted FMA could move a
// transition by a sample against the plain PyTorch version.
//
// A second kernel, adsr_clock, runs the triggered machine where a float32
// sustain count cannot (a sustain of 0 samples, or 2**24 - 1 and more):
// the JAX AdsrTriggeredPE's lax.scan branch (pygmu2_tpu/models/
// envelopes.py:420-435). Per sample it outputs the envelope before the
// update; a trigger restarts the attack from the current value; one
// linear step in float64 (attack clips at 1, decay at sus, release at 0);
// entering SUSTAIN from DECAY arms an absolute deadline, now +
// sustain_samples, in int64 samples; SUSTAIN at now >= deadline becomes
// RELEASE. One thread, float64 state in registers (the card's float64
// adds are exact IEEE operations, as the plain version's Python floats).

#include <cuda_runtime.h>

namespace {

constexpr float kIdle = 0.0f, kAttack = 1.0f, kDecay = 2.0f, kSustain = 3.0f,
                kRelease = 4.0f;

__global__ void adsr_scan(const float* __restrict__ gate,
                          const float* __restrict__ state_in,
                          float* __restrict__ env_out,
                          float* __restrict__ state_out, int T, float dA,
                          float dD, float dR, float sus, int sustain_samples) {
  const bool gated = sustain_samples < 0;
  const float S = (float)sustain_samples;
  float stage = state_in[0], e0 = state_in[1], n = state_in[2],
        pg = state_in[3];
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const float g = gate[t];
    const float d = stage == kAttack ? dA : (stage == kDecay ? dD : dR);
    const float env = stage == kIdle
                          ? 0.0f
                          : (stage == kSustain ? sus : __fadd_rn(e0, __fmul_rn(n, d)));
    env_out[t] = env;

    bool edge;
    if (gated) {
      const bool rising = pg == 0.0f && g == 1.0f;
      const bool falling = pg == 1.0f && g == 0.0f;
      stage = rising ? kAttack : (falling ? kRelease : stage);
      edge = rising || falling;
    } else {
      edge = g > 0.0f;
      stage = edge ? kAttack : stage;
    }
    if (edge) {
      e0 = env;
      n = 0.0f;
    }

    const float d2 = stage == kAttack ? dA : (stage == kDecay ? dD : dR);
    const float n1 = __fadd_rn(n, 1.0f);
    const float cand = __fadd_rn(e0, __fmul_rn(n1, d2));
    const bool hit_a = stage == kAttack && cand >= 1.0f;
    const bool hit_d = stage == kDecay && cand <= sus;
    const bool hit_r = stage == kRelease && cand <= 0.0f;
    const bool expire = !gated && stage == kSustain && n1 >= S;
    const float stage2 =
        hit_a ? kDecay
              : (hit_d ? kSustain : (hit_r ? kIdle : (expire ? kRelease : stage)));
    e0 = hit_a ? 1.0f : ((hit_d || expire) ? sus : (hit_r ? 0.0f : e0));
    n = (hit_a || hit_d || hit_r || expire) ? 0.0f : n1;
    stage = stage2;
    pg = g;
  }
  state_out[0] = stage;
  state_out[1] = e0;
  state_out[2] = n;
  state_out[3] = pg;
}

__global__ void adsr_clock(const float* __restrict__ trig,
                           const int* __restrict__ stage_in,
                           const double* __restrict__ env_in,
                           const long long* __restrict__ ends_in,
                           float* __restrict__ y, int* __restrict__ stage_out,
                           double* __restrict__ env_out,
                           long long* __restrict__ ends_out, int T, long long t0,
                           double dA, double dD, double dR, double sus,
                           long long sustain_samples) {
  enum { kI = 0, kA = 1, kD = 2, kS = 3, kR = 4 };
  int stage = *stage_in;
  double env = *env_in;
  long long ends = *ends_in;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const long long now = t0 + t;
    y[t] = __double2float_rn(env);
    if (trig[t] > 0.0f) stage = kA;
    double env2 = env;
    int stage2 = stage;
    if (stage == kI) {
      env2 = 0.0;
    } else if (stage == kA) {
      env2 = __dadd_rn(env, dA);
      if (env2 >= 1.0) { env2 = 1.0; stage2 = kD; }
    } else if (stage == kD) {
      env2 = __dadd_rn(env, dD);
      if (env2 <= sus) { env2 = sus; stage2 = kS; }
    } else if (stage == kS) {
      env2 = sus;
    } else {
      env2 = __dadd_rn(env, dR);
      if (env2 <= 0.0) { env2 = 0.0; stage2 = kI; }
    }
    if (stage == kD && stage2 == kS) ends = now + sustain_samples;
    if (stage2 == kS && now >= ends) stage2 = kR;
    stage = stage2;
    env = env2;
  }
  *stage_out = stage;
  *env_out = env;
  *ends_out = ends;
}

}  // namespace

extern "C" {

// Enqueues one launch (one thread) on `stream`; returns its cudaError_t
// (0 when accepted). Device pointers: gate / env (T,) f32, state_in /
// state_out (4,) f32. sustain_samples < 0 selects the gated machine.
int adsr_scan_launch(const float* gate, const float* state_in, float* env,
                     float* state_out, int T, float dA, float dD, float dR,
                     float sus, int sustain_samples, cudaStream_t stream) {
  adsr_scan<<<1, 1, 0, stream>>>(gate, state_in, env, state_out, T, dA, dD, dR,
                                 sus, sustain_samples);
  return (int)cudaGetLastError();
}

// Enqueues one launch of the absolute-clock machine (one thread); returns
// its cudaError_t. Device pointers: trig / y (T,) f32, stage () i32, env
// () f64, ends () i64, in and out. t0: the absolute index of trig[0].
int adsr_clock_launch(const float* trig, const int* stage_in,
                      const double* env_in, const long long* ends_in, float* y,
                      int* stage_out, double* env_out, long long* ends_out,
                      int T, long long t0, double dA, double dD, double dR,
                      double sus, long long sustain_samples,
                      cudaStream_t stream) {
  adsr_clock<<<1, 1, 0, stream>>>(trig, stage_in, env_in, ends_in, y, stage_out,
                                  env_out, ends_out, T, t0, dA, dD, dR, sus,
                                  sustain_samples);
  return (int)cudaGetLastError();
}

}  // extern "C"
