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
// Design: one warp walks the call in windows of 32 samples. Each lane
// tests one sample for an edge (the gate against the one before it) and,
// for the window's segment, for a hit (the forward's own rounded candidate
// fma(n + 1, d, e0)) or an expiry; a ballot finds the first event; the
// samples before it add their weighted cotangents lane by lane; an edge
// re-anchors e0 to the saved output there (the forward emitted exactly
// that value). The walk stops at the cut: the work is the live samples,
// 32 a window, not the call. A state not in the closed form (a stage that
// is not a code, a count that is not an integer in [0, 2**24]) is walked
// per sample by lane 0 with the plain version's ops. The lanes' partial
// sums are added in a fixed order.
//
// The clock branch (adsr_clock_bwd): the envelope is a float64 running
// sum, e' = e + slope, so g(e_in) is the sum of the output's cotangents up
// to the cut (IDLE, SUSTAIN, or a hit, whose values are constants), plus
// that of env_out if no cut. Thread 0 walks the machine to the cut (the
// forward's float64 adds, so the same hit); the block sums the cotangents.

#include <cuda_runtime.h>

namespace {

constexpr int kNMax = 1 << 24;
constexpr int kIdle = 0, kAttack = 1, kDecay = 2, kSustain = 3, kRelease = 4;
constexpr int kClockThreads = 256;

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

__device__ __forceinline__ bool edge_of(float pg, float g, bool gated, bool* rising) {
  if (!gated) return *rising = g > 0.0f;
  *rising = pg == 0.0f && g == 1.0f;
  return *rising || (pg == 1.0f && g == 0.0f);
}

__global__ void adsr_bwd(const float* __restrict__ gate, const float* __restrict__ state_in,
                         const float* __restrict__ env, const float* __restrict__ genv,
                         const float* __restrict__ gstate_out,
                         const float* __restrict__ genv_next, float* __restrict__ gstate_in,
                         int T, Params p) {
  const int lane = threadIdx.x;
  const bool gated = p.S < 0;
  float stage = state_in[0], e0 = state_in[1], n = state_in[2];
  const float pg0 = state_in[3];
  float a_n = 0.0f, b_n = 1.0f;  // n_in's coefficient: carried in e0, and in n
  float acc_e = 0.0f, acc_n = 0.0f;  // this lane's partial sums
  bool live = true;
  int t = 0;
  const bool closed = (stage == kIdle || stage == kAttack || stage == kDecay ||
                       stage == kSustain || stage == kRelease) &&
                      n == floorf(n) && n >= 0.0f && n <= (float)kNMax;
  if (closed) {
    while (live && t < T) {
      const int s = t + lane;
      const bool in = s < T;
      const float g = in ? gate[s] : 0.0f;
      const float pg = s == 0 ? pg0 : (in ? gate[s - 1] : 0.0f);
      bool rising;
      const bool edge = in && edge_of(pg, g, gated, &rising);
      const float n1 = fminf(n + (float)(lane + 1), (float)kNMax);
      const unsigned ev = __ballot_sync(0xffffffffu, in && (edge || cut_at(stage, e0, n1, p)));
      const int f = ev ? __ffs(ev) - 1 : min(32, T - t) - 1;  // the window's last sample
      if (lane <= f && emits_ramp(stage)) {
        const float d = slope_of(stage, p);
        acc_e = __fadd_rn(acc_e, genv[s]);
        acc_n = __fmaf_rn(__fmaf_rn(d, b_n, a_n), genv[s], acc_n);
      }
      if (ev) {  // the event at sample t + f
        const bool e_edge = __shfl_sync(0xffffffffu, edge, f);
        const bool e_rise = __shfl_sync(0xffffffffu, rising, f);
        if (e_edge && emits_ramp(stage)) {
          a_n = __fmaf_rn(slope_of(stage, p), b_n, a_n);
          b_n = 0.0f;
          e0 = env[t + f];
          stage = e_rise ? kAttack : kRelease;
          live = !cut_at(stage, e0, 1.0f, p);
          n = 1.0f;
        } else {
          live = false;  // a hit, an expiry, or an edge in SUSTAIN or IDLE
        }
      } else {
        n = fminf(n + (float)(f + 1), (float)kNMax);
      }
      t += f + 1;
    }
  } else if (lane == 0) {  // per sample, the plain version's ops
    float pg = pg0;
    for (; t < T; ++t) {
      const float g = gate[t];
      const float d = slope_of(stage, p);
      const float value = stage == kIdle ? 0.0f
                          : (stage == kSustain ? p.sus : __fmaf_rn(n, d, e0));
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
  }
  // the lanes' partial sums in lane order
  for (int o = 16; o > 0; o >>= 1) {
    acc_e = __fadd_rn(acc_e, __shfl_down_sync(0xffffffffu, acc_e, o));
    acc_n = __fadd_rn(acc_n, __shfl_down_sync(0xffffffffu, acc_n, o));
  }
  live = __shfl_sync(0xffffffffu, live, 0);
  a_n = __shfl_sync(0xffffffffu, a_n, 0);
  b_n = __shfl_sync(0xffffffffu, b_n, 0);
  stage = __shfl_sync(0xffffffffu, stage, 0);
  if (lane == 0) {
    if (live) {  // the state out (and env_next, its value) still carries the state in
      const bool ramp = emits_ramp(stage);
      const float ge = __fadd_rn(gstate_out[1], ramp ? *genv_next : 0.0f);
      const float gn = __fadd_rn(gstate_out[2],
                                 ramp ? __fmul_rn(slope_of(stage, p), *genv_next) : 0.0f);
      acc_e = __fadd_rn(acc_e, ge);
      acc_n = __fmaf_rn(a_n, ge, __fmaf_rn(b_n, gn, acc_n));
    }
    gstate_in[0] = 0.0f;
    gstate_in[1] = acc_e;
    gstate_in[2] = acc_n;
    gstate_in[3] = 0.0f;
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

// Enqueues one launch (one warp) on `stream`; returns its cudaError_t (0
// when accepted). Device pointers: gate / env / genv (T,) f32; state_in /
// gstate_out / gstate_in (4,) f32; genv_next () f32. sustain_samples < 0
// selects the gated machine, else the count the forward was given.
int adsr_scan_bwd_launch(const float* gate, const float* state_in, const float* env,
                         const float* genv, const float* gstate_out, const float* genv_next,
                         float* gstate_in, int T, float dA, float dD, float dR, float sus,
                         int sustain_samples, cudaStream_t stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  const Params p{dA, dD, dR, sus, sustain_samples};
  adsr_bwd<<<1, 32, 0, stream>>>(gate, state_in, env, genv, gstate_out, genv_next, gstate_in,
                                 T, p);
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
