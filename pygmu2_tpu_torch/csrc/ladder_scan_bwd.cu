// Adjoint of the Moog ladder (csrc/ladder_scan.cu) for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel
// pygmu2_tpu/ops/ladder_pallas.py:ladder_scan_pallas (:202), whose custom
// VJP (:253, ops/diffable.kernel_with_scan_vjp) replays jax.vjp of the
// lax.scan reference ladder_scan_ref.
//
// What it computes: given the forward's inputs x (T, C), the four (T,)
// columns al, qa, ki, dsc and the entering state (9, C), and the
// cotangents gy (T, C) of the output and gstate (9, C) of the state after
// the last sample, the cotangents of x, of the four columns (each summed
// over the channels) and of the entering state: reverse-mode AD of
// ladder_scan_ref's op order. The quiet-input decay is a select on
// |x * drive| < threshold: it multiplies the states, and passes no
// gradient through its comparison (as JAX's AD of where).
//
// Design (simple and right first; one thread per channel):
// 1. ladder_bwd_walk, pass 1: walks forward over the T samples exactly as
//    the forward kernel does (the same explicitly rounded ops, so the same
//    bits) and writes each sample's entering state, 9 floats, to the
//    trajectory `traj` (T, 9, C): 75 MB at the bank's T = 16384, C = 128.
// 2. pass 2: walks backward from sample T - 1 to 0. For each sample it
//    reloads the entering state and, for each oversampled step s from the
//    last down, recomputes steps 0..s from it (os_n (os_n + 1) / 2 step
//    forwards a sample) and propagates the cotangents through step s. The
//    column cotangents' per-channel parts go to `part` (4, T, C).
// 3. channel_sum (channel_sum.cuh) adds `part` over the channels, one
//    thread per (column, sample), channel 0 first: no atomics, so two runs
//    give the same bits.
//
// What bounds it on this card: the dependent chain, as in the forward. A
// sample's backward is ~3.5 forward samples' work at os_n = 2 (the
// recomputed steps and their adjoints), on one thread per channel. Bytes:
// x, gy and gx, the columns, the 9-float trajectory written and read, the
// parts; at T = 16384, C = 128, ~193 MB (58 us at 3.35 TB/s). The
// trajectory and the inputs are loaded one sample ahead of the chain.

#include <cuda_runtime.h>

#include "channel_sum.cuh"

namespace {

constexpr int kThreads = 32;  // channels per CUDA block
constexpr float kC1 = 0.76923077f;  // trapezoidal stage weights
constexpr float kC2 = 0.23076923f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Coef {
  float a, q, k;
};

// One oversampled step forward, as csrc/ladder_scan.cu rounds it: updates
// z0, z1 and returns u; pre[m] is stage m's value before its alpha product.
__device__ __forceinline__ float step_fwd(float* z0, float* z1, float in_i, float pbg,
                                          const Coef& c, float* pre) {
  const float u = tanhf(sub(in_i, mul(mul(sub(z1[3], mul(pbg, in_i)), c.k), c.q)));
  float prev = u;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float a = sub(add(mul(prev, kC1), mul(kC2, z0[m])), z1[m]);
    const float ft = add(mul(a, c.a), z1[m]);
    pre[m] = a;
    z1[m] = ft;
    z0[m] = prev;
    prev = ft;
  }
  return u;
}

// d mix / d u and d mix / d stage m, by response mode
__device__ __forceinline__ float mix_grads(int mode, float* d) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  switch (mode) {
    case 0: d[3] = 1.0f; return 0.0f;
    case 1: d[1] = 1.0f; return 0.0f;
    case 2: d[1] = 4.0f; d[3] = 4.0f; d[2] = -8.0f; return 0.0f;
    case 3: d[0] = 2.0f; d[1] = -2.0f; return 0.0f;
    case 4: d[3] = 1.0f; d[0] = -4.0f; d[2] = -4.0f; d[1] = 6.0f; return 1.0f;
    default: d[1] = 1.0f; d[0] = -2.0f; return 1.0f;
  }
}

struct Sample {  // one sample's inputs for one channel
  float x, gy, a, q, k, dsc, st[9];
};

// OS > 0: os_n is OS, folded at compile time; OS == 0: os_n at run time
template <int OS>
__global__ void __launch_bounds__(kThreads) ladder_bwd_walk(
    const float* __restrict__ x, const float* __restrict__ al, const float* __restrict__ qa,
    const float* __restrict__ ki, const float* __restrict__ dsc,
    const float* __restrict__ state_in, const float* __restrict__ gy,
    const float* __restrict__ gstate, float* __restrict__ gx, float* __restrict__ gstate_in,
    float* __restrict__ traj, float* __restrict__ part, int T, int C, int os_n_arg, float pbg,
    int mode, float threshold, float state_decay) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int os_n = OS > 0 ? OS : os_n_arg;
  const double recip = 1.0 / os_n;
  const float os_recip = (float)recip;

  // ---- pass 1: the forward, writing each sample's entering state ----
  float z0[4], z1[4], old;
  for (int k = 0; k < 4; ++k) {
    z0[k] = state_in[k * C + c];
    z1[k] = state_in[(4 + k) * C + c];
  }
  old = state_in[8 * C + c];
  float xn = x[c], dn = dsc[0];
  for (int t = 0; t < T; ++t) {
    const float xt = xn, dt = dn;
    const Coef cf{al[t], qa[t], ki[t]};
    if (t + 1 < T) {
      xn = x[(long)(t + 1) * C + c];
      dn = dsc[t + 1];
    }
    float* row = traj + (long)t * 9 * C + c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      row[k * C] = z0[k];
      row[(4 + k) * C] = z1[k];
    }
    row[8 * C] = old;
    const float in_s = mul(xt, dt);
    const float decay = fabsf(in_s) < threshold ? state_decay : 1.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      z0[k] = mul(z0[k], decay);
      z1[k] = mul(z1[k], decay);
    }
    old = mul(old, decay);
    float pre[4];
#pragma unroll
    for (int s = 0; s < os_n; ++s) {
      const float in_i = add(mul((float)(s * recip), old), mul((float)(1.0 - s * recip), in_s));
      step_fwd(z0, z1, in_i, pbg, cf, pre);
    }
    old = in_s;
  }

  // ---- pass 2: the reverse walk ----
  float d_mix[4];
  const float d_u = mix_grads(mode, d_mix);
  float g0[4], g1[4], gold;  // cotangents of the state after the sample
  for (int k = 0; k < 4; ++k) {
    g0[k] = gstate[k * C + c];
    g1[k] = gstate[(4 + k) * C + c];
  }
  gold = gstate[8 * C + c];
  auto load = [&](int t, Sample& s) {
    s.x = x[(long)t * C + c];
    s.gy = gy[(long)t * C + c];
    s.a = al[t];
    s.q = qa[t];
    s.k = ki[t];
    s.dsc = dsc[t];
    const float* row = traj + (long)t * 9 * C + c;
#pragma unroll
    for (int k = 0; k < 9; ++k) s.st[k] = row[k * C];
  };
  Sample next;
  load(T - 1, next);
  for (int t = T - 1; t >= 0; --t) {
    const Sample cur = next;
    if (t > 0) load(t - 1, next);
    const Coef cf{cur.a, cur.q, cur.k};
    const float in_s = mul(cur.x, cur.dsc);
    const float decay = fabsf(in_s) < threshold ? state_decay : 1.0f;
    float e0[4], e1[4];  // the decayed entering state
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      e0[k] = mul(cur.st[k], decay);
      e1[k] = mul(cur.st[4 + k], decay);
    }
    const float old_d = mul(cur.st[8], decay);
    const float gmix = cur.gy * os_recip;
    float g_in = gold;  // the state's `old` after the sample is in_s
    float g_old = 0.0f, ga = 0.0f, gq = 0.0f, gk = 0.0f;
#pragma unroll
    for (int s = os_n - 1; s >= 0; --s) {
      // recompute steps 0..s from the entering state
      float z0s[4], z1s[4], pre[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        z0s[k] = e0[k];
        z1s[k] = e1[k];
      }
      const float interp = (float)(s * recip), om = (float)(1.0 - s * recip);
#pragma unroll
      for (int j = 0; j < s; ++j) {
        const float in_j = add(mul((float)(j * recip), old_d), mul((float)(1.0 - j * recip), in_s));
        step_fwd(z0s, z1s, in_j, pbg, cf, pre);
      }
      const float in_i = add(mul(interp, old_d), mul(om, in_s));
      const float w = sub(z1s[3], mul(pbg, in_i));
      const float wk = mul(w, cf.k);
      float z0o[4], z1o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        z0o[k] = z0s[k];
        z1o[k] = z1s[k];
      }
      const float u = step_fwd(z0o, z1o, in_i, pbg, cf, pre);
      // backward through the four stages, the last first
      float gft[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) gft[m] = g1[m] + d_mix[m] * gmix;
      float gu = d_u * gmix;
#pragma unroll
      for (int m = 3; m >= 0; --m) {
        const float gpre = gft[m] * cf.a;
        ga += gft[m] * pre[m];
        const float gprev = g0[m] + gpre * kC1;
        g0[m] = gpre * kC2;
        g1[m] = gft[m] - gpre;
        if (m > 0)
          gft[m - 1] += gprev;
        else
          gu += gprev;
      }
      const float gv = gu * (1.0f - u * u);  // tanh
      const float gwq = -gv;                  // of (w k) q
      gq += gwq * wk;
      const float gwk = gwq * cf.q;
      gk += gwk * w;
      const float gw = gwk * cf.k;
      g1[3] += gw;
      const float gi = gv - pbg * gw;  // of in_i
      g_old += interp * gi;
      g_in += om * gi;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      g0[k] *= decay;
      g1[k] *= decay;
    }
    gold = g_old * decay;
    gx[(long)t * C + c] = g_in * cur.dsc;
    float* p = part + (long)t * C + c;
    const long col = (long)T * C;
    p[0] = ga;
    p[col] = gq;
    p[2 * col] = gk;
    p[3 * col] = g_in * cur.x;
  }
  for (int k = 0; k < 4; ++k) {
    gstate_in[k * C + c] = g0[k];
    gstate_in[(4 + k) * C + c] = g1[k];
  }
  gstate_in[8 * C + c] = gold;
}

}  // namespace

extern "C" {

// Enqueues the walk and the channel sum on `stream`; returns the first
// cudaError_t (0 when both were accepted). Device pointers: x / gy / gx
// (T, C) f32; al / qa / ki / dsc (T,) f32; state_in / gstate / gstate_in
// (9, C) f32; gcols (4, T) f32, the cotangents of al, qa, ki, dsc;
// scratch traj (T, 9, C) and part (4, T, C) f32.
int ladder_scan_bwd_launch(const float* x, const float* al, const float* qa, const float* ki,
                           const float* dsc, const float* state_in, const float* gy,
                           const float* gstate, float* gx, float* gcols, float* gstate_in,
                           float* traj, float* part, int T, int C, int os_n, float pbg,
                           int mode_index, float input_threshold, float state_decay,
                           cudaStream_t stream) {
  if (T < 1 || C < 1 || os_n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kThreads - 1) / kThreads), block(kThreads);
#define PGT_LADDER_BWD(OS)                                                                    \
  ladder_bwd_walk<OS><<<grid, block, 0, stream>>>(x, al, qa, ki, dsc, state_in, gy, gstate,  \
                                                  gx, gstate_in, traj, part, T, C, os_n, pbg, \
                                                  mode_index, input_threshold, state_decay)
  switch (os_n) {
    case 1: PGT_LADDER_BWD(1); break;
    case 2: PGT_LADDER_BWD(2); break;
    case 4: PGT_LADDER_BWD(4); break;
    default: PGT_LADDER_BWD(0);
  }
#undef PGT_LADDER_BWD
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_channel_sum(part, gcols, 4 * T, C, stream);
}

}  // extern "C"
