// Adjoint of the Moog ladder (csrc/ladder_scan.cu) for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel
// pygmu2_tpu/ops/ladder_pallas.py:ladder_scan_pallas (:202), whose custom
// VJP (:253, ops/diffable.kernel_with_scan_vjp) replays jax.vjp of the
// lax.scan reference ladder_scan_ref.
//
// What it computes: given the forward's inputs x (T, C) and the four (T,)
// columns al, qa, ki, dsc, the forward's checkpoints (each channel's
// entering state every K samples, (ceil(T / K), 9, C), written by the
// forward launch that was recorded for this backward), and the cotangents
// gy (T, C) of the output and gstate (9, C) of the state after the last
// sample: the cotangents of x, of the four columns (each summed over the
// channels) and of the entering state, reverse-mode AD of
// ladder_scan_ref's op order. The quiet-input decay is a select on
// |x * drive| < threshold: it multiplies the states and passes no
// gradient through its comparison (as JAX's AD of where).
//
// The fact the design rests on: with the forward's states known, the
// cotangent g (9 floats) of the state obeys a linear recurrence,
// g(t) = J(t)^T g(t + 1) + h(t), J and h functions of the trajectory, the
// columns and gy. tanh and the stage values sit off the cotangent's chain;
// the only truly serial part is the forward's nonlinear walk, and that
// can start from a checkpoint.
//
// Design (the first design walked all T samples on one thread a
// channel, twice, with a (T, 9, C) trajectory in device memory: 14.7 ms at
// T = 16384, C = 1 on an H100 80GB HBM3 at 700 W). Four launches on the caller's stream, none of which
// walks more than K samples serially:
// 1. ladder_bwd_chunks<FINAL = false>, parallel over (chunk, channel),
//    chunks 1..n-1: a warp holds three chunks (or one, see below), ten
//    lanes each. The lanes
//    stage the chunk's inputs into shared memory, re-walk the forward
//    from the checkpoint (the forward's explicitly rounded ops and tanhf:
//    the same bits) keeping each oversampled step's u, w and four stage
//    values in shared memory, then walk back together: lane l < 9 from
//    basis vector l with no output cotangent, lane 9 from zero with gy.
//    Lane l ends with column l of the chunk's matrix M_j, lane 9 with its
//    affine part b_j: g(start of chunk j) = M_j g(end of chunk j) + b_j.
// 2. ladder_bwd_carry, one warp per channel, lanes 0..8 one state row
//    each: from gstate, the cotangent leaving chunk j - 1 is M_j g + b_j
//    (summed from b in state order), for j = n-1 down to 1; the transfers
//    staged in shared memory 32 chunks at a time, the next 32 copied
//    (cp.async) while the current ones are applied.
// 3. ladder_bwd_chunks<FINAL = true>: each chunk re-walks again and one
//    lane walks back from its true cotangent, writing gx, the columns'
//    per-channel parts and, at chunk 0, gstate_in.
// 4. channel_sum (channel_sum.cuh) adds the parts over the channels in
//    channel order.
// Every op is rounded once (__fmul_rn, __fadd_rn, __fsub_rn: no
// contraction), no float atomics: two launches give the same bits, and
// the kernel equals ops/ladder.ladder_scan_bwd_chunked (the same order in
// torch ops) bit for bit on the card. Against the serial adjoint it
// differs only in the carry's roundings at the chunk edges.
//
// What bounds it on this card: the re-walk, twice, K samples of the
// forward's chain (~400 cycles a sample at os_n = 2), and the carry,
// ceil(T / K) dependent 9 x 9 products; at K = 32 and T = 16384 ~13k
// cycles each re-walk and ~35k for the carry. Bytes are far below: x, gy,
// gx, the columns, the parts and the transfers (96 floats a chunk and
// channel), ~2 MB at T = 16384, C = 1.
//
// Measured (chip_smoke.py phase 15, H100 80GB HBM3, 700 W; the launches
// alone by torch.profiler): 0.110 ms at T = 16384, C = 1, of which the
// carry 0.062 (~121 ns a hop; staged through shared memory in 16-byte
// pieces, where per-lane 4-byte copies had it at about twice that) and
// each chunk kernel ~0.023; 0.051 ms at T = 1024.
//
// Where a chunk's steps do not fit (the layout, chosen by the wrapper,
// ops/ladder._bwd_layout): three chunks a warp keep every oversampled
// step of their K samples in shared memory, (6 os_n + 7) floats a sample,
// up to os_n = 99 at K = 32; one chunk a warp up to os_n = 301. Past that
// the chunk keeps only each sample's entering state (REWALK): the first
// re-walk stores the nine state values a sample, and the walk back re-walks
// each sample's os_n steps again from its state into a buffer of 6 os_n
// floats (the group's writer lane, then a __syncwarp of the group) before
// walking them back. The same ops on the same values: the bits do not
// change, at the cost of a third forward walk. The buffer sits in shared
// memory up to os_n ~ 9600 (one chunk a warp; three up to ~3100), in device
// memory (a slice of `steps` per item) past that.

#include <cuda_runtime.h>

#include "channel_sum.cuh"

namespace {

constexpr int kGroup = 10;      // lanes per chunk: nine basis vectors and the affine part
constexpr int kMaxPerWarp = 3;  // chunks per warp (lanes 30, 31 idle)
constexpr int kStepFloats = 6;  // u, w, pre[0..3] per oversampled step
constexpr int kSampleFloats = 7;  // decay, x, gy, a, q, k, dsc per sample
constexpr int kStateFloats = 9;   // a sample's entering state (REWALK)
constexpr int kMaxShared = 232448;
constexpr int kTransfer = 96;  // floats of a chunk's transfer: ten lanes of nine, padded to 16 B
constexpr float kC1 = 0.76923077f;  // trapezoidal stage weights
constexpr float kC2 = 0.23076923f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

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

// floats of shared memory per chunk, odd so that the three chunks of a warp
// fall on different banks: all the chunk's steps, or (REWALK) the samples'
// entering states and one sample's steps (none where those are in `steps`)
__host__ __device__ __forceinline__ int item_floats(int K, int os_n, bool rewalk,
                                                    bool steps_global) {
  if (!rewalk) return (K * (kStepFloats * os_n + kSampleFloats)) | 1;
  return (K * (kSampleFloats + kStateFloats) + (steps_global ? 0 : kStepFloats * os_n)) | 1;
}

// One sample of the forward from the state (z0, z1, old) entering it, in
// ladder_scan_ref's op order; writes each step's u, w, pre[0..3] to v
// (where v is not null) and returns the sample's decay.
template <int OS>
__device__ __forceinline__ float forward_sample(float* z0, float* z1, float& old,
                                                const float* s, float* v, int os_n,
                                                double recip, float pbg, float threshold,
                                                float state_decay) {
  const float a = s[3], q = s[4], k = s[5];
  const float in_s = mul(s[1], s[6]);
  const float decay = fabsf(in_s) < threshold ? state_decay : 1.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    z0[m] = mul(z0[m], decay);
    z1[m] = mul(z1[m], decay);
  }
  old = mul(old, decay);
#pragma unroll
  for (int st_i = 0; st_i < (OS > 0 ? OS : os_n); ++st_i) {
    const float in_i = add(mul((float)(st_i * recip), old),
                           mul((float)(1.0 - st_i * recip), in_s));
    const float w = sub(z1[3], mul(pbg, in_i));
    const float u = tanhf(sub(in_i, mul(mul(w, k), q)));
    float prev = u;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float p = sub(add(mul(prev, kC1), mul(kC2, z0[m])), z1[m]);
      const float ft = add(mul(p, a), z1[m]);
      if (v) v[st_i * kStepFloats + 2 + m] = p;
      z1[m] = ft;
      z0[m] = prev;
      prev = ft;
    }
    if (v) {
      v[st_i * kStepFloats] = u;
      v[st_i * kStepFloats + 1] = w;
    }
  }
  old = in_s;
  return decay;
}

// One chunk's backward walk. FINAL = false: chunks 1..n-1, each lane of
// ten walks one vector and writes its part of the chunk's transfer.
// FINAL = true: chunks 0..n-1, lane 9 of each ten walks the true
// cotangent and writes gx, the parts and (chunk 0) gstate_in.
// OS > 0: os_n is OS, folded at compile time; OS == 0: os_n at run time.
// `per` chunks a warp; REWALK: a sample's steps re-walked from its entering
// state before its walk back, into shared memory or (steps not null) into
// the item's slice of `steps`.
template <int OS, bool FINAL, bool REWALK>
__global__ void __launch_bounds__(32) ladder_bwd_chunks(
    const float* __restrict__ x, const float* __restrict__ al, const float* __restrict__ qa,
    const float* __restrict__ ki, const float* __restrict__ dsc,
    const float* __restrict__ ckpt, const float* __restrict__ gy,
    const float* __restrict__ gstate, const float* __restrict__ g_end,
    float* __restrict__ transfers, float* __restrict__ gx, float* __restrict__ part,
    float* __restrict__ gstate_in, float* __restrict__ steps, int T, int C, int K,
    int os_n_arg, int per, float pbg, int mode, float threshold, float state_decay) {
  extern __shared__ float smem[];
  const int os_n = OS > 0 ? OS : os_n_arg;
  const int n = (T + K - 1) / K;
  const int first = FINAL ? 0 : 1;
  const long n_items = (long)(n - first) * C;
  const int lane = threadIdx.x, grp = lane / kGroup, vec = lane % kGroup;
  const long item = (long)blockIdx.x * per + grp;
  const bool active = grp < per && item < n_items;
  const int j = first + (int)(active ? item / C : 0), c = (int)(active ? item % C : 0);
  const int t0 = j * K, len = min(K, T - t0);
  // [K][7] sample values, then [K][os_n][6] step values or (REWALK) [K][9]
  // entering states and [os_n][6] one sample's step values
  float* ss = smem + grp * item_floats(K, os_n, REWALK, steps != nullptr);
  float* sst = ss + K * kSampleFloats;
  float* sv = REWALK ? (steps ? steps + item * os_n * kStepFloats : sst + K * kStateFloats)
                     : ss + K * kSampleFloats;
  // the lanes that walk back together: the group's ten, or (FINAL) lane 9
  const unsigned walkers = FINAL ? 1u << lane : 0x3ffu << (grp * kGroup);
  const double recip = 1.0 / os_n;
  const float os_recip = (float)recip;

  // ---- stage the chunk's inputs, then re-walk the forward ----
  if (active) {
    for (int i = vec; i < len; i += kGroup) {
      const int t = t0 + i;
      float* s = ss + i * kSampleFloats;
      s[1] = x[(long)t * C + c];
      s[2] = gy[(long)t * C + c];
      s[3] = al[t];
      s[4] = qa[t];
      s[5] = ki[t];
      s[6] = dsc[t];
    }
  }
  __syncwarp();
  float g[9];
  if (active) {
    float z0[4], z1[4], old;
    const float* st = ckpt + (long)j * 9 * C + c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      z0[k] = st[k * C];
      z1[k] = st[(4 + k) * C];
    }
    old = st[8 * C];
    const bool writer = vec == kGroup - 1;
    for (int i = 0; i < len; ++i) {
      float* s = ss + i * kSampleFloats;
      if (REWALK && writer) {
        float* e = sst + i * kStateFloats;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          e[m] = z0[m];
          e[4 + m] = z1[m];
        }
        e[8] = old;
      }
      float* v = writer && !REWALK ? sv + i * os_n * kStepFloats : nullptr;
      const float decay =
          forward_sample<OS>(z0, z1, old, s, v, os_n, recip, pbg, threshold, state_decay);
      if (writer) s[0] = decay;
    }
    // the cotangent leaving the chunk
    if (FINAL) {
      const float* src = j == n - 1 ? gstate + c : g_end + (long)j * 9 * C + c;
#pragma unroll
      for (int r = 0; r < 9; ++r) g[r] = src[r * C];
    } else {
#pragma unroll
      for (int r = 0; r < 9; ++r) g[r] = r == vec ? 1.0f : 0.0f;
    }
  }
  __syncwarp();
  if (!active || (FINAL && vec != kGroup - 1)) return;

  // ---- walk back ----
  float d_mix[4];
  const float d_u = mix_grads(mode, d_mix);
  const bool with_gy = FINAL || vec == kGroup - 1;
  for (int i = len - 1; i >= 0; --i) {
    const float* s = ss + i * kSampleFloats;
    if (REWALK) {  // the sample's steps again, from its entering state
      if (vec == kGroup - 1) {
        const float* e = sst + i * kStateFloats;
        float z0[4], z1[4], old = e[8];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          z0[m] = e[m];
          z1[m] = e[4 + m];
        }
        forward_sample<OS>(z0, z1, old, s, sv, os_n, recip, pbg, threshold, state_decay);
      }
      __syncwarp(walkers);
    }
    const float* sv_i = REWALK ? sv : sv + i * os_n * kStepFloats;
    const float a = s[3], q = s[4], k = s[5];
    const float gmix = mul(with_gy ? s[2] : 0.0f, os_recip);
    float g_in = g[8];  // the state's `old` after the sample is in_s
    float g_old = 0.0f, ga = 0.0f, gq = 0.0f, gk = 0.0f;
#pragma unroll
    for (int st_i = os_n - 1; st_i >= 0; --st_i) {
      const float* v = sv_i + st_i * kStepFloats;
      const float u = v[0], w = v[1];
      float gft[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) gft[m] = add(g[4 + m], mul(d_mix[m], gmix));
      float gu = mul(d_u, gmix);
#pragma unroll
      for (int m = 3; m >= 0; --m) {
        const float gpre = mul(gft[m], a);
        if (FINAL) ga = add(ga, mul(gft[m], v[2 + m]));
        const float gprev = add(g[m], mul(gpre, kC1));
        g[m] = mul(gpre, kC2);
        g[4 + m] = sub(gft[m], gpre);
        if (m > 0)
          gft[m - 1] = add(gft[m - 1], gprev);
        else
          gu = add(gu, gprev);
      }
      const float gv = mul(gu, sub(1.0f, mul(u, u)));  // tanh
      const float gwq = -gv;                           // of (w k) q
      const float gwk = mul(gwq, q);
      if (FINAL) {
        gq = add(gq, mul(gwq, mul(w, k)));
        gk = add(gk, mul(gwk, w));
      }
      const float gw = mul(gwk, k);
      g[7] = add(g[7], gw);
      const float gi = sub(gv, mul(pbg, gw));  // of in_i
      g_old = add(g_old, mul((float)(st_i * recip), gi));
      g_in = add(g_in, mul((float)(1.0 - st_i * recip), gi));
    }
    if (REWALK) __syncwarp(walkers);  // the buffer is the next sample's
    const float decay = s[0];
#pragma unroll
    for (int r = 0; r < 8; ++r) g[r] = mul(g[r], decay);
    g[8] = mul(g_old, decay);
    if (FINAL) {
      const int t = t0 + i;
      const long row = (long)t * C + c, col = (long)T * C;
      gx[row] = mul(g_in, s[6]);
      part[row] = ga;
      part[col + row] = gq;
      part[2 * col + row] = gk;
      part[3 * col + row] = mul(g_in, s[1]);
    }
  }
  if (FINAL) {
    if (j == 0)
#pragma unroll
      for (int r = 0; r < 9; ++r) gstate_in[r * C + c] = g[r];
  } else {
    float* out = transfers + item * kTransfer + vec * 9;  // [chunk - 1][c][lane][row]
#pragma unroll
    for (int r = 0; r < 9; ++r) out[r] = g[r];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

constexpr int kHops = 32;  // transfers staged in shared memory at a time

// The carry over the chunks, one warp per channel: lane r < 9 holds row r
// of the cotangent leaving the current chunk. The transfers come through
// shared memory, kHops chunks at a time, the next kHops copied (cp.async)
// while the current ones are applied: a hop is then nine shuffles and nine
// dependent multiply-adds, with no device-memory latency on the chain.
__global__ void __launch_bounds__(32) ladder_bwd_carry(const float* __restrict__ transfers,
                                                       const float* __restrict__ gstate,
                                                       float* __restrict__ g_end, int n,
                                                       int C) {
  __shared__ __align__(16) float s_t[2][kHops * kTransfer];
  const int c = blockIdx.x, lane = threadIdx.x;
  const bool row = lane < 9;
  const int r = row ? lane : 0;
  float g = row ? gstate[r * C + c] : 0.0f;
  const int hops = n - 1, blocks = (hops + kHops - 1) / kHops;
  // block b: hops j = n - 1 - b kHops down, chunk j's transfer at [j - 1][c]
  auto stage = [&](int b) {  // a transfer is 24 16-byte pieces: lanes 0..23
    const int hi = n - 1 - b * kHops, cnt = min(kHops, hi);
    if (lane < kTransfer / 4) {
      float* dst = s_t[b & 1] + 4 * lane;
      const float* src = transfers + ((long)(hi - 1) * C + c) * kTransfer + 4 * lane;
      for (int h = 0; h < cnt; ++h, dst += kTransfer, src -= (long)C * kTransfer)
        cp_async16(dst, src);
    }
    cp_async_commit();
  };
  if (blocks > 0) stage(0);
  for (int b = 0; b < blocks; ++b) {
    if (b + 1 < blocks) {
      stage(b + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int hi = n - 1 - b * kHops, cnt = min(kHops, hi);
    const float* t = s_t[b & 1];
    float m[kGroup];  // this hop's row r of M, then b[r]: read a hop ahead
#pragma unroll
    for (int i = 0; i < kGroup; ++i) m[i] = t[i * 9 + r];
    for (int h = 0; h < cnt; ++h) {
      float gv[9];  // all nine shuffles first: none waits on the sum
#pragma unroll
      for (int i = 0; i < 9; ++i) gv[i] = __shfl_sync(0xffffffffu, g, i);
      float acc = m[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) acc = add(acc, mul(m[i], gv[i]));
      if (h + 1 < cnt)
#pragma unroll
        for (int i = 0; i < kGroup; ++i) m[i] = t[(h + 1) * kTransfer + i * 9 + r];
      g = acc;
      if (row) g_end[((long)(hi - h - 1) * 9 + r) * C + c] = g;
    }
    __syncwarp();  // the buffer is copied into again two blocks on
  }
}

// Raises a kernel's dynamic shared memory limit to `bytes` where that is
// past the default 48 KB, once per kernel and size.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <int OS, bool REWALK>
cudaError_t launch_all(const float* x, const float* al, const float* qa, const float* ki,
                       const float* dsc, const float* ckpt, const float* gy,
                       const float* gstate, float* gx, float* gstate_in, float* transfers,
                       float* g_end, float* part, float* steps, int T, int C, int K, int os_n,
                       int per, float pbg, int mode, float threshold, float decay,
                       cudaStream_t stream) {
  const int n = (T + K - 1) / K;
  const long smem_l = (long)per * item_floats(K, os_n, REWALK, steps != nullptr) * 4;
  if (per < 1 || per > kMaxPerWarp || smem_l > kMaxShared || (steps && !REWALK))
    return cudaErrorInvalidValue;
  const int smem = (int)smem_l;
  cudaError_t err;
  if (n > 1) {
    static int allowed_transfers = 0;
    if ((err = allow_shared(ladder_bwd_chunks<OS, false, REWALK>, smem, allowed_transfers)) !=
        cudaSuccess)
      return err;
    const long items = (long)(n - 1) * C;
    ladder_bwd_chunks<OS, false, REWALK><<<(unsigned)((items + per - 1) / per), 32, smem,
                                           stream>>>(
        x, al, qa, ki, dsc, ckpt, gy, gstate, g_end, transfers, gx, part, gstate_in, steps, T,
        C, K, os_n, per, pbg, mode, threshold, decay);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ladder_bwd_carry<<<C, 32, 0, stream>>>(transfers, gstate, g_end, n, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  static int allowed_final = 0;
  if ((err = allow_shared(ladder_bwd_chunks<OS, true, REWALK>, smem, allowed_final)) !=
      cudaSuccess)
    return err;
  const long items = (long)n * C;
  ladder_bwd_chunks<OS, true, REWALK><<<(unsigned)((items + per - 1) / per), 32, smem,
                                        stream>>>(
      x, al, qa, ki, dsc, ckpt, gy, gstate, g_end, transfers, gx, part, gstate_in, steps, T, C,
      K, os_n, per, pbg, mode, threshold, decay);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues the transfers, the carry, the final walks and the channel sum
// on `stream`; returns the first cudaError_t (0 when all were accepted).
// Device pointers: x / gy / gx (T, C) f32; al / qa / ki / dsc (T,) f32;
// ckpt (ceil(T / K), 9, C) f32, the forward's checkpoints every K samples;
// gstate / gstate_in (9, C) f32; gcols (4, T) f32, the cotangents of al,
// qa, ki, dsc; scratch transfers (ceil(T / K) - 1, C, 96), g_end
// (ceil(T / K) - 1, 9, C) and part (4, T, C) f32; steps, null or (with
// rewalk) (ceil(T / K) C, 6 os_n) f32, a sample's steps past shared
// memory. The layout: `per` chunks a warp (1..3) and `rewalk`
// (ops/ladder._bwd_layout); a layout past shared memory is refused.
int ladder_scan_bwd_launch(const float* x, const float* al, const float* qa, const float* ki,
                           const float* dsc, const float* ckpt, const float* gy,
                           const float* gstate, float* gx, float* gcols, float* gstate_in,
                           float* transfers, float* g_end, float* part, float* steps, int T,
                           int C, int K, int os_n, int per, int rewalk, float pbg,
                           int mode_index, float input_threshold, float state_decay,
                           cudaStream_t stream) {
  if (T < 1 || C < 1 || os_n < 1 || K < 1) return (int)cudaErrorInvalidValue;
#define PGT_LADDER_BWD(OS, RW)                                                                 \
  launch_all<OS, RW>(x, al, qa, ki, dsc, ckpt, gy, gstate, gx, gstate_in, transfers, g_end,   \
                     part, steps, T, C, K, os_n, per, pbg, mode_index, input_threshold,       \
                     state_decay, stream)
  cudaError_t err;
  if (rewalk) {
    err = PGT_LADDER_BWD(0, true);
  } else {
    switch (os_n) {
      case 1: err = PGT_LADDER_BWD(1, false); break;
      case 2: err = PGT_LADDER_BWD(2, false); break;
      case 4: err = PGT_LADDER_BWD(4, false); break;
      default: err = PGT_LADDER_BWD(0, false);
    }
  }
#undef PGT_LADDER_BWD
  if (err != cudaSuccess) return (int)err;
  return (int)launch_channel_sum(part, gcols, 4 * T, C, stream);
}

}  // extern "C"
