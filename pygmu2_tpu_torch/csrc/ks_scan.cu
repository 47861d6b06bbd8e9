// Karplus-Strong string for Hopper (sm_90a): the two-point average of a
// window of samples at once, then the allpass's short serial chain.
//
// Replaces the TPU kernel pygmu2_tpu/ops/ks_pallas.py:ks_scan_pallas
// (:115), which keeps the (L, 128) string in VMEM scratch (one live lane)
// and walks a sequential grid of time chunks.
//
// What it computes (the op order of ks_scan_ref, float32, its allpass two
// fused multiply-adds as XLA's CPU program forms them), per sample t where
// act[t] is set (elsewhere y = 0 and the state stands still):
//   rn  = (r + 1) % L
//   out = rho[t] * (buf[r] + buf[rn]) * 0.5              two-point average
//   ap  = fma(-c, ap_out, fma(c, out, ap_in))            fractional allpass
//   y[t] = ap; buf[r] = ap; r = rn; ap_in = out; ap_out = ap
// A call whose samples are all active, on a string of L >= 16, takes the
// second kernel, ks_blocked, below: the order of ks_blocked_ref.
//
// What bounds it on this card: a dependent chain, not bytes or operations.
// At the main path's block (T = 16384, L = 535) it moves 152 KB (roofline
// 0.05 us at 3.35 TB/s) and does 7 ops per sample. The chain is shorter
// than the loop suggests. Number the active samples k = 0, 1, ... (the
// string, the read head and the allpass advance only on them) and lay the
// string out as a tape: S[j] = buf[(r + j) % L] for j < L, S[L + k] = the
// allpass output of sample k. Sample k reads S[k] and S[k + 1], values
// written L and L - 1 samples before it, so out[k] for a window of L - 1
// samples depends only on earlier windows. What is left serial is the
// allpass: ap[k] = fma(-c, ap[k - 1], fma(c, out[k], out[k - 1])), one
// fused multiply-add on the chain (the first design's multiply and
// subtract took ~8 cycles: ~70 us per 16384 samples at 1.98 GHz). The first design ran the whole sample on one thread, its
// shared-memory loads ordered after the previous sample's store: 1.03 ms.
//
// What the design does about it: one CUDA block of 256 threads.
// 1. Compaction, all threads: a prefix count of act gives each active
//    sample its number k; its index t and rho[t] go to scratch (idx,
//    rho_c), and inactive samples output 0.
// 2. Windows of W = min(1024, (L - 1) / 2) active samples, pipelined: while
//    thread 0 runs the allpass over window j, warps 1-7 write window
//    j - 1's outputs into the string and to y[idx[k]], then (after a
//    barrier of their own) form P[k] = fma(c, out[k], out[k - 1]) for window
//    j + 1 (it reads only tape values of windows up to j - 1, since
//    2W + 1 <= L) and stage rho_c of window j + 2 into shared memory with
//    cp.async; one __syncthreads() per window. Thread 0 touches only two
//    shared arrays, P and its outputs, in 16-byte vectors, loading eight P
//    ahead of the chain.
//    Every value is rounded as in the plain version (__fmul_rn, __fadd_rn,
//    __fmaf_rn on the same operands), so the kernel equals it bit for bit.
// The string lives in shared memory up to 51200 samples (200 KB; a string
// below 0.862 Hz at 44.1 kHz is longer); a longer one lives in buf_out in
// global memory (L2-resident), updated in place, and then its windows are
// 1024 samples long, every one computable from the string handed in.
// Strings of L <= 8 (W < 4) take one thread walking every sample instead,
// as the first design did: their windows would be shorter than a barrier.
//
// Measured (H100 80GB HBM3, 700 W; T = 16384, the string starting at 100):
// 0.131 ms at L = 535 and 0.193 ms at L = 133 (chip_smoke.py). By
// cycle_probe.py's clock counters thread 0 spends ~10.9 cycles a sample at
// L = 535 (the chain alone: 8.9); at L = 133 (66-sample windows) the warps
// forming the next window take as long as the chain, ~16.4 cycles a
// sample each, the barriers and each window's set-up in between.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 200 * 1024;  // of the 227 KB a block may use
constexpr int kThreads = 256;   // warp 0: the allpass thread; warps 1-7 the rest
constexpr int kWindow = 1024;   // active samples per window, at most
constexpr int kSerialMaxL = 8;  // strings this short: one thread per sample

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }
__device__ __forceinline__ void cp_async_wait_group_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// the two-point average of tape slots s0 and s0 + 1, as the plain version
__device__ __forceinline__ float average(float rh, const float* ring, int s0, int L) {
  const int s1 = s0 + 1 == L ? 0 : s0 + 1;
  return __fmul_rn(__fmul_rn(rh, __fadd_rn(ring[s0], ring[s1])), 0.5f);
}

// one thread over every sample, act selecting (the short strings)
__device__ void serial_string(const float* __restrict__ rho,
                              const bool* __restrict__ act, float* ring,
                              float* __restrict__ y, int T, int L, float c,
                              int& r, float& ai, float& ao) {
  for (int t = 0; t < T; ++t) {
    const bool a = act[t];
    const float rh = rho[t];
    const int rn = r + 1 == L ? 0 : r + 1;
    const float out = __fmul_rn(__fmul_rn(rh, __fadd_rn(ring[r], ring[rn])), 0.5f);
    const float ap = __fmaf_rn(-c, ao, __fmaf_rn(c, out, ai));
    y[t] = a ? ap : 0.0f;
    if (a) {
      ring[r] = ap;
      r = rn;
      ai = out;
      ao = ap;
    }
  }
}

// One serial thread's walk over n staged values: out[i] = step(in[i]), in
// order. Loads run eight values ahead of the chain as 16-byte vectors and
// outputs leave as 16-byte vectors, with no bounds test inside the loop:
// in and out are 16-byte aligned and readable to n + 8. A warp runs its
// instructions in order, so every test and register move stands in the
// chain's way: in cycle_probe.py's microbenchmark (H100) the smoother
// walks 512 staged values at 16.1 cycles a step with bounds-tested scalar
// loads and moves between batches, at 13.3 this way, against 12.9 for its
// chain alone.
template <class Step>
__device__ __forceinline__ void walk(const float* __restrict__ in, float* __restrict__ out,
                                     int n, Step step) {
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  auto four = [&](float4 a, int i) {  // in order: step carries the chain
    const float o0 = step(a.x), o1 = step(a.y), o2 = step(a.z), o3 = step(a.w);
    out4[i / 4] = make_float4(o0, o1, o2, o3);
  };
  auto eight = [&](float4 a, float4 b, int i) {
    four(a, i);
    four(b, i + 4);
  };
  float4 f0 = in4[0], f1 = in4[1];
  int i = 0;
  for (; i + 16 <= n; i += 16) {  // two batches a turn: no register moves
    const float4 g0 = in4[i / 4 + 2], g1 = in4[i / 4 + 3];
    eight(f0, f1, i);
    f0 = in4[i / 4 + 4];
    f1 = in4[i / 4 + 5];
    eight(g0, g1, i + 8);
  }
  if (i + 8 <= n) {
    const float4 g0 = in4[i / 4 + 2], g1 = in4[i / 4 + 3];
    eight(f0, f1, i);
    f0 = g0;
    f1 = g1;
    i += 8;
  }
  const float rest[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (i + u < n) out[i + u] = step(rest[u]);
}

// producers only (warps 1-7): a barrier that leaves thread 0 running
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kThreads - 32) : "memory");
}

__global__ void __launch_bounds__(kThreads) ks_scan(
    const float* __restrict__ rho, const bool* __restrict__ act,
    const float* __restrict__ buf_in, const int* __restrict__ r_in,
    const float* __restrict__ ap_in_in, const float* __restrict__ ap_out_in,
    float* y, float* buf_out, int* __restrict__ r_out,
    float* __restrict__ ap_in_out, float* __restrict__ ap_out_out, int* idx,
    float* rho_c, int T, int L, float c, bool ring_in_shared) {
  extern __shared__ float shared_ring[];
  // P and the outputs padded by 8: thread 0 reads 16-byte vectors past a window's end
  __shared__ float s_rho[2][kWindow], s_last[2];
  __shared__ __align__(16) float s_P[2][kWindow + 8], s_ap[2][kWindow + 8];
  __shared__ int s_count[kThreads / 32];
  const int tid = threadIdx.x;
  // the string: slot l of the ring is buf[l]
  float* ring = ring_in_shared ? shared_ring : buf_out;
  for (int l = tid; l < L; l += kThreads) ring[l] = buf_in[l];
  const int r0 = *r_in;
  const float ai0 = *ap_in_in;
  float ao = *ap_out_in;  // thread 0's allpass state
  __syncthreads();

  if (L <= kSerialMaxL) {
    if (tid == 0) {
      int r = r0;
      float ai = ai0;
      serial_string(rho, act, ring, y, T, L, c, r, ai, ao);
      *r_out = r;
      *ap_in_out = ai;
      *ap_out_out = ao;
    }
  } else {
    // ---- 1. compaction: active sample k is the k-th set act, in tiles of
    // 4 samples a thread (coalesced), counted by warp shuffles ----
    const int lane = tid & 31, warp = tid >> 5;
    int K = 0;  // active samples before the tile
    for (int base = 0; base < T; base += 4 * kThreads) {
      const int t0 = base + 4 * tid;
      bool a[4];
      int count = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = t0 + q < T && act[t0 + q];
        count += a[q] ? 1 : 0;
      }
      int incl = count;  // inclusive prefix over the warp
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane == 31) s_count[warp] = incl;
      __syncthreads();
      int k = K + incl - count, tile = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        const int v = s_count[w];
        k += w < warp ? v : 0;
        tile += v;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = t0 + q;
        if (t >= T) break;
        if (a[q]) {
          idx[k] = t;
          rho_c[k++] = rho[t];
        } else {
          y[t] = 0.0f;
        }
      }
      K += tile;
      __syncthreads();  // s_count is the next tile's
    }

    // ---- 2. windows of W active samples, pipelined ----
    const int W = min(kWindow, (L - 1) / 2);
    const int n_win = (K + W - 1) / W;
    const int step = kThreads - 32;  // warps 1-7
    auto stage = [&](int j) {  // rho_c of window j into s_rho[j & 1]
      const int base = j * W, n = min(W, K - base), b = j & 1;
      for (int i = tid - 32; i < n; i += step) cp_async4(&s_rho[b][i], rho_c + base + i);
    };
    // the string slot of window j's sample i: (r0 + j * W + i) % L, with
    // one modulo per window (i < W < L)
    auto slot = [&](int sb, int i) { return sb + i >= L ? sb + i - L : sb + i; };
    auto form = [&](int j) {  // P of window j into s_P[j & 1]
      const int base = j * W, n = min(W, K - base), b = j & 1, sb = (r0 + base) % L;
      for (int i = tid - 32; i < n; i += step) {
        const int m = base + i, s0 = slot(sb, i);
        const float out = average(s_rho[b][i], ring, s0, L);
        float prev;  // out of the active sample before: ap_in
        if (i > 0)
          prev = average(s_rho[b][i - 1], ring, s0 == 0 ? L - 1 : s0 - 1, L);
        else
          prev = m == 0 ? ai0 : s_last[(j - 1) & 1];
        s_P[b][i] = __fmaf_rn(c, out, prev);
        if (i == n - 1) s_last[b] = out;
      }
    };
    // window j's outputs into the string, and compacted over its rho_c
    // (staged long before); scattered to y after the last window
    auto emit = [&](int j) {
      const int base = j * W, n = min(W, K - base), b = j & 1, sb = (r0 + base) % L;
      for (int i = tid - 32; i < n; i += step) {
        const float v = s_ap[b][i];
        ring[slot(sb, i)] = v;
        rho_c[base + i] = v;
      }
    };

    if (tid >= 32) {
      if (n_win > 0) stage(0);
      if (n_win > 1) stage(1);
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    if (tid >= 32 && n_win > 0) form(0);
    __syncthreads();
    for (int j = 0; j <= n_win; ++j) {
      if (tid == 0 && j < n_win) {
        const int b = j & 1;
        walk(s_P[b], s_ap[b], min(W, K - j * W),
             [&](float p) { return ao = __fmaf_rn(-c, ao, p); });
      } else if (tid >= 32) {
        if (j + 2 < n_win) stage(j + 2);  // in flight through this window
        cp_async_commit();
        if (j >= 1) emit(j - 1);
        cp_async_wait_group_1();  // window j + 1's rho has landed
        producers_sync();  // ... and window j - 1 is in the string
        if (j + 1 < n_win) form(j + 1);
      }
      __syncthreads();
    }
#pragma unroll 4
    for (int k = tid; k < K; k += kThreads) y[idx[k]] = rho_c[k];
    if (tid == 0) {
      *r_out = (int)(((long long)r0 + K) % L);
      *ap_in_out = K > 0 ? s_last[(n_win - 1) & 1] : ai0;
      *ap_out_out = ao;
    }
  }
  __syncthreads();
  if (ring_in_shared)
    for (int l = tid; l < L; l += kThreads) buf_out[l] = ring[l];
}

// ---- the blocked order: a call whose samples are all active ----
//
// What it computes (the op order of ks_blocked_ref: the JAX package's
// ops/ks_block.ks_blocked as XLA's CPU program rounds it), in blocks of
// B = min(L - 1, 512) samples, W the string oldest first:
//   out[j] = rho[j] * (W[j] + W[j + 1]) * 0.5
//   u[0]   = fma(c, out[0], ap_in);  u[j] = c * out[j] + out[j - 1]
//   ap[j]  = fma((-c)^(j+1), ap_out, sum_k (-c)^(j-k) u[k])
// the sum in XLA's GEMV order: eight lanes (k mod 8, below B - B % 8) of
// fused multiply-adds from 0, summed pairwise (rows below B - B % 8:
// ((l0+l1)+(l2+l3))+((l4+l5)+(l6+l7)); the rest: ((l0+l4)+(l2+l6))+
// ((l1+l5)+(l3+l7))), then the B % 8 last columns' fused multiply-adds
// from 0 added. A term with k > j is a product by 0 and adds nothing, so
// row j walks k <= j only. Then ap_in = out[B - 1], ap_out = ap[B - 1], and
// the block's outputs become the string's newest B values.
//
// The design: one CUDA block, a thread per row of the block (B <= 512), the
// string in shared memory (or in buf_out beyond MAX_KERNEL_L), the diagonals
// (-c)^d and (-c)^(j+1) in shared memory. Three barriers a block: the
// averages, the u row, then every row's sum at once (row j: j + 1 fused
// multiply-adds on eight independent chains). The sums read u and the
// diagonals as 16-byte vectors, four terms a load: u is one broadcast row;
// the diagonals are kept reversed in four copies shifted by one, so every
// row's run of terms starts 16-byte aligned in one of them.

constexpr int kBlockedMaxB = 512;
constexpr int kRevLen = kBlockedMaxB + 8;  // a reversed diagonal, padded

__global__ void __launch_bounds__(kBlockedMaxB) ks_blocked(
    const float* __restrict__ rho, const float* __restrict__ buf_in,
    const int* __restrict__ r_in, const float* __restrict__ ap_in_in,
    const float* __restrict__ ap_out_in, const float* __restrict__ diag,
    const float* __restrict__ powv, float* __restrict__ y, float* buf_out,
    int* __restrict__ r_out, float* __restrict__ ap_in_out,
    float* __restrict__ ap_out_out, int T, int L, int B, float c,
    bool ring_in_shared) {
  extern __shared__ float shared_ring[];
  // s_rev[q][i] = (-c)^(511 - i - q): row j reads its terms k, k + 1, ...
  // ascending from 16-byte aligned s_rev[(511 - j) & 3][511 - j - that + k]
  __shared__ __align__(16) float s_rev[4][kRevLen];
  __shared__ __align__(16) float s_u[kRevLen];
  __shared__ float s_pow[kBlockedMaxB], s_out[kBlockedMaxB], s_ap[kBlockedMaxB];
  const int j = threadIdx.x;
  float* ring = ring_in_shared ? shared_ring : buf_out;
  for (int l = j; l < L; l += blockDim.x) ring[l] = buf_in[l];
  for (int i = j; i < 4 * kRevLen; i += blockDim.x) {
    const int d = kBlockedMaxB - 1 - i % kRevLen - i / kRevLen;
    s_rev[i / kRevLen][i % kRevLen] = d >= 0 && d < B ? diag[d] : 0.f;
  }
  if (j < B) s_pow[j] = powv[j];
  const int r0 = *r_in;
  float ai = *ap_in_in, ao = *ap_out_in;
  const int K8 = B & ~7;
  const int q_j = (kBlockedMaxB - 1 - j) & 3;
  const float* rev = s_rev[q_j] + (kBlockedMaxB - 1 - j - q_j);  // rev[k] = (-c)^(j-k)
  __syncthreads();
  int sb = r0;  // the slot of the block's oldest value
  for (int n0 = 0; n0 < T; n0 += B) {
    const int nb = min(B, T - n0);
    int s0 = sb + j;
    if (s0 >= L) s0 -= L;  // j < B < L
    if (j < nb) {
      const int s1 = s0 + 1 == L ? 0 : s0 + 1;
      s_out[j] = __fmul_rn(__fmul_rn(rho[n0 + j], __fadd_rn(ring[s0], ring[s1])), 0.5f);
    }
    __syncthreads();
    if (j < nb)
      s_u[j] = j == 0 ? __fmaf_rn(c, s_out[0], ai)
                      : __fadd_rn(__fmul_rn(c, s_out[j]), s_out[j - 1]);
    const float ai_next = s_out[nb - 1];
    __syncthreads();
    if (j < nb) {
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const int kend = min(j + 1, K8);
      int k0 = 0;
      for (; k0 + 8 <= kend; k0 += 8) {  // 16-byte loads: u broadcast, diagonals
        const float4 u0 = *reinterpret_cast<const float4*>(s_u + k0);
        const float4 u1 = *reinterpret_cast<const float4*>(s_u + k0 + 4);
        const float4 d0 = *reinterpret_cast<const float4*>(rev + k0);
        const float4 d1 = *reinterpret_cast<const float4*>(rev + k0 + 4);
        a[0] = __fmaf_rn(d0.x, u0.x, a[0]);
        a[1] = __fmaf_rn(d0.y, u0.y, a[1]);
        a[2] = __fmaf_rn(d0.z, u0.z, a[2]);
        a[3] = __fmaf_rn(d0.w, u0.w, a[3]);
        a[4] = __fmaf_rn(d1.x, u1.x, a[4]);
        a[5] = __fmaf_rn(d1.y, u1.y, a[5]);
        a[6] = __fmaf_rn(d1.z, u1.z, a[6]);
        a[7] = __fmaf_rn(d1.w, u1.w, a[7]);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (k0 + q < kend) a[q] = __fmaf_rn(rev[k0 + q], s_u[k0 + q], a[q]);
      const float h =
          j < K8 ? __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
                             __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])))
                 : __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[4]), __fadd_rn(a[2], a[6])),
                             __fadd_rn(__fadd_rn(a[1], a[5]), __fadd_rn(a[3], a[7])));
      float e = 0.f;
      for (int k = K8; k <= j; ++k) e = __fmaf_rn(rev[k], s_u[k], e);
      const float ap = __fmaf_rn(s_pow[j], ao, __fadd_rn(h, e));
      s_ap[j] = ap;
      y[n0 + j] = ap;
      ring[s0] = ap;
    }
    __syncthreads();
    ai = ai_next;
    ao = s_ap[nb - 1];
    sb += nb;
    if (sb >= L) sb -= L;
  }
  if (j == 0) {
    *r_out = sb;
    *ap_in_out = ai;
    *ap_out_out = ao;
  }
  __syncthreads();
  if (ring_in_shared)
    for (int l = j; l < L; l += blockDim.x) buf_out[l] = ring[l];
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: rho / y (T,) f32, act (T,) bool, buf_in /
// buf_out (L,) f32, r_in / r_out () i32 in [0, L), ap_* () f32; scratch:
// idx (T,) i32, rho_c (T,) f32. Needs L >= 2.
int ks_scan_launch(const float* rho, const bool* act, const float* buf_in,
                   const int* r_in, const float* ap_in_in,
                   const float* ap_out_in, float* y, float* buf_out, int* r_out,
                   float* ap_in_out, float* ap_out_out, int* idx, float* rho_c,
                   int T, int L, float allpass_c, cudaStream_t stream) {
  if (L < 2) return (int)cudaErrorInvalidValue;
  const size_t ring_bytes = (size_t)L * sizeof(float);
  const bool shared = ring_bytes <= (size_t)kMaxSharedBytes;
  const size_t smem = shared ? ring_bytes : 0;
  if (smem > 16 * 1024) {  // beside the 17 KB of static shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        ks_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ks_scan<<<1, kThreads, smem, stream>>>(rho, act, buf_in, r_in, ap_in_in,
                                         ap_out_in, y, buf_out, r_out,
                                         ap_in_out, ap_out_out, idx, rho_c, T,
                                         L, allpass_c, shared);
  return (int)cudaGetLastError();
}

// The blocked order (all samples active, L >= 16): one launch on `stream`;
// returns its cudaError_t. diag (B,) f32: (-c)^d, d = 0 .. B - 1; powv (B,)
// f32: (-c)^(j+1); B = min(L - 1, 512). Other pointers as ks_scan_launch.
int ks_blocked_launch(const float* rho, const float* buf_in, const int* r_in,
                      const float* ap_in_in, const float* ap_out_in,
                      const float* diag, const float* powv, float* y,
                      float* buf_out, int* r_out, float* ap_in_out,
                      float* ap_out_out, int T, int L, int B, float allpass_c,
                      cudaStream_t stream) {
  if (L < 16 || B < 1 || B > kBlockedMaxB || B > L - 1) return (int)cudaErrorInvalidValue;
  const size_t ring_bytes = (size_t)L * sizeof(float);
  const bool shared = ring_bytes <= (size_t)kMaxSharedBytes;
  const size_t smem = shared ? ring_bytes : 0;
  if (smem > 16 * 1024) {  // beside the 16.5 KB of static shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        ks_blocked, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (B + 31) / 32 * 32;
  ks_blocked<<<1, threads, smem, stream>>>(rho, buf_in, r_in, ap_in_in, ap_out_in,
                                           diag, powv, y, buf_out, r_out,
                                           ap_in_out, ap_out_out, T, L, B,
                                           allpass_c, shared);
  return (int)cudaGetLastError();
}

}  // extern "C"
