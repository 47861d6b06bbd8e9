// The Karplus-Strong string's adjoint for Hopper (sm_90a): the cotangents
// of rho, the string and the allpass state, in either forward order.
//
// Replaces the backward of the TPU kernel pygmu2_tpu/ops/ks_pallas.py:
// ks_scan_pallas (:173, kernel_with_scan_vjp: jax.vjp of the lax.scan
// reference ks_scan_ref) and XLA's own differentiation of the all-active
// order, ops/ks_block.py:ks_blocked.
//
// What it computes (the order and roundings of ops/ks.ks_scan_bwd_ref,
// equal to it bit for bit). Active samples compacted as k = 0 .. K - 1
// (every sample when act is null: the blocked order's calls), the tape
// S[j] = buf[(r + j) % L] for j < L and S[L + k] = y of sample k, G its
// cotangent, seeded with gbuf at the slots the string holds after the
// call. Walking k down:
//   lam_k  = (G[L + k] + gy_k) + (-c) lam_{k+1}     (at K - 1: + gao)
//   mu_k   = c lam_k + lam_{k+1}                    (at K - 1: + gai)
//   grho_k = (mu_k (S[k] + S[k+1])) * 0.5
//   G[k] += mu_k (rho_k * 0.5), then G[k + 1] += the same
// and gap_in = lam_0, gap_out = -c lam_0; inactive samples get grho = 0.
// The blocked order computes the same recurrence with other roundings (its
// allpass a matrix-vector product), so its derivative is this one, taken
// at the blocked forward's own outputs.
//
// What bounds it on this card: the chain lam_k, a multiply and an add a
// sample; everything else is parallel. G[L + k] is complete once samples
// L + k - 1 and L + k are walked, so a window of W <= L - 1 samples can
// form its seeds at once from what the windows after it left.
//
// The design: one CUDA block of 256 threads. A prefix count of act
// compacts the active samples (as the forward). Then windows of W =
// min(1024, L - 1) active samples, from the last: (A) every thread forms
// a seed G[L + k] + gy_k and clears its slot; (B) thread 0 walks the
// window's chain; (C) every thread forms mu, grho and adds mu rho / 2 to
// G[k]; (D) then to G[k + 1]. Four barriers a window. Only L + 1 tape
// slots are ever live (those of k .. k + L), so G is a ring of L + 1 in
// shared memory up to 51200 samples (the forward's MAX_KERNEL_L) and in a
// global scratch ring beyond. Strings of L <= 8 (windows of at most 7
// samples) take thread 0 walking sample by sample instead. A first design:
// the window's phases do not overlap the chain.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 200 * 1024 + 4;  // a ring of 51201 slots
constexpr int kThreads = 256;
constexpr int kWindow = 1024;   // active samples per window, at most
constexpr int kSerialMaxL = 8;  // strings this short: thread 0 walks every sample

__global__ void __launch_bounds__(kThreads) ks_scan_bwd(
    const float* __restrict__ rho, const bool* __restrict__ act,
    const float* __restrict__ buf, const int* __restrict__ r_in,
    const float* __restrict__ y, const float* __restrict__ gy,
    const float* __restrict__ gbuf, const float* __restrict__ gai_in,
    const float* __restrict__ gao_in, float* __restrict__ grho,
    float* __restrict__ gbuf_in, float* __restrict__ gap_in,
    float* __restrict__ gap_out, int* __restrict__ idx, float* ring_global,
    int T, int L, int W, float c, bool ring_in_shared) {
  extern __shared__ float shared_ring[];
  __shared__ float s_g[kWindow], s_lam[kWindow + 1], s_m[kWindow];
  __shared__ int s_count[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ring = ring_in_shared ? shared_ring : ring_global;  // G[m] at m % (L + 1)
  const int R = L + 1;
  const int r0 = *r_in;
  const float gai = *gai_in, gao = *gao_in;

  // ---- compaction: active sample k is the k-th set act ----
  int K = T;
  if (act != nullptr) {
    K = 0;
    for (int base = 0; base < T; base += 4 * kThreads) {
      const int t0 = base + 4 * tid;
      bool a[4];
      int count = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = t0 + q < T && act[t0 + q];
        count += a[q] ? 1 : 0;
      }
      int incl = count;
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
        if (a[q])
          idx[k++] = t;
        else
          grho[t] = 0.0f;
      }
      K += tile;
      __syncthreads();
    }
  }
  auto sample = [&](int k) { return act != nullptr ? idx[k] : k; };
  auto tape = [&](long long j) {
    return j < L ? buf[(int)((r0 + j) % L)] : y[sample((int)(j - L))];
  };

  // ---- the seeds: G[m] = gbuf[(r0 + m) % L] for m in [K, K + L), 0 at K + L ----
  for (int i = tid; i <= L; i += kThreads) {
    const long long m = (long long)K + i;
    ring[(int)(m % R)] = i < L ? gbuf[(int)((r0 + m) % L)] : 0.0f;
  }
  __syncthreads();

  float lam0 = gai;  // lam of the earliest sample walked so far (gai before any)
  if (K > 0 && L <= kSerialMaxL) {
    if (tid == 0) {
      float lam_next = gai;
      for (int k = K - 1; k >= 0; --k) {
        const int t = sample(k);
        const int s = (int)(((long long)L + k) % R);
        const float g = __fadd_rn(ring[s], gy[t]);
        ring[s] = 0.0f;
        const float lam = k == K - 1 ? __fadd_rn(g, gao) : __fadd_rn(g, __fmul_rn(-c, lam_next));
        const float mu = __fadd_rn(__fmul_rn(c, lam), lam_next);
        const float m = __fmul_rn(mu, __fmul_rn(rho[t], 0.5f));
        grho[t] = __fmul_rn(__fmul_rn(mu, __fadd_rn(tape(k), tape(k + 1))), 0.5f);
        const int s0 = k % R, s1 = (k + 1) % R;
        ring[s0] = __fadd_rn(ring[s0], m);
        ring[s1] = __fadd_rn(ring[s1], m);
        lam_next = lam;
      }
      lam0 = lam_next;
    }
  } else if (K > 0) {
    float lam_next = gai;  // thread 0's: lam of the first sample of the window after
    for (int k0 = (K - 1) / W * W; k0 >= 0; k0 -= W) {
      const int n = min(W, K - k0);
      const int sb = (int)(((long long)L + k0) % R);  // slot of G[L + k0]
      const int sk = k0 % R;                          // slot of G[k0]
      // (A) the seeds, their slots cleared (they hold G[k - 1] next)
      for (int i = tid; i < n; i += kThreads) {
        const int s = sb + i >= R ? sb + i - R : sb + i;
        s_g[i] = __fadd_rn(ring[s], gy[sample(k0 + i)]);
        ring[s] = 0.0f;
      }
      __syncthreads();
      // (B) the chain
      if (tid == 0) {
        s_lam[n] = lam_next;
        float lam = lam_next;
        for (int i = n - 1; i >= 0; --i) {
          lam = k0 + i == K - 1 ? __fadd_rn(s_g[i], gao)
                                : __fadd_rn(s_g[i], __fmul_rn(-c, lam));
          s_lam[i] = lam;
        }
        lam_next = lam;
      }
      __syncthreads();
      // (C) mu, grho, and G[k] += mu rho / 2
      for (int i = tid; i < n; i += kThreads) {
        const int k = k0 + i, t = sample(k);
        const float mu = __fadd_rn(__fmul_rn(c, s_lam[i]), s_lam[i + 1]);
        const float m = __fmul_rn(mu, __fmul_rn(rho[t], 0.5f));
        grho[t] = __fmul_rn(__fmul_rn(mu, __fadd_rn(tape(k), tape(k + 1))), 0.5f);
        const int s = sk + i >= R ? sk + i - R : sk + i;
        ring[s] = __fadd_rn(ring[s], m);
        s_m[i] = m;
      }
      __syncthreads();
      // (D) G[k + 1] += the same
      for (int i = tid; i < n; i += kThreads) {
        const int s = sk + i + 1 >= R ? sk + i + 1 - R : sk + i + 1;
        ring[s] = __fadd_rn(ring[s], s_m[i]);
      }
      __syncthreads();
    }
    lam0 = lam_next;
  }
  __syncthreads();
  if (tid == 0) {
    *gap_in = K > 0 ? lam0 : gai;
    *gap_out = K > 0 ? __fmul_rn(-c, lam0) : gao;
  }
  for (int j = tid; j < L; j += kThreads) gbuf_in[(r0 + j) % L] = ring[j % R];
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: rho / y / gy / grho (T,) f32, act (T,) bool
// or null (every sample active), buf / gbuf / gbuf_in (L,) f32, r_in ()
// i32 in [0, L), gai / gao / gap_in / gap_out () f32; scratch: idx (T,)
// i32, ring_global (L + 1,) f32 (read only when L > 51200). W: the
// window, 1 .. min(1024, L - 1). Needs L >= 2.
int ks_scan_bwd_launch(const float* rho, const bool* act, const float* buf,
                       const int* r_in, const float* y, const float* gy,
                       const float* gbuf, const float* gai, const float* gao,
                       float* grho, float* gbuf_in, float* gap_in, float* gap_out,
                       int* idx, float* ring_global, int T, int L, int W,
                       float allpass_c, cudaStream_t stream) {
  if (L < 2 || W < 1 || W > kWindow || W > L - 1) return (int)cudaErrorInvalidValue;
  const size_t ring_bytes = (size_t)(L + 1) * sizeof(float);
  const bool shared = ring_bytes <= (size_t)kMaxSharedBytes;
  const size_t smem = shared ? ring_bytes : 0;
  if (smem > 16 * 1024) {  // beside the 12 KB of static shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        ks_scan_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ks_scan_bwd<<<1, kThreads, smem, stream>>>(rho, act, buf, r_in, y, gy, gbuf, gai,
                                             gao, grho, gbuf_in, gap_in, gap_out, idx,
                                             ring_global, T, L, W, allpass_c, shared);
  return (int)cudaGetLastError();
}

}  // extern "C"
