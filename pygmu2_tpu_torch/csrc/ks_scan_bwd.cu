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
// L + k - 1 and L + k are walked, so with windows of W <= (L - 1) / 2
// samples the seeds of window j - 1 need only the mu of windows j + 1 and
// later, and can form while the chain walks window j.
//
// The design: the forward's pipeline (csrc/ks_scan.cu), one CUDA block of
// 256 threads. A prefix count of act compacts the active samples (idx),
// and with them rho, gy and y (comp). Windows of W = min(1024, (L - 1) / 2)
// samples, from the last; while thread 0 walks window j's chain, reading
// its seeds and writing lam in place as 16-byte shared vectors (the window
// reversed, lam after it one slot before it), warps 1-7, in this order:
// 1. form mu, grho and both tape adds of window j + 1 (just walked), one
//    thread a tape slot, its two adds in the plain version's order
//    (mu_{k} first, then mu_{k-1});
// 2. after a barrier of their own (bar 1): form and clear the seeds of
//    window j - 1, gy prefetched into registers before step 1;
// 3. stage rho and the tape of window j (its step 1 is the next
//    iteration's) with cp.async.
// One __syncthreads() a window. The tape's cotangent is a ring of L + 1
// slots (G[m] at m % (L + 1)): the slot of G[L + k] becomes that of G[k - 1]
// once its seed is read, so step 1 precedes step 2 (where 2W + 1 = L,
// window j + 1's last add lands in the slot a seed of window j - 1 reads).
// The ring lives in shared memory up to 51200 samples (the forward's
// MAX_KERNEL_L) and in a global scratch ring beyond. The last window's
// first step, lam_{K-1} = seed + gao, is formed with its seed, and the
// chain starts from a zero whose product by -c is -0: no test in the loop.
// Strings of L <= 8 (windows of at most 3 samples) take thread 0 walking
// sample by sample instead.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 200 * 1024 + 4;  // a ring of 51201 slots
constexpr int kThreads = 256;   // warp 0: the chain's thread; warps 1-7 the rest
constexpr int kHelpers = kThreads - 32;
constexpr int kWindow = 1024;   // active samples per window, at most
constexpr int kLead = 4;        // a window's lam from s_chain[b][kLead]; lam after it at [3]
constexpr int kPerHelper = (kWindow + kHelpers - 1) / kHelpers;
constexpr int kSerialMaxL = 8;  // strings this short: thread 0 walks every sample

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// helpers only (warps 1-7): a barrier that leaves thread 0 running
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kHelpers) : "memory");
}

// The chain's walk over n values in place: v[i] = step(v[i]), in order.
// Loads run eight values ahead of the chain as 16-byte vectors, results
// leave as 16-byte vectors (csrc/ks_scan.cu's walk, its input and output
// one array: every load is of a vector the walk has not written yet). v is
// 16-byte aligned and readable to n + 8.
template <class Step>
__device__ __forceinline__ void walk_in_place(float* v, int n, Step step) {
  float4* v4 = reinterpret_cast<float4*>(v);
  auto four = [&](float4 a, int i) {  // in order: step carries the chain
    const float o0 = step(a.x), o1 = step(a.y), o2 = step(a.z), o3 = step(a.w);
    v4[i / 4] = make_float4(o0, o1, o2, o3);
  };
  auto eight = [&](float4 a, float4 b, int i) {
    four(a, i);
    four(b, i + 4);
  };
  float4 f0 = v4[0], f1 = v4[1];
  int i = 0;
  for (; i + 16 <= n; i += 16) {  // two batches a turn: no register moves
    const float4 g0 = v4[i / 4 + 2], g1 = v4[i / 4 + 3];
    eight(f0, f1, i);
    f0 = v4[i / 4 + 4];
    f1 = v4[i / 4 + 5];
    eight(g0, g1, i + 8);
  }
  if (i + 8 <= n) {
    const float4 g0 = v4[i / 4 + 2], g1 = v4[i / 4 + 3];
    eight(f0, f1, i);
    f0 = g0;
    f1 = g1;
    i += 8;
  }
  const float rest[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (i + u < n) v[i + u] = step(rest[u]);
}

__global__ void __launch_bounds__(kThreads) ks_scan_bwd(
    const float* __restrict__ rho, const bool* __restrict__ act,
    const float* __restrict__ buf, const int* __restrict__ r_in,
    const float* __restrict__ y, const float* __restrict__ gy,
    const float* __restrict__ gbuf, const float* __restrict__ gai_in,
    const float* __restrict__ gao_in, float* __restrict__ grho,
    float* __restrict__ gbuf_in, float* __restrict__ gap_in,
    float* __restrict__ gap_out, int* __restrict__ idx, float* comp, float* ring_global,
    int T, int L, int W, float c, bool ring_in_shared) {
  extern __shared__ float shared_ring[];
  // a window's seeds, then its lam (in place), reversed, padded by 8 for the walk
  __shared__ __align__(16) float s_chain[2][kLead + kWindow + 8];
  __shared__ float s_rho[2][kWindow], s_tape[2][kWindow + 1];
  __shared__ int s_count[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ring = ring_in_shared ? shared_ring : ring_global;  // G[m] at m % (L + 1)
  const int R = L + 1;
  const int r0 = *r_in;
  const float gai = *gai_in, gao = *gao_in;
  // the compacted rows: rho_c (then grho_c), gy_c, y_c
  float* rho_c = comp;
  float* gy_c = comp + T;
  float* y_c = comp + 2 * (long)T;

  // ---- compaction: active sample k is the k-th set act ----
  int K = T;
  if (act != nullptr) {
    K = 0;
    for (int base = 0; base < T; base += 4 * kThreads) {
      const int t0 = base + 4 * tid;
      bool a[4];
      float vr[4], vg[4], vy[4];  // loaded beside act: one wait a tile
      int count = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = t0 + q < T;
        a[q] = in && act[t0 + q];
        vr[q] = in ? rho[t0 + q] : 0.0f;
        vg[q] = in ? gy[t0 + q] : 0.0f;
        vy[q] = in ? y[t0 + q] : 0.0f;
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
        if (a[q]) {
          idx[k] = t;
          rho_c[k] = vr[q];
          gy_c[k] = vg[q];
          y_c[k++] = vy[q];
        } else {
          grho[t] = 0.0f;
        }
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

  float lam = gai;  // thread 0's: lam of the earliest sample walked (gai before any)
  if (K > 0 && L <= kSerialMaxL) {
    if (tid == 0) {
      float lam_next = gai;
      for (int k = K - 1; k >= 0; --k) {
        const int t = sample(k);
        const int s = (int)(((long long)L + k) % R);
        const float g = __fadd_rn(ring[s], gy[t]);
        ring[s] = 0.0f;
        const float lk = k == K - 1 ? __fadd_rn(g, gao) : __fadd_rn(g, __fmul_rn(-c, lam_next));
        const float mu = __fadd_rn(__fmul_rn(c, lk), lam_next);
        const float m = __fmul_rn(mu, __fmul_rn(rho[t], 0.5f));
        grho[t] = __fmul_rn(__fmul_rn(mu, __fadd_rn(tape(k), tape(k + 1))), 0.5f);
        const int s0 = k % R, s1 = (k + 1) % R;
        ring[s0] = __fadd_rn(ring[s0], m);
        ring[s1] = __fadd_rn(ring[s1], m);
        lam_next = lk;
      }
      lam = lam_next;
    }
  } else if (K > 0) {
    const float* rc = act != nullptr ? rho_c : rho;
    const float* gc = act != nullptr ? gy_c : gy;
    const float* yc = act != nullptr ? y_c : y;
    float* grho_out = act != nullptr ? rho_c : grho;  // rho_c is staged before it is overwritten
    const int n_win = (K + W - 1) / W;
    const int h = tid - 32;  // the helper's number
    auto length = [&](int j) { return min(W, K - j * W); };
    // base + i mod m, for base < m and i < m: one wrap at most
    auto slot_in = [](int base, int i, int m) { return base + i >= m ? base + i - m : base + i; };
    auto slot = [&](int base, int i) { return slot_in(base, i, R); };
    float gyr[kPerHelper];  // gy of the seeds this helper forms next
    auto prefetch = [&](int j) {
      const int k0 = j * W, n = length(j);
#pragma unroll
      for (int q = 0; q < kPerHelper; ++q) {
        const int i = h + q * kHelpers;
        gyr[q] = i < n ? gc[k0 + i] : 0.0f;
      }
    };
    // window j's seeds G[L + k] + gy_k into s_chain[j & 1], reversed; their
    // slots cleared (they hold G[k - 1] next); the call's last also + gao
    auto seeds = [&](int j, bool last) {
      const int k0 = j * W, n = length(j), b = j & 1;
      const int sb = (L + k0) % R;
#pragma unroll
      for (int q = 0; q < kPerHelper; ++q) {
        const int i = h + q * kHelpers;
        if (i < n) {
          const int s = slot(sb, i);
          float g = __fadd_rn(ring[s], gyr[q]);
          ring[s] = 0.0f;
          if (last && i == n - 1) g = __fadd_rn(g, gao);
          s_chain[b][kLead + n - 1 - i] = g;
        }
      }
    };
    // window j's rho and tape S[k0 .. k0 + n] into s_rho / s_tape[j & 1]
    auto stage = [&](int j) {
      const int k0 = j * W, n = length(j), b = j & 1;
      const int sb = k0 < L ? (r0 + k0) % L : 0;  // the string's slot of S[k0]
      for (int i = h; i < n; i += kHelpers) cp_async4(&s_rho[b][i], rc + k0 + i);
      for (int i = h; i <= n; i += kHelpers) {
        const int k = k0 + i;
        cp_async4(&s_tape[b][i], k < L ? buf + slot_in(sb, i, L) : yc + (k - L));
      }
    };
    // window j's mu, grho and tape adds: thread i takes slot G[k0 + i],
    // i = 0 .. n: + mu_k rho_k / 2 (k = k0 + i < k0 + n), then + mu_{k-1}
    // rho_{k-1} / 2 (k > k0; G[k0]'s second add is window j - 1's)
    auto adjoint = [&](int j) {
      const int k0 = j * W, n = length(j), b = j & 1, sk = k0 % R;
      const float* lw = s_chain[b] + kLead;  // lw[n - 1 - i] = lam_{k0 + i}; lw[-1] = lam_{k0 + n}
      for (int i = h; i <= n; i += kHelpers) {
        const int s = slot(sk, i);
        float g = ring[s];
        if (i < n) {
          const float mu = __fadd_rn(__fmul_rn(c, lw[n - 1 - i]), lw[n - 2 - i]);
          g = __fadd_rn(g, __fmul_rn(mu, __fmul_rn(s_rho[b][i], 0.5f)));
          grho_out[k0 + i] =
              __fmul_rn(__fmul_rn(mu, __fadd_rn(s_tape[b][i], s_tape[b][i + 1])), 0.5f);
        }
        if (i > 0) {
          const float mu = __fadd_rn(__fmul_rn(c, lw[n - i]), lw[n - 1 - i]);
          g = __fadd_rn(g, __fmul_rn(mu, __fmul_rn(s_rho[b][i - 1], 0.5f)));
        }
        ring[s] = g;
      }
    };

    if (tid >= 32) {
      prefetch(n_win - 1);
      seeds(n_win - 1, true);
    }
    __syncthreads();
    lam = copysignf(0.0f, c);  // (-c) lam is -0: the first step adds nothing
    for (int j = n_win - 1; j >= -1; --j) {
      if (tid == 0) {
        if (j >= 0) {
          float* v = s_chain[j & 1] + kLead;
          v[-1] = j == n_win - 1 ? gai : lam;
          walk_in_place(v, length(j),
                        [&](float s) { return lam = __fadd_rn(s, __fmul_rn(-c, lam)); });
        }
      } else if (tid >= 32) {
        if (j >= 0) stage(j);
        cp_async_commit();
        if (j >= 1) prefetch(j - 1);
        if (j + 1 < n_win) adjoint(j + 1);
        helpers_sync();  // window j + 1's adds are in the ring
        if (j >= 1) seeds(j - 1, false);
        cp_async_wait_all();
      }
      __syncthreads();
    }
    if (act != nullptr) {
#pragma unroll 4
      for (int k = tid; k < K; k += kThreads) grho[idx[k]] = rho_c[k];
    }
  }
  __syncthreads();
  if (tid == 0) {
    *gap_in = K > 0 ? lam : gai;
    *gap_out = K > 0 ? __fmul_rn(-c, lam) : gao;
  }
  for (int j = tid; j < L; j += kThreads) gbuf_in[(r0 + j) % L] = ring[j % R];
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: rho / y / gy / grho (T,) f32, act (T,) bool
// or null (every sample active), buf / gbuf / gbuf_in (L,) f32, r_in ()
// i32 in [0, L), gai / gao / gap_in / gap_out () f32; scratch: idx (T,)
// i32 and comp (3, T) f32 (read only with act), ring_global (L + 1,) f32
// (read only when L > 51200). W: the window, 1 .. min(1024, (L - 1) / 2)
// (unread for L <= 8). Needs L >= 2.
int ks_scan_bwd_launch(const float* rho, const bool* act, const float* buf,
                       const int* r_in, const float* y, const float* gy,
                       const float* gbuf, const float* gai, const float* gao,
                       float* grho, float* gbuf_in, float* gap_in, float* gap_out,
                       int* idx, float* comp, float* ring_global, int T, int L, int W,
                       float allpass_c, cudaStream_t stream) {
  if (L < 2 || (L > kSerialMaxL && (W < 1 || W > kWindow || 2 * W + 1 > L)))
    return (int)cudaErrorInvalidValue;
  const size_t ring_bytes = (size_t)(L + 1) * sizeof(float);
  const bool shared = ring_bytes <= (size_t)kMaxSharedBytes;
  const size_t smem = shared ? ring_bytes : 0;
  if (smem > 20 * 1024) {  // beside the 24.1 KB of static shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        ks_scan_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ks_scan_bwd<<<1, kThreads, smem, stream>>>(rho, act, buf, r_in, y, gy, gbuf, gai, gao,
                                             grho, gbuf_in, gap_in, gap_out, idx, comp,
                                             ring_global, T, L, W, allpass_c, shared);
  return (int)cudaGetLastError();
}

}  // extern "C"
