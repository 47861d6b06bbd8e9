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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

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
// the sum in XLA's GEMV order: eight lanes (k mod 8, below K8 = B - B % 8)
// of fused multiply-adds from 0, summed pairwise (rows below K8:
// ((l0+l1)+(l2+l3))+((l4+l5)+(l6+l7)); the rest: ((l0+l4)+(l2+l6))+
// ((l1+l5)+(l3+l7))), then the B % 8 last columns' fused multiply-adds
// from 0 added. A term with k > j is a product by 0: a chain that starts
// at +0 and adds only such products and others stays as it is, so the
// kernel may add more of them than the row has (ops/ks.ks_blocked_plan
// holds that to ks_blocked_ref bit for bit). Then ap_in = out[B - 1],
// ap_out = ap[B - 1], and the block's outputs become the string's newest B.
//
// What bounds it on this card: one block's critical path. A block of 512
// rows is ~131k multiply-adds, row j's eight chains ~j / 8 dependent each;
// blocks are serial (block n + 1 reads what block n wrote whenever
// 2B + 1 > L). On one SM the chains are bound by shared-memory loads: a
// 32-lane scalar load costs a warp ~4.5 cycles of its SMSP's share of the
// SM's 128 bytes a cycle (cycle_probe.py's microbenchmark, H100), so a step
// of a run of R rows costs ~(min(R, 8) + 1) loads for R multiply-adds. A
// small block is bound by its fixed costs instead (the barriers, the
// butterflies, the outputs: ~1,500 cycles a block). The first design (a
// thread a row, three barriers a block, the diagonals read per lane at
// distinct offsets, the last warp 16x the first's work) took ~9.4k cycles
// a block of 512, 0.17 ms at T = 16384.
//
// The design:
// - a lane holds one chain (k = l mod 8) of a run of R consecutive rows:
//   one u[k] load serves R multiply-adds, and the diagonals of
//   neighbouring rows are the same values shifted by one, so a lane loads
//   min(R, 8) of them a step (for R = 16 the run's upper half is the step
//   before's lower half), into registers two steps ahead; the eight lanes
//   of a run read neighbouring words (a second copy of the diagonals
//   shifted by eight banks keeps R = 16's four runs a warp off each
//   other's banks); a quad's steps are rounded up to the loop's unroll
//   (products by zero), so the loop has no branch;
// - four runs a warp (a quad of 4R rows): a quad a warp where the cluster
//   has a warp for each, else a short quad and a long one (q and Q - 1 -
//   q), the triangle's area shared out evenly;
// - the warps over a cluster of ncta CTAs (1 or 8; R and ncta chosen by
//   the wrapper from a sweep on the card, ops/ks.blocked_layout), a CTA
//   only as many warps as it has quads or rows: every CTA forms all of
//   the block's averages and u from its own copy of the string, each
//   row's output is written into every CTA's copy through distributed
//   shared memory, and one cluster barrier a block orders them (a relaxed
//   arrive after the averages, waited on before the first remote write);
// - the averages and u one pass, a row a thread without a barrier between
//   them (a thread forms out[j - 1] beside out[j]), rho loaded a block
//   ahead; a lane's eight-lane sums by a butterfly of shuffles (fadd
//   commutes: XLA's pairwise order whatever lane keeps the sum); the B % 8
//   last rows' own terms formed before the chains, their lanes summed
//   through shared memory in their own order;
// - y staged in CTA 0's shared memory (a cluster's rows written there
//   through distributed shared memory) and stored in 16-byte pieces once
//   every few blocks (before the next block could wrap the stage), not a
//   scalar store a row.
// (One barrier a block, each warp forming the u its chains read, and a
// thread a row measured slower at every chain string: PERF.md row 7.)
// The string lives in shared memory up to 51200 samples (every CTA a
// copy; the kernel is built for each address space), beyond that in
// buf_out (one CTA, R = 16).

constexpr int kBlockedMaxB = 512;
constexpr int kBlockedMaxThreads = 512;  // a row a thread for the averages (B <= 512)
constexpr int kBlockedWarps = kBlockedMaxThreads / 32;
// zeros below diagonal 0: a lane's steps reach 8 (64 + 3 + 2) + 7 below its
// first row (a long quad's steps, rounded up, and two loaded ahead)
constexpr int kDiagPad = 576;
constexpr int kDiagLen = 1120;           // kDiagPad + 512 + 32, a multiple of 32 words
constexpr int kDiagShift = kDiagLen + 8; // the second copy: eight banks on
constexpr int kULen = kBlockedMaxB + 64; // u with zeros past K8 (the same steps)
constexpr int kYLen = 2048;              // y's stage: stored before a block could wrap it

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One lane's chain over a run of R rows from row j0, chain l, `steps`
// steps: acc[i] += D[j0 + i - k] u[k], k = 8s + l (D, u zero-padded).
// Each step's new diagonals and u are loaded two steps ahead (one warp an
// SMSP: no other warp hides a load's latency).
template <int R>
__device__ __forceinline__ void run_chain(const float* __restrict__ D,
                                          const float* __restrict__ uz, int j0, int l,
                                          int steps, float (&acc)[R]) {
  constexpr int V = R < 8 ? R : 8;            // new diagonal values a step
  constexpr int P = 2;                        // steps loaded ahead
  constexpr int NB = P + (R > 8 ? 2 : 1);     // windows in registers
  float win[NB][V], uu[NB];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  const int b0 = j0 - l;  // step s's window starts at D[b0 - 8 s]
  auto load = [&](int slot, int s) {
#pragma unroll
    for (int v = 0; v < V; ++v) win[slot][v] = D[b0 - 8 * s + v];
    uu[slot] = uz[8 * s + l];
  };
  if (R > 8) {
#pragma unroll
    for (int v = 0; v < 8; ++v) win[NB - 1][v] = D[b0 + 8 + v];  // rows 8..15 of step 0
  }
#pragma unroll
  for (int k = 0; k < P; ++k) load(k, k);
  for (int s = 0; s < steps; s += NB) {  // steps: a multiple of NB (blocked_steps)
#pragma unroll
    for (int ph = 0; ph < NB; ++ph) {
      load((ph + P) % NB, s + ph + P);  // padded past the end
      const int cur = ph, prv = (ph + NB - 1) % NB;
#pragma unroll
      for (int i = 0; i < R; ++i)
        acc[i] = __fmaf_rn(i < 8 ? win[cur][i < 8 ? i : 0] : win[prv][i < 8 ? 0 : i - 8], uu[cur],
                           acc[i]);
    }
  }
}

// A quad's steps: its rows' chains below K8, rounded up to run_chain's
// unroll (the steps past a row's own terms add products by 0)
template <int R>
__device__ __forceinline__ int quad_steps(int q, int K8) {
  constexpr int NB = R > 8 ? 4 : 3;
  return (min(4 * R * (q + 1), K8) / 8 + NB - 1) / NB * NB;
}

// The eight lanes' sums of R rows by a butterfly (masks 1, 2, 4): lane l
// keeps max(R / 8, 1) of them, rows first_row(l) + i; a step with one
// value left adds it to its partner's on both lanes.
template <int R>
__device__ __forceinline__ void butterfly(float (&v)[R], int l) {
  int n = R;
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) {
    const bool upper = l & m;
    if (n > 1) {
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        if (i < n / 2) {
          const float send = upper ? v[i] : v[i + n / 2];
          const float keep = upper ? v[i + n / 2] : v[i];
          v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, m));
        }
      }
      n /= 2;
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], m));
    }
  }
}
template <int R>
__device__ __forceinline__ int first_row(int l) {
  return (l & 1 ? R / 2 : 0) + (R >= 4 && (l & 2) ? R / 4 : 0) + (R >= 8 && (l & 4) ? R / 8 : 0);
}
template <int R>
__device__ __forceinline__ bool row_writer(int l) {  // lanes holding a row alone, or the first of two
  return (R >= 4 || !(l & 2)) && (R >= 8 || !(l & 4));
}

template <int R, bool kShared>
__global__ void __launch_bounds__(kBlockedMaxThreads) ks_blocked(
    const float* __restrict__ rho, const float* __restrict__ buf_in,
    const int* __restrict__ r_in, const float* __restrict__ ap_in_in,
    const float* __restrict__ ap_out_in, const float* __restrict__ diag,
    const float* __restrict__ powv, float* __restrict__ y, float* buf_out,
    int* __restrict__ r_out, float* __restrict__ ap_in_out,
    float* __restrict__ ap_out_out, int T, int L, int B, float c, int ncta) {
  namespace cg = cooperative_groups;
  extern __shared__ float shared_ring[];
  __shared__ __align__(16) float s_D[kDiagShift + kDiagLen];  // two copies, zero-padded
  __shared__ __align__(16) float s_uz[kULen];   // the lanes' u: zero past min(nb, K8)
  __shared__ float s_u[kBlockedMaxB];           // u, for the B % 8 last rows' tail
  __shared__ float s_pow[kBlockedMaxB];
  __shared__ float s_tail[8][8];                // the last rows' eight lane sums
  __shared__ float s_tail_e[8];                 // and their own terms
  __shared__ float s_ai[2];
  __shared__ __align__(16) float s_y[kYLen];    // y staged (CTA 0): a ring of kYLen samples
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, l = lane & 7, g = lane >> 3;
  const int rank = ncta > 1 ? (int)cg::this_cluster().block_rank() : 0;
  // the string's address space known to the compiler: shared-memory loads
  float* ring = kShared ? shared_ring : buf_out;
  for (int i = tid; i < L; i += nthr) ring[i] = buf_in[i];
  for (int i = tid; i < kDiagLen; i += nthr) {
    const int d = i - kDiagPad;
    const float v = d >= 0 && d < B ? diag[d] : 0.0f;
    s_D[i] = v;
    s_D[kDiagShift + i] = v;
  }
  for (int i = tid; i < kULen; i += nthr) s_uz[i] = 0.0f;
  for (int i = tid; i < B; i += nthr) s_pow[i] = powv[i];
  const int r0 = *r_in;
  float ai = *ap_in_in, ao = *ap_out_in;
  const int K8 = B & ~7;
  // this warp's quads (ops/ks.blocked_quads): global warp w = local * ncta + rank;
  // a quad a warp where the cluster has a warp for each, else a short one
  // and a long one
  const int quads = ((B + R - 1) / R + 3) / 4;
  const bool pair = quads > ncta * kBlockedWarps;
  const int warps = pair ? (quads + 1) / 2 : quads;
  const int w = (tid >> 5) * ncta + rank;
  const int qa = w < warps ? w : -1;
  const int qb = pair && w < warps && quads - 1 - w != w ? quads - 1 - w : -1;
  // R = 16: the warp's runs 2 and 3 read the shifted copy
  const float* D = s_D + (R == 16 && g >= 2 ? kDiagShift : 0) + kDiagPad;
  // rho a block ahead: row j = tid's, and row j - 1's
  float rho_j, rho_p;
  auto fetch = [&](int n0) {
    const int j = tid;
    rho_j = j < B && n0 + j < T ? rho[n0 + j] : 0.0f;
    rho_p = j >= 1 && j <= B && n0 + j - 1 < T ? rho[n0 + j - 1] : 0.0f;
  };
  fetch(0);
  if (ncta > 1) {
    cluster_arrive_release();  // every CTA running, its string loaded
    cluster_wait();
  } else {
    __syncthreads();
  }
  float* y_stage = ncta > 1 ? cg::this_cluster().map_shared_rank(s_y, 0) : s_y;
  int sb = r0;  // the slot of the block's oldest value
  int par = 0, flushed = 0;
  for (int n0 = 0; n0 < T; n0 += B, par ^= 1) {
    const int nb = min(B, T - n0);
    // ---- the averages and u, all rows, each CTA ----
    if (n0 > 0) ao = ring[sb == 0 ? L - 1 : sb - 1], ai = s_ai[par ^ 1];
    {
      const int j = tid;  // B <= nthr: a row a thread
      if (j < nb) {
        int s0 = sb + j;
        if (s0 >= L) s0 -= L;  // j < B < L
        const int s1 = s0 + 1 == L ? 0 : s0 + 1, sp = s0 == 0 ? L - 1 : s0 - 1;
        const float out = __fmul_rn(__fmul_rn(rho_j, __fadd_rn(ring[s0], ring[s1])), 0.5f);
        float u;
        if (j == 0) {
          u = __fmaf_rn(c, out, ai);
        } else {
          const float prev = __fmul_rn(__fmul_rn(rho_p, __fadd_rn(ring[sp], ring[s0])), 0.5f);
          u = __fadd_rn(__fmul_rn(c, out), prev);
        }
        s_u[j] = u;
        s_uz[j] = j < K8 ? u : 0.0f;
        if (j == nb - 1) s_ai[par] = out;
      } else if (j < B) {
        s_uz[j] = 0.0f;  // a part block: its missing rows' terms are products by 0
      }
    }
    if (n0 + B < T) fetch(n0 + B);
    __syncthreads();
    if (ncta > 1) cluster_arrive_relaxed();  // this CTA is done reading its string
    auto emit = [&](int j, float ap) {  // row j's output: every CTA's string, y's stage
      y_stage[(n0 + j) & (kYLen - 1)] = ap;
      int slot = sb + j;
      if (slot >= L) slot -= L;
      if (ncta > 1) {
        for (int r = 0; r < ncta; ++r) cg::this_cluster().map_shared_rank(ring, r)[slot] = ap;
      } else {
        ring[slot] = ap;
      }
    };
    // ---- the B % 8 last rows' own terms (k >= K8), off the chains'
    // path: lane l < B - K8 of the warp holding them ----
    if (K8 < B && (qa == (K8 / (4 * R)) || qb == (K8 / (4 * R))) && lane < B - K8) {
      const int j = K8 + lane;
      float e = 0.0f;
      for (int k = K8; k <= j; ++k) e = __fmaf_rn(D[j - k], s_u[k], e);
      s_tail_e[lane] = e;
    }
    // ---- the rows: a run or two of R a lane ----
    constexpr int H = R >= 8 ? R / 8 : 1;
    float h[2][H];
    int rows[2] = {-1, -1};
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const int q = which ? qb : qa;
      if (q >= 0) {  // warp-uniform
        const int j0 = 4 * R * q + R * g;
        float acc[R];
        run_chain<R>(D, s_uz, j0, l, quad_steps<R>(q, K8), acc);
#pragma unroll
        for (int i = 0; i < R; ++i)  // the last rows: their lanes' raw sums
          if (j0 + i >= K8 && j0 + i < B) s_tail[j0 + i - K8][l] = acc[i];
        butterfly<R>(acc, l);
#pragma unroll
        for (int i = 0; i < H; ++i) h[which][i] = acc[i];
        rows[which] = j0 + first_row<R>(l);
      }
    }
    __syncwarp();
    if (ncta > 1) cluster_wait();  // every CTA has read its string: safe to write into it
    // ---- the outputs ----
    if (row_writer<R>(l)) {
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        if (rows[which] >= 0) {
#pragma unroll
          for (int i = 0; i < H; ++i) {
            const int j = rows[which] + i;
            if (j >= nb) continue;
            float hsum = h[which][i], e = 0.0f;
            if (j >= K8) {  // the tail: its lanes' own pairwise order, then its own terms
              const float* a = s_tail[j - K8];
              hsum = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[4]), __fadd_rn(a[2], a[6])),
                               __fadd_rn(__fadd_rn(a[1], a[5]), __fadd_rn(a[3], a[7])));
              e = s_tail_e[j - K8];
            }
            emit(j, __fmaf_rn(s_pow[j], ao, __fadd_rn(hsum, e)));
          }
        }
      }
    }
    if (ncta > 1) {
      __syncwarp();
      cluster_arrive_release();  // this block's outputs are in every CTA's string
      cluster_wait();
    } else {
      __syncthreads();
    }
    // ---- y from its stage (CTA 0), in 16-byte pieces, before the next
    // block could overwrite what is not yet stored ----
    const int done = n0 + nb;
    if (rank == 0 && (done == T || done - flushed + 2 * B > kYLen)) {
      const int hi = done == T ? T : done & ~3, hi4 = hi & ~3;
      for (int i = flushed + 4 * tid; i < hi4; i += 4 * nthr)  // flushed: a multiple of 4
        *reinterpret_cast<float4*>(y + i) =
            *reinterpret_cast<const float4*>(s_y + (i & (kYLen - 1)));
      for (int i = hi4 + tid; i < hi; i += nthr) y[i] = s_y[i & (kYLen - 1)];
      flushed = hi;
    }
    sb += nb;
    if (sb >= L) sb -= L;
  }
  if (rank == 0) {
    if (tid == 0) {
      *r_out = sb;
      *ap_in_out = s_ai[par ^ 1];
      *ap_out_out = ring[sb == 0 ? L - 1 : sb - 1];
    }
    if (kShared)
      for (int i = tid; i < L; i += nthr) buf_out[i] = ring[i];
  }
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

// The blocked order (all samples active, L >= 16): one launch on `stream`
// of a cluster of ncta CTAs (1 or 8) of R rows a run (2 or 8;
// ops/ks.blocked_layout); returns its cudaError_t. diag (B,) f32: (-c)^d,
// d = 0 .. B - 1; powv (B,) f32: (-c)^(j+1); B = min(L - 1, 512); y
// 16-byte aligned. Other pointers as ks_scan_launch. A string past shared
// memory takes ncta = 1 and R = 16.
int ks_blocked_launch(const float* rho, const float* buf_in, const int* r_in,
                      const float* ap_in_in, const float* ap_out_in,
                      const float* diag, const float* powv, float* y,
                      float* buf_out, int* r_out, float* ap_in_out,
                      float* ap_out_out, int T, int L, int B, int R, int ncta,
                      float allpass_c, cudaStream_t stream) {
  if (L < 16 || B < 1 || B > kBlockedMaxB || B > L - 1) return (int)cudaErrorInvalidValue;
  const size_t ring_bytes = (size_t)L * sizeof(float);
  const bool shared = ring_bytes <= (size_t)kMaxSharedBytes;
  if (!(ncta == 1 || ncta == 8) || (shared ? !(R == 2 || R == 8) : ncta != 1 || R != 16) ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int quads = ((B + R - 1) / R + 3) / 4;
  const int warps = quads > ncta * kBlockedWarps ? (quads + 1) / 2 : quads;
  if (warps > ncta * kBlockedWarps) return (int)cudaErrorInvalidValue;
  const size_t smem = shared ? ring_bytes : 0;
  // a row a thread for the averages, and a warp for each of the CTA's quads
  const int threads = 32 * max((B + 31) / 32, (warps + ncta - 1) / ncta);
  const void* kernel = !shared ? (const void*)ks_blocked<16, false>
                       : R == 8 ? (const void*)ks_blocked<8, true>
                                : (const void*)ks_blocked<2, true>;
  if (smem > 24 * 1024) {  // beside the ~24 KB of static shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ncta);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&rho, (void*)&buf_in, (void*)&r_in, (void*)&ap_in_in,
                  (void*)&ap_out_in, (void*)&diag, (void*)&powv, (void*)&y,
                  (void*)&buf_out, (void*)&r_out, (void*)&ap_in_out, (void*)&ap_out_out,
                  (void*)&T, (void*)&L, (void*)&B, (void*)&allpass_c, (void*)&ncta};
  return (int)cudaLaunchKernelExC(&cfg, kernel, args);
}

}  // extern "C"
