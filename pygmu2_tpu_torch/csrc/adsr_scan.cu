// Gated / triggered ADSR state machine for Hopper (sm_90a): the gate's
// edges found in parallel, one warp walking the edges only, then every
// sample evaluated in parallel.
//
// Replaces the TPU kernel pygmu2_tpu/ops/adsr_pallas.py:adsr_scan_pallas
// (:268), which broadcasts the scalar machine across 128 lanes (a tiling
// need of the TPU, not of the machine) over a sequential grid of chunks.
//
// What it computes (the op order of adsr_scan_ref, float32): per sample,
// emit env = fma(n, slope, e0) of the current stage (0 when IDLE, sus when
// SUSTAIN); then a gate edge (gated: 0->1 attack, 1->0 release; triggered:
// g > 0 attack) restarts the segment from the emitted value with n = 0;
// then one step: the candidate fma(n + 1, slope, e0) crossing its clip
// level (attack >= 1, decay <= sus, release <= 0), or the sustain count
// n + 1 reaching sustain_samples (triggered), moves to the next stage with
// n = 0; else n = n + 1, a float32 count that stops at 2**24. The (4,)
// state is [stage, e0, n, prev_gate]; env_next, the envelope the next
// sample would emit (fma(n, slope, e0) of the state out), is what the PEs
// carry into their next block.
//
// What bounds it on this card: at the main path's block (T = 16384) it
// moves 128 KB (0.04 us at 3.35 TB/s), a few float ops a sample. The
// first design walked the machine one sample at a time in one thread:
// ~145 cycles a sample, 1.20 ms a block. But the machine's transitions
// depend only on the gate, known for the whole call, and on where linear
// ramps cross their clip levels, never on the output: between two edges a
// segment runs a fixed chain of phases (its entering stage, then DECAY
// from 1, SUSTAIN, RELEASE from sus, IDLE), and only the length of the
// entering stage depends on the segment's entering value. So only the
// edges are serial.
//
// What the design does about it: one CUDA block of 512 threads, in tiles
// of 8192 samples (the state after each tile enters the next):
// A. all threads stage the tile's gate into shared memory (16-byte loads
//    where the gate is aligned), mark the edges row by row (a warp's 32
//    neighbouring samples a ballot), and compact their indices in order
//    with a block-wide prefix count;
// B. warp 0 walks the edges: each edge's entering value is the envelope
//    the segment before emits there, and the length of its entering stage
//    is a first crossing, found exactly by the lanes testing 32 counts
//    around the real crossing (th - e0) / slope side by side with the
//    step's own rounded candidate (monotone in the count, since rounding
//    is monotone), with a 32-ary search where the window misses; the
//    chain's other phase lengths (decay from 1, the sustain count, release
//    from sus) are computed once per call;
// C. all threads find each sample's segment (the edges strictly before
//    it: an edge's own sample still emits the segment before) by a binary
//    search and evaluate its phase; 16-byte stores.
// A tile whose incoming state is not one the machine produces (a stage
// code and an integer count in [0, 2**24]), or with more than
// kSerialAbove edges, is walked per sample by one thread instead, from
// the staged gate. Every float op is the plain version's, explicitly
// rounded (__fmaf_rn), so the kernel equals it bit for bit.
// ops/adsr.py:adsr_scan_phases runs the same order in torch ops. A
// crossing is resolved only where it falls inside its segment (a single
// test of the segment's last count first): past the next edge no sample
// can tell it from none.
//
// Measured (cycle_probe.py and torch.profiler's device events; H100 80GB
// HBM3, 700 W; T = 16384): 0.013 ms on a block of the patch's gate or
// trigger (two edges; per tile ~4,800 cycles in pass A, its loads, ballots,
// prefix count and barriers, and ~4,500 in pass C), 0.087 ms on 440 edges
// (~320 cycles an edge in warp 0's walk: ~50 instructions with their
// branches and reconvergence), ~1.08 ms on an edge every sample (the
// per-sample walk, ~131 cycles a sample, ~1.07M cycles a tile; the edge
// walk there took 6.05M cycles, ~370 an edge). The walks cross near 2,850
// edges a tile, which sets kSerialAbove. The wrapper's host time per call
// (~0.04-0.05 ms) exceeds the kernel's on the patch's blocks.
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
// It accumulates its envelope sample by sample, so the closed form above
// does not apply to it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 8192;  // samples a tile
constexpr int kPer = kTile / kThreads;  // 16 rows of a tile in pass A
constexpr int kWarps = kThreads / 32;
constexpr int kNMax = 1 << 24;  // a float32 count stops here
constexpr long long kNever = 1LL << 40;  // a phase that never ends
constexpr int kNeverI = 0x7fffffff;  // kNever in an int record
constexpr int kIdle = 0, kAttack = 1, kDecay = 2, kSustain = 3, kRelease = 4;
constexpr int kRise = 1 << 30, kIdx = kRise - 1;  // an edge record: index | rise bit
// gate, edge indices, each segment's entering value and first-phase length
constexpr size_t kSmemBytes = sizeof(float) * (4 * kTile + 2);
// Past this many edges a tile, the per-sample walk (~1.07M cycles a full
// tile) beats the edge walk (~370-380 cycles an edge past a few hundred
// edges; cycle_probe.py's adsr passes, H100)
constexpr int kSerialAbove = 2816;

// A call's constants. After its entering stage a segment joins one chain:
// DECAY from 1 at 0, SUSTAIN at c_s, RELEASE from sus at c_r, IDLE at c_i.
struct Chain {
  float dA, dD, dR, sus;
  long long S;  // the float32 sustain count; kNever: gated, or past 2**24
  long long c_s, c_r, c_i;
};

// A segment: its entering stage, value and count, and how many samples it
// stays in that stage (>= 1, or kNever).
struct Seg {
  int stage;
  float e0;
  int n0;
  long long r1;
};

__device__ __forceinline__ float slope(const Chain& c, int stage) {
  return stage == kAttack ? c.dA : (stage == kDecay ? c.dD : c.dR);
}

__device__ __forceinline__ long long join(const Chain& c, int stage) {
  return stage == kAttack ? 0 : (stage == kDecay ? c.c_s : (stage == kSustain ? c.c_r : c.c_i));
}

__device__ __forceinline__ float count(long long n) {
  return (float)(n < kNMax ? n : kNMax);
}

// The envelope emitted `rel` samples into segment s.
__device__ __forceinline__ float emit(const Chain& c, const Seg& s, long long rel) {
  if (rel < s.r1) {
    if (s.stage == kIdle) return 0.0f;
    if (s.stage == kSustain) return c.sus;
    return __fmaf_rn(count(s.n0 + rel), slope(c, s.stage), s.e0);
  }
  const long long q = join(c, s.stage) + rel - s.r1;
  if (q < c.c_s) return __fmaf_rn(count(q), c.dD, 1.0f);
  if (q < c.c_r) return c.sus;
  if (q < c.c_i) return __fmaf_rn(count(q - c.c_r), c.dR, c.sus);
  return 0.0f;
}

// The machine's state [stage, e0, n] `rel` samples into segment s.
__device__ void state_at(const Chain& c, const Seg& s, long long rel, float* out) {
  if (rel < s.r1) {
    out[0] = (float)s.stage, out[1] = s.e0, out[2] = count(s.n0 + rel);
    return;
  }
  const long long q = join(c, s.stage) + rel - s.r1;
  if (q < c.c_s) {
    out[0] = kDecay, out[1] = 1.0f, out[2] = count(q);
  } else if (q < c.c_r) {
    out[0] = kSustain, out[1] = c.sus, out[2] = count(q - c.c_s);
  } else if (q < c.c_i) {
    out[0] = kRelease, out[1] = c.sus, out[2] = count(q - c.c_r);
  } else {
    out[0] = kIdle, out[1] = 0.0f, out[2] = count(q - c.c_i);
  }
}

// The first count n1 in [min(n0 + 1, 2**24), last] whose candidate
// fma(n1, d, e0) is >= th (ge) or <= th, or -1 (last <= 2**24). One warp,
// every lane with the same arguments; every lane returns the result.
__device__ int crossing(float e0, int n0, float d, float th, bool ge, int last) {
  const int lane = threadIdx.x & 31;
  const int lo = min(n0 + 1, kNMax);
  auto passes = [&](int m) {
    const float v = __fmaf_rn((float)m, d, e0);
    return ge ? v >= th : v <= th;
  };
  // a candidate that moves away from th (or stays) can pass only at first
  if (!(ge ? d > 0.0f : d < 0.0f)) return passes(lo) ? lo : -1;
  if (!passes(last)) return -1;  // monotone: none by `last`
  const float est = __fdividef(th - e0, d);  // only places the window
  int base = lo;
  if (est < (float)kNMax && floorf(est) - 15.0f > (float)lo) base = (int)(floorf(est) - 15.0f);
  base = min(base, max(lo, last - 31));
  unsigned hit = __ballot_sync(0xffffffffu, base + lane >= last || passes(base + lane));
  int a, b;  // b passes; the first count that does is in [a, b]
  if (hit & 1u) {  // the crossing is at or below the window
    if (base == lo) return lo;
    a = lo, b = base;
  } else if (hit != 0u) {
    return base + __ffs(hit) - 1;
  } else {  // above it
    a = base + 32, b = last;
  }
  while (b - a >= 32) {
    const int step = (b - a) / 32 + 1;
    const int m = a + (lane + 1) * step - 1;
    hit = __ballot_sync(0xffffffffu, m >= b || passes(m));
    const int f = __ffs(hit) - 1;
    b = min(a + (f + 1) * step - 1, b);
    a += f * step;
  }
  hit = __ballot_sync(0xffffffffu, a + lane >= b || passes(a + lane));
  return a + __ffs(hit) - 1;
}

// How many samples a segment entering `stage` with (e0, n0) stays in it,
// if that is at most `len` (the samples to its end); else kNever, which
// every sample of the segment takes the same way.
__device__ long long first_phase(const Chain& c, int stage, float e0, int n0, int len) {
  const int last = (int)min((long long)n0 + len, (long long)kNMax);
  int m;
  if (stage == kAttack) {
    m = crossing(e0, n0, c.dA, 1.0f, true, last);
  } else if (stage == kDecay) {
    m = crossing(e0, n0, c.dD, c.sus, false, last);
  } else if (stage == kRelease) {
    m = crossing(e0, n0, c.dR, 0.0f, false, last);
  } else if (stage == kSustain && c.S != kNever) {
    return c.S - n0 > 1 ? c.S - n0 : 1;  // n + 1 >= S expires
  } else {
    return kNever;
  }
  return m < 0 ? kNever : (m - n0 > 1 ? m - n0 : 1);
}

// The machine one sample at a time (thread 0): the plain version's loop,
// over the tile's staged gate; state[4] in and out.
template <bool kGated>
__device__ void walk(const float* s_gate, int n, float* y, float* state, float dA, float dD,
                     float dR, float sus, float S) {
  float stage = state[0], e0 = state[1], cnt = state[2], pg = state[3];
  for (int t = 0; t < n; ++t) {
    const float g = s_gate[t];
    const float d = stage == kAttack ? dA : (stage == kDecay ? dD : dR);
    const float env = stage == kIdle ? 0.0f
                                     : (stage == kSustain ? sus : __fmaf_rn(cnt, d, e0));
    y[t] = env;
    bool edge;
    if (kGated) {
      const bool rising = pg == 0.0f && g == 1.0f;
      const bool falling = pg == 1.0f && g == 0.0f;
      stage = rising ? kAttack : (falling ? kRelease : stage);
      edge = rising || falling;
    } else {
      edge = g > 0.0f;
      stage = edge ? kAttack : stage;
    }
    if (edge) e0 = env, cnt = 0.0f;
    const float d2 = stage == kAttack ? dA : (stage == kDecay ? dD : dR);
    const float n1 = __fadd_rn(cnt, 1.0f);
    const float cand = __fmaf_rn(n1, d2, e0);
    const bool hit_a = stage == kAttack && cand >= 1.0f;
    const bool hit_d = stage == kDecay && cand <= sus;
    const bool hit_r = stage == kRelease && cand <= 0.0f;
    const bool expire = !kGated && stage == kSustain && n1 >= S;
    const float stage2 =
        hit_a ? kDecay : (hit_d ? kSustain : (hit_r ? kIdle : (expire ? kRelease : stage)));
    e0 = hit_a ? 1.0f : ((hit_d || expire) ? sus : (hit_r ? 0.0f : e0));
    cnt = (hit_a || hit_d || hit_r || expire) ? 0.0f : n1;
    stage = stage2;
    pg = g;
  }
  state[0] = stage, state[1] = e0, state[2] = cnt, state[3] = pg;
}

template <bool kGated>
__global__ void __launch_bounds__(kThreads)
    adsr_scan(const float* __restrict__ gate, const float* __restrict__ state_in,
              float* __restrict__ env_out, float* __restrict__ state_out,
              float* __restrict__ env_next, int T, float dA, float dD, float dR, float sus,
              int sustain_samples) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_gate = reinterpret_cast<float*>(smem);
  int* s_edge = reinterpret_cast<int*>(s_gate + kTile);
  float* s_e0 = reinterpret_cast<float*>(s_edge + kTile);  // per segment
  int* s_r1 = reinterpret_cast<int*>(s_e0 + kTile + 1);    // per segment
  __shared__ Chain s_chain;
  __shared__ float s_state[4];
  __shared__ int s_rows[kPer * kWarps];  // edges in each warp's part of a row
  __shared__ int s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (warp == 0) {  // the chain every segment joins
    Chain c;
    c.dA = dA, c.dD = dD, c.dR = dR, c.sus = sus;
    const long long S = (long long)(float)sustain_samples;
    c.S = kGated || S > kNMax ? kNever : S;
    const int decay = crossing(1.0f, 0, dD, sus, false, kNMax);
    const int release = crossing(sus, 0, dR, 0.0f, false, kNMax);
    c.c_s = decay < 0 ? kNever : decay;
    c.c_r = c.c_s + (c.S == kNever ? kNever : (c.S > 1 ? c.S : 1));
    c.c_i = c.c_r + (release < 0 ? kNever : release);
    if (lane == 0) {
      s_chain = c;
      for (int i = 0; i < 4; ++i) s_state[i] = state_in[i];
    }
  }
  __syncthreads();
  const Chain c = s_chain;
  const bool vec_in = (reinterpret_cast<uintptr_t>(gate) & 15) == 0;
  const bool vec_out = (reinterpret_cast<uintptr_t>(env_out) & 15) == 0;

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    const float* g = gate + t0;
    float* y = env_out + t0;
    const float st0 = s_state[0], e00 = s_state[1], n00 = s_state[2], pg0 = s_state[3];
    const bool machine = (st0 == 0.0f || st0 == 1.0f || st0 == 2.0f || st0 == 3.0f ||
                          st0 == 4.0f) &&
                         n00 >= 0.0f && n00 <= (float)kNMax && n00 == floorf(n00);

    // ---- A. stage the gate; mark and compact the edges ----
    if (vec_in && n == kTile) {  // every load in flight at once
#pragma unroll
      for (int r = 0; r < kTile / 4 / kThreads; ++r)
        reinterpret_cast<float4*>(s_gate)[tid + r * kThreads] =
            __ldg(reinterpret_cast<const float4*>(g) + tid + r * kThreads);
    } else if (vec_in) {
      for (int i = tid; i < n / 4; i += kThreads)
        reinterpret_cast<float4*>(s_gate)[i] = __ldg(reinterpret_cast<const float4*>(g) + i);
      for (int i = (n / 4) * 4 + tid; i < n; i += kThreads) s_gate[i] = g[i];
    } else {
      for (int i = tid; i < n; i += kThreads) s_gate[i] = g[i];
    }
    __syncthreads();
    // rows of kThreads samples, sample j = r * kThreads + tid (neighbouring
    // threads on neighbouring banks); a warp's edges in a row by ballot
    unsigned mine = 0, rises = 0, masks[kPer];  // bit r: row r
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int j = r * kThreads + tid;
      bool rise = false, e = false;
      if (j < n) {
        const float gv = s_gate[j], pg = j == 0 ? pg0 : s_gate[j - 1];
        rise = kGated ? pg == 0.0f && gv == 1.0f : gv > 0.0f;
        e = rise || (kGated && pg == 1.0f && gv == 0.0f);
      }
      masks[r] = __ballot_sync(0xffffffffu, e);
      if (lane == 0) s_rows[r * kWarps + warp] = __popc(masks[r]);
      mine |= (unsigned)e << r;
      rises |= (unsigned)rise << r;
    }
    __syncthreads();
    if (warp == 0) {  // the rows' exclusive prefix counts, in sample order
      constexpr int kEach = kPer * kWarps / 32;
      int v[kEach], sum = 0;
#pragma unroll
      for (int i = 0; i < kEach; ++i) sum += v[i] = s_rows[lane * kEach + i];
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      int run = incl - sum;
#pragma unroll
      for (int i = 0; i < kEach; ++i) s_rows[lane * kEach + i] = run, run += v[i];
      if (lane == 31) s_count = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      if (mine >> r & 1u)
        s_edge[s_rows[r * kWarps + warp] + __popc(masks[r] & below)] =
            (r * kThreads + tid) | (rises >> r & 1u ? kRise : 0);
    const int K = s_count;
    __syncthreads();

    if (!machine || K > kSerialAbove) {  // one thread, per sample
      if (tid == 0)
        walk<kGated>(s_gate, n, y, s_state, dA, dD, dR, sus, (float)sustain_samples);
      __syncthreads();
      continue;
    }

    // ---- B. warp 0 walks the edges ----
    if (warp == 0) {
      int ahead = K > 0 ? s_edge[0] : n;  // the next edge, with its rise bit
      Seg s{(int)st0, e00, (int)n00, 0};
      s.r1 = first_phase(c, s.stage, s.e0, s.n0, ahead & kIdx);
      s_e0[0] = e00;  // every lane writes the same value: no branch
      s_r1[0] = (int)min(s.r1, (long long)kNeverI);
      int start = 0;
      float d = 0.0f;  // the slope of the segment's entering ramp (k > 0)
      for (int k = 0; k < K; ++k) {
        const int p = ahead & kIdx;
        const bool rise = ahead & kRise;
        ahead = k + 1 < K ? s_edge[k + 1] : n;
        const int len = (ahead & kIdx) - p;  // the new segment's samples
        const int rel = p - start;  // < 2**24: the count is exact
        // the common case in 32-bit arithmetic: an edge's segment still on
        // its entering ramp (count rel from 0)
        const float env = k > 0 && rel < s.r1 ? __fmaf_rn((float)rel, d, s.e0)
                                              : emit(c, s, rel);
        s = Seg{rise ? kAttack : kRelease, env, 0, kNever};
        // and without a search: the ramp passes its clip level, if at
        // all, only after the segment's last count
        d = rise ? c.dA : c.dR;
        const float v = __fmaf_rn((float)min(len, kNMax), d, env);
        if (!(rise ? d > 0.0f && v < 1.0f : d < 0.0f && v > 0.0f))
          s.r1 = first_phase(c, s.stage, env, 0, len);
        start = p;
        s_e0[k + 1] = env;
        s_r1[k + 1] = (int)min(s.r1, (long long)kNeverI);
      }
      if (lane == 0) {
        state_at(c, s, n - start, s_state);
        s_state[3] = s_gate[n - 1];
      }
    }
    __syncthreads();

    // ---- C. every sample from its segment ----
    auto segment = [&](int sid, Seg& s, int& start) {  // segment sid's record
      const int r1 = s_r1[sid];
      s = Seg{(int)st0, s_e0[sid], (int)n00, r1 == kNeverI ? kNever : r1};
      start = 0;
      if (sid > 0) {
        const int e = s_edge[sid - 1];
        start = e & kIdx;
        s.stage = e & kRise ? kAttack : kRelease;
        s.n0 = 0;
      }
    };
    for (int j = tid * 4; j < n; j += kThreads * 4) {
      int lo = 0, hi = K;  // the edges strictly before j
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((s_edge[mid] & kIdx) < j) lo = mid + 1; else hi = mid;
      }
      int sid = lo, start;
      Seg s;
      segment(sid, s, start);
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u > 0 && sid < K && (s_edge[sid] & kIdx) < j + u)  // an edge at j + u - 1
          segment(++sid, s, start);
        v[u] = emit(c, s, j + u - start);
      }
      if (vec_out && j + 4 <= n) {
        reinterpret_cast<float4*>(y)[j / 4] = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int u = 0; u < 4 && j + u < n; ++u) y[j + u] = v[u];
      }
    }
    __syncthreads();  // the next tile reuses the shared arrays
  }
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) state_out[i] = s_state[i];
    const float st = s_state[0];  // any code the walk carried through
    const float d = st == kAttack ? dA : (st == kDecay ? dD : dR);
    *env_next = st == kIdle ? 0.0f : (st == kSustain ? sus : __fmaf_rn(s_state[2], d, s_state[1]));
  }
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

// Enqueues one launch (one block of 512 threads) on `stream`; returns its
// cudaError_t (0 when accepted). Device pointers: gate / env (T,) f32,
// state_in / state_out (4,) f32, env_next () f32. sustain_samples < 0
// selects the gated machine.
int adsr_scan_launch(const float* gate, const float* state_in, float* env,
                     float* state_out, float* env_next, int T, float dA, float dD,
                     float dR, float sus, int sustain_samples, cudaStream_t stream) {
  const bool gated = sustain_samples < 0;
  static unsigned long long opted_in[2];  // a bit per device: the attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted_in[gated] & bit)) {
    const void* kernel = gated ? (const void*)adsr_scan<true> : (const void*)adsr_scan<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[gated] |= bit;
  }
  if (gated)
    adsr_scan<true><<<1, kThreads, kSmemBytes, stream>>>(
        gate, state_in, env, state_out, env_next, T, dA, dD, dR, sus, sustain_samples);
  else
    adsr_scan<false><<<1, kThreads, kSmemBytes, stream>>>(
        gate, state_in, env, state_out, env_next, T, dA, dD, dR, sus, sustain_samples);
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
