// Biquad + gain ramps + stereo mix over precomputed oscillator samples, for
// Hopper (sm_90a).
//
// Replaces pygmu2_tpu/soundfont/filter_pallas.py:filter_gain_mix_pallas (body
// in _make_kernel and _filter_mix_math): the unfused audio pass of the offline
// SoundFont render, taken where the wavetable is too large for the resident
// kernel and the schedule's pitch ratios too high for the windowed one. Per
// voice p and sample t of MIDI block b (T = B * N), from zero state:
//   y[t]  DF1 biquad of xt[t, p], coefficients constant within a MIDI block;
//         a block whose `freshf` is set starts a new note epoch with zero
//         y-state and zero FIR inputs
//   out   L/R = sum over voices of y[t] * per-block gain ramp (pos * (1 / N))
//
// What bounds it on this card: bytes (the high-register 3 s score reads 68 MB
// of xt: ~0.02 ms at 3.35 TB/s), but for the biquad's feedback, two dependent
// FMAs a sample along T, and the reduction over voices behind every output
// sample. The first design took 1.14 ms at T = 133,120, P = 128 on an H100
// 80GB HBM3 at 700 W (chip_smoke.py): three launches (a zero-state pass of
// N = 1024 dependent steps a thread, each step's load in its own issue
// stream; a serial carry of 128 threads over the 130 blocks through ten
// global planes; a re-run of the chain with a shared-memory mix every 16
// samples).
//
// What the design does about it: the fused pass's design (filter_pass.cuh,
// one launch, the chain alone serial, the entering states and the mix in a
// fixed order) with the oscillator read from memory (XtSource): the producer
// warps copy each tile of 32 samples x 32 voices of xt into the swizzled
// segment, a 4-sample x 4-voice block a thread (16-byte loads, a warp's load
// four full 128-byte lines; one turn's loads in flight while the turn before
// is transposed into the segment). The two samples of xt before a segment
// feed the FIR line (zero before the first block and at an epoch's start).
// The pass renders from zero state and returns no state.
//
// Tolerance: the TPU kernel (and its plain version, soundfont/filter_kernels.
// filter_gain_mix_ref) scans each 128-sample chunk in Kogge-Stone order; this
// kernel recurs sample by sample within 512-sample segments, its multiply-adds
// contracted into FMAs, and sums the voices in another order. It holds the
// plain version within 2e-5 * max(1, peak), the bound the JAX package's tests
// hold the TPU kernel to against its reference (tests/test_filter_pallas.py);
// filter_kernels.filter_gain_mix_cut computes in its order in torch ops.

#include <cuda_runtime.h>
#include <cstdint>

#include "filter_pass.cuh"

namespace {

// The segment pass's source: xt, (B * N, P) f32, read from memory.
struct XtSource {
  static constexpr bool kState = false;
  static constexpr int kArrivals = 64;  // two producer warps copy each tile
  const float* xt;
  const float* rows;  // the (10, B, P) planes of FilterRow
  bool vec;           // P % 4 == 0 and xt 16-byte aligned

  __device__ const float* filter_rows(long) const { return rows; }
  __device__ float sample(long, int b, int p, int P, int N, int n) const {
    return __ldg(xt + ((long)b * N + n) * P + p);
  }
  __device__ static float ramp(int n, int N) { return __fmul_rn((float)n, __frcp_rn((float)N)); }

  // A producer thread: a block of 4 samples (quad `q`) x 4 voices of each
  // tile it takes. Warp w takes tiles w / 2 + 4 k (turn k); its lane l the
  // voices 4 (l % 8) .. + 3 of the block of 32 and quad (l / 8) + 4 (w % 2)
  // of the tile, so that a warp's 16-byte load covers four rows' 128 bytes.
  struct Producer {
    const float* xt;
    long row0;  // the MIDI block's first row of xt
    int P, vbase, jv, qi, sub;
    bool vec;

    __device__ Producer(const XtSource& s, long, int b, int g, int P_, int N, int warp, int lane)
        : xt(s.xt), row0((long)b * N), P(P_), vbase(g * kV + 4 * (lane & 7)), jv(lane & 7),
          qi((lane >> 3) + 4 * (warp & 1)), sub(warp >> 1), vec(s.vec) {}

    // rows n0 + 4q .. + 3 of quad q of turn k's tile, voices vbase .. + 3
    __device__ void load(int k, int n0, int len, float4 (&x)[4]) const {
      const int q = (4 * k + sub) * (kTileLen / 4) + qi;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 4 * q + c;
        x[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (n >= len) continue;
        const float* r = xt + (row0 + n0 + n) * P + vbase;
        if (vec) {
          if (vbase < P) x[c] = __ldg(reinterpret_cast<const float4*>(r));
        } else {
          x[c].x = vbase < P ? __ldg(r) : 0.0f;
          x[c].y = vbase + 1 < P ? __ldg(r + 1) : 0.0f;
          x[c].z = vbase + 2 < P ? __ldg(r + 2) : 0.0f;
          x[c].w = vbase + 3 < P ? __ldg(r + 3) : 0.0f;
        }
      }
    }

    __device__ void produce(float4* buf, uint64_t* full, int n0, int len, int nq,
                            int ntiles) const {
      float4 cur[4];
      load(0, n0, len, cur);
      for (int k = 0; 4 * k < ntiles; ++k) {
        float4 nxt[4];
        load(k + 1, n0, len, nxt);  // zeros past the segment
        const int t = 4 * k + sub, q = t * (kTileLen / 4) + qi;
        if (t < ntiles) {
          if (q < nq) {  // the 4 x 4 block transposed: a quad of each voice
            buf[slot(q, 4 * jv)] = make_float4(cur[0].x, cur[1].x, cur[2].x, cur[3].x);
            buf[slot(q, 4 * jv + 1)] = make_float4(cur[0].y, cur[1].y, cur[2].y, cur[3].y);
            buf[slot(q, 4 * jv + 2)] = make_float4(cur[0].z, cur[1].z, cur[2].z, cur[3].z);
            buf[slot(q, 4 * jv + 3)] = make_float4(cur[0].w, cur[1].w, cur[2].w, cur[3].w);
          }
          mbar_arrive(&full[t]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) cur[c] = nxt[c];
      }
    }
  };
};

}  // namespace

extern "C" {

// Enqueues the pass on `stream` (a memset of the int scratch, then the
// kernel); returns the cudaError_t of the first step that failed (0 when
// both were accepted). Device pointers: xt (B * N, P) f32, rows (10, B, P)
// f32, out (B * N, 2) f32, scratch_f / scratch_i of n_f floats and n_i ints
// (at least filter_kernels._osc_scratch_sizes). Needs N >= 2, P >= 1.
int filter_gain_mix_launch(const float* xt, const float* rows, float* out, float* scratch_f,
                           long long n_f, int* scratch_i, long long n_i, int B, int P, int N,
                           cudaStream_t stream) {
  const bool vec = P % 4 == 0 && (reinterpret_cast<uintptr_t>(xt) & 15) == 0;
  return launch_filter_pass(XtSource{xt, rows, vec}, nullptr, out, nullptr, scratch_f, n_f,
                            scratch_i, n_i, B, P, N, stream);
}

}  // extern "C"
