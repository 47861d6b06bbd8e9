// Fused audio-rate pass of the offline SoundFont render, for Hopper (sm_90a).
//
// Replaces both TPU kernels of pygmu2_tpu/soundfont/filter_pallas.py:
//   osc_filter_gain_mix_pallas         resident wavetable (<= 16384 samples)
//   osc_window_filter_gain_mix_pallas  any wavetable, per-voice VMEM windows
// One kernel serves both. The wavetable stays in global memory whatever its
// size: the ~1M-sample font is 3.8 MB and lives in the 50 MB L2, so the TPU's
// window DMA, loop views and row-table gathers have no counterpart here.
//
// What it computes: the segment pass of filter_pass.cuh over the wavetable
// oscillator (read position base + n * ratio, loop wrap by exact integer
// modulo, linear interpolation, validity mask), with the (4, P) state
// [y1; y2; x[-2]; x[-1]] carried from/to the caller.
//
// What bounds it on this card: not bytes (the 3 s, 128-voice chord reads
// ~1.2 MB of control rows and writes ~1.1 MB). The work is parallel over
// (sample, voice) but for the biquad's feedback, two dependent FMAs a
// sample: the oscillator (~35 instructions with its gathers from the
// wavetable), the FIR line, the gain ramps and the 128-voice mixdown. The
// first design ran every sample's oscillator twice in three launches (a
// zero-state pass, a serial carry over the blocks, a re-run with a
// shared-memory mixdown every 16 samples); at B = 130, P = 128, N = 1024 it
// took 0.72 ms (small font) and 0.95 ms (large font) on an H100 80GB HBM3
// at 700 W (chip_smoke.py), one warp per scheduler with each gather's
// latency in its thread's issue stream.
//
// What the design does about it: the segment pass (filter_pass.cuh), whose
// producers form the oscillator once per sample (OscSource), two tiles a
// turn, 4 samples of one voice a thread. A warp takes 8 neighbouring quads
// of 4 voices, so that a gather of its 32 lanes falls on a few cache lines,
// not on 32; 16 gathers a thread are in flight. The oscillator uses
// explicitly rounded float ops (__fmul_rn, __fadd_rn, ...) so that FMA
// contraction cannot move floor() at integer boundaries: it then equals the
// plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

#include "filter_pass.cuh"

namespace {

// Plane order of the stacked rows; must match filter_kernels._OSC_F32_ROWS
// (the oscillator's four, then the ten of FilterRow) and _OSC_I32_ROWS.
enum RowF { RATIO, BASE_FRAC, LOOPF, LS_VAL, FILTER_ROWS };
enum RowI { BASE_INT, LOOP_START, LOOP_LEN, SMP_END };

struct Osc {
  float ratio, base_frac, ls_val;
  int base_int, loop_start, loop_len, smp_end;
  bool looping;
};

__device__ __forceinline__ Osc load_osc(const float* rf, const int* ri, long plane, long idx) {
  Osc o;
  o.ratio = rf[RATIO * plane + idx];
  o.base_frac = rf[BASE_FRAC * plane + idx];
  o.ls_val = rf[LS_VAL * plane + idx];
  o.looping = rf[LOOPF * plane + idx] > 0.5f;
  o.base_int = ri[BASE_INT * plane + idx];
  o.loop_start = ri[LOOP_START * plane + idx];
  o.loop_len = ri[LOOP_LEN * plane + idx];
  o.smp_end = ri[SMP_END * plane + idx];
  return o;
}

// Oscillator sample n of a block: the arithmetic of offline._audio_pass.
__device__ __forceinline__ float osc_sample(const Osc& o, const float* __restrict__ wave,
                                            int L, int n) {
  const float offset = __fadd_rn(o.base_frac, __fmul_rn((float)n, o.ratio));
  const float off_int = floorf(offset);
  const float frac = __fsub_rn(offset, off_int);
  const int abs_idx = o.base_int + (int)off_int;
  int idx = abs_idx;
  if (o.looping) {
    int w = (abs_idx - o.loop_start) % o.loop_len;
    if (w < 0) w += o.loop_len;  // floor modulo, as torch.remainder
    idx = o.loop_start + w;
  }
  const int i0 = min(max(idx, 0), L - 2);
  const float w0 = __ldg(wave + i0);
  float w1 = __ldg(wave + i0 + 1);
  if (o.looping && i0 + 1 >= o.loop_start + o.loop_len) w1 = o.ls_val;
  const float smp = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, frac), w0), __fmul_rn(frac, w1));
  return (o.looping || abs_idx < o.smp_end) ? smp : 0.0f;
}

// The segment pass's source: the wavetable oscillator.
struct OscSource {
  static constexpr bool kState = true;
  static constexpr int kArrivals = kProducers * 32;  // every producer thread, every tile
  const float* rf;
  const int* ri;
  const float* wave;
  int L;

  __device__ const float* filter_rows(long plane) const { return rf + FILTER_ROWS * plane; }
  __device__ float sample(long plane, int b, int p, int P, int N, int n) const {
    return osc_sample(load_osc(rf, ri, plane, (long)b * P + p), wave, L, n);
  }
  __device__ static float ramp(int n, int N) { return __fdiv_rn((float)n, (float)N); }

  // A producer thread: a quad (4 samples) of one voice a tile; a warp forms
  // 8 neighbouring quads of 4 voices, so that its gathers fall on few cache
  // lines.
  struct Producer {
    Osc o;
    const float* wave;
    int L, pv, P, warp, lane;

    __device__ Producer(const OscSource& s, long plane, int b, int g, int P_, int N, int warp_,
                        int lane_)
        : o{}, wave(s.wave), L(s.L), pv(g * kV + 4 * warp_ + (lane_ >> 3)), P(P_), warp(warp_),
          lane(lane_) {
      if (pv < P) o = load_osc(s.rf, s.ri, plane, (long)b * P + pv);
    }

    __device__ void produce(float4* buf, uint64_t* full, int n0, int len, int nq,
                            int ntiles) const {
      for (int t = 0; t < ntiles; t += 2) {  // two tiles a turn: 16 gathers in flight
        float v[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int n = 4 * ((t + h) * kProducers + (lane & 7)) + c;
            const float x = osc_sample(o, wave, L, n0 + min(n, len - 1));
            v[h][c] = pv < P && n < len ? x : 0.0f;
          }
#pragma unroll
        for (int h = 0; h < 2 && t + h < ntiles; ++h) {
          const int q = (t + h) * kProducers + (lane & 7);
          if (q < nq)
            buf[slot(q, 4 * warp + (lane >> 3))] = make_float4(v[h][0], v[h][1], v[h][2], v[h][3]);
          mbar_arrive(&full[t + h]);
        }
      }
    }
  };
};

}  // namespace

extern "C" {

// Enqueues the launch on `stream` (a memset of the int scratch, then the
// kernel); returns the cudaError_t of the first step that failed (0 when
// both were accepted). Device pointers: rows_f (14, B, P) f32, rows_i (4, B,
// P) i32, wave (L,) f32, state_in / state_out (4, P) f32, out (B * N, 2)
// f32, scratch_f / scratch_i of n_f floats and n_i ints (at least
// filter_kernels._osc_scratch_sizes). Needs N >= 2, P >= 1, L >= 2.
int osc_filter_gain_mix_launch(const float* rows_f, const int* rows_i, const float* wave,
                               int L, const float* state_in, float* out, float* state_out,
                               float* scratch_f, long long n_f, int* scratch_i,
                               long long n_i, int B, int P, int N, cudaStream_t stream) {
  if (L < 2) return (int)cudaErrorInvalidValue;
  return launch_filter_pass(OscSource{rows_f, rows_i, wave, L}, state_in, out, state_out,
                            scratch_f, n_f, scratch_i, n_i, B, P, N, stream);
}

const char* pgt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
