// Fused audio-rate pass of the offline SoundFont render, for Hopper (sm_90a).
//
// Replaces both TPU kernels of pygmu2_tpu/soundfont/filter_pallas.py:
//   osc_filter_gain_mix_pallas         resident wavetable (<= 16384 samples)
//   osc_window_filter_gain_mix_pallas  any wavetable, per-voice VMEM windows
// One kernel serves both. The wavetable stays in global memory whatever its
// size: the ~1M-sample font is 3.8 MB and lives in the 50 MB L2, so the TPU's
// window DMA, loop views and row-table gathers have no counterpart here.
//
// What it computes, per voice p and sample t of MIDI block b (T = B * N):
//   x[t]  wavetable oscillator: read position base + n * ratio, loop wrap
//         (exact integer modulo), linear interpolation, validity mask
//   y[t]  DF1 biquad, coefficients constant within a MIDI block; a block
//         whose `freshf` is set starts a new note epoch with zero state
//   out   L/R = sum over voices of y[t] * per-block gain ramp
// and the (4, P) state [y1; y2; x[-2]; x[-1]] carried from/to the caller.
//
// What bounds it on this card: not bytes. The 3 s, 128-voice chord reads
// ~1.2 MB of control rows and writes ~1.1 MB of output. The bounds are the
// biquad's serial dependence along T (two dependent FMAs per sample per
// voice) and the 128-way reduction over voices behind every output sample.
//
// What the design does about it: a block's response is affine in its
// incoming (y1, y2), so the serial chain is cut at MIDI-block boundaries.
//   1. zero_state: one thread per (block, voice) runs its N samples from zero
//      y-state and records the end state and the block's transition A^N.
//      The FIR inputs before the block are recomputed: the previous block's
//      last two oscillator samples.
//   2. carry: one thread per voice composes the true incoming state of every
//      block, serially over B (a few FMAs per block).
//   3. render: one CUDA block per MIDI block, one thread per voice, re-runs
//      the block from its true state, applies the gain ramps, and reduces over
//      voices through shared memory into L/R.
// The longest serial chain is N samples (plus B short steps) instead of T.
//
// The oscillator uses explicitly rounded float ops (__fmul_rn, __fadd_rn, ...)
// so that FMA contraction cannot move floor() at integer boundaries: it then
// equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

// Plane order of the stacked rows; must match filter_kernels._OSC_F32_ROWS
// and _OSC_I32_ROWS.
enum RowF { RATIO, BASE_FRAC, LOOPF, LS_VAL, B0, B1, B2, A1, A2, FRESHF,
            PGL, GL, PGR, GR };
enum RowI { BASE_INT, LOOP_START, LOOP_LEN, SMP_END };
// Scratch planes, each (B, P).
enum Scratch { TAIL2, TAIL1, ZS1, ZS2, M11, M12, M21, M22, YIN1, YIN2 };

constexpr float kNonAudible = 1.0e-3f;  // params.NON_AUDIBLE
constexpr int kTile = 16;               // samples per mixdown tile
constexpr int kMaxVoices = 256;         // filter_kernels._MAX_VOICES

struct Osc {
  float ratio, base_frac, ls_val;
  int base_int, loop_start, loop_len, smp_end;
  bool looping;
};

__device__ __forceinline__ Osc load_osc(const float* rf, const int* ri,
                                        long plane, long idx) {
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
__device__ __forceinline__ float osc_sample(const Osc& o, const float* wave,
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
  const float smp =
      __fadd_rn(__fmul_rn(__fsub_rn(1.0f, frac), w0), __fmul_rn(frac, w1));
  return (o.looping || abs_idx < o.smp_end) ? smp : 0.0f;
}

// Gain ramp within a block, as offline._audio_pass's gain_grid.
__device__ __forceinline__ float gain_at(float prev, float cur, float ramp) {
  if (fmaxf(prev, cur) < kNonAudible) return 0.0f;
  if (fabsf(__fsub_rn(cur, prev)) < 1.0e-3f) return cur;
  return __fadd_rn(prev, __fmul_rn(__fsub_rn(cur, prev), ramp));
}

__global__ void zero_state(const float* __restrict__ rf,
                           const int* __restrict__ ri,
                           const float* __restrict__ wave, int L,
                           const float* __restrict__ state_in, int B, int P,
                           int N, float* __restrict__ scratch) {
  const long plane = (long)B * P;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int b = (int)(idx / P);
  const int p = (int)(idx % P);
  const Osc o = load_osc(rf, ri, plane, idx);
  const float b0 = rf[B0 * plane + idx], b1 = rf[B1 * plane + idx];
  const float b2 = rf[B2 * plane + idx], a1 = rf[A1 * plane + idx];
  const float a2 = rf[A2 * plane + idx];
  const bool fresh = rf[FRESHF * plane + idx] > 0.5f;

  // FIR inputs before the block: zero at an epoch start, the carried
  // tail at the call's first block, else the previous block's last two
  float xm2 = 0.0f, xm1 = 0.0f;
  if (!fresh) {
    if (b == 0) {
      xm2 = state_in[2 * P + p];
      xm1 = state_in[3 * P + p];
    } else {
      const Osc q = load_osc(rf, ri, plane, idx - P);
      xm2 = osc_sample(q, wave, L, N - 2);
      xm1 = osc_sample(q, wave, L, N - 1);
    }
  }
  scratch[TAIL2 * plane + idx] = xm2;
  scratch[TAIL1 * plane + idx] = xm1;

  float x1 = xm1, x2 = xm2, y1 = 0.0f, y2 = 0.0f;
  for (int n = 0; n < N; ++n) {
    const float x = osc_sample(o, wave, L, n);
    const float y = b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
    x2 = x1;
    x1 = x;
    y2 = y1;
    y1 = y;
  }
  scratch[ZS1 * plane + idx] = y1;
  scratch[ZS2 * plane + idx] = y2;

  // M = A^N for the companion matrix A = [[-a1, -a2], [1, 0]]
  float r11 = 1.0f, r12 = 0.0f, r21 = 0.0f, r22 = 1.0f;
  float p11 = -a1, p12 = -a2, p21 = 1.0f, p22 = 0.0f;
  for (int e = N; e > 0; e >>= 1) {
    if (e & 1) {
      const float t11 = r11 * p11 + r12 * p21, t12 = r11 * p12 + r12 * p22;
      const float t21 = r21 * p11 + r22 * p21, t22 = r21 * p12 + r22 * p22;
      r11 = t11; r12 = t12; r21 = t21; r22 = t22;
    }
    const float s11 = p11 * p11 + p12 * p21, s12 = p11 * p12 + p12 * p22;
    const float s21 = p21 * p11 + p22 * p21, s22 = p21 * p12 + p22 * p22;
    p11 = s11; p12 = s12; p21 = s21; p22 = s22;
  }
  scratch[M11 * plane + idx] = r11;
  scratch[M12 * plane + idx] = r12;
  scratch[M21 * plane + idx] = r21;
  scratch[M22 * plane + idx] = r22;
}

__global__ void carry(const float* __restrict__ rf,
                      const float* __restrict__ state_in, int B, int P,
                      float* __restrict__ scratch) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const long plane = (long)B * P;
  float s1 = state_in[p], s2 = state_in[P + p];
  for (int b = 0; b < B; ++b) {
    const long idx = (long)b * P + p;
    if (rf[FRESHF * plane + idx] > 0.5f) {
      s1 = 0.0f;
      s2 = 0.0f;
    }
    scratch[YIN1 * plane + idx] = s1;
    scratch[YIN2 * plane + idx] = s2;
    const float n1 = scratch[ZS1 * plane + idx] +
                     scratch[M11 * plane + idx] * s1 +
                     scratch[M12 * plane + idx] * s2;
    const float n2 = scratch[ZS2 * plane + idx] +
                     scratch[M21 * plane + idx] * s1 +
                     scratch[M22 * plane + idx] * s2;
    s1 = n1;
    s2 = n2;
  }
}

__global__ void render(const float* __restrict__ rf, const int* __restrict__ ri,
                       const float* __restrict__ wave, int L, int B, int P,
                       int N, const float* __restrict__ scratch,
                       float* __restrict__ out, float* __restrict__ state_out) {
  __shared__ float mix[2][kTile][kMaxVoices];
  const long plane = (long)B * P;
  const int b = blockIdx.x;
  const int p = threadIdx.x;
  const bool voice = p < P;
  const long idx = (long)b * P + p;
  const int lanes = blockDim.x;  // a multiple of 32, >= P

  Osc o{};
  float b0 = 0, b1 = 0, b2 = 0, a1 = 0, a2 = 0;
  float pgl = 0, gl = 0, pgr = 0, gr = 0;
  float x1 = 0, x2 = 0, y1 = 0, y2 = 0;
  if (voice) {
    o = load_osc(rf, ri, plane, idx);
    b0 = rf[B0 * plane + idx]; b1 = rf[B1 * plane + idx];
    b2 = rf[B2 * plane + idx]; a1 = rf[A1 * plane + idx];
    a2 = rf[A2 * plane + idx];
    pgl = rf[PGL * plane + idx]; gl = rf[GL * plane + idx];
    pgr = rf[PGR * plane + idx]; gr = rf[GR * plane + idx];
    x2 = scratch[TAIL2 * plane + idx];
    x1 = scratch[TAIL1 * plane + idx];
    y1 = scratch[YIN1 * plane + idx];
    y2 = scratch[YIN2 * plane + idx];
  }

  const int warp = p >> 5, lane = p & 31, n_warps = lanes >> 5;
  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int cnt = min(kTile, N - n0);
    for (int t = 0; t < cnt; ++t) {
      float ml = 0.0f, mr = 0.0f;
      if (voice) {
        const int n = n0 + t;
        const float x = osc_sample(o, wave, L, n);
        const float y = b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
        x2 = x1;
        x1 = x;
        y2 = y1;
        y1 = y;
        const float ramp = __fdiv_rn((float)n, (float)N);
        ml = __fmul_rn(gain_at(pgl, gl, ramp), y);
        mr = __fmul_rn(gain_at(pgr, gr, ramp), y);
      }
      mix[0][t][p] = ml;
      mix[1][t][p] = mr;
    }
    __syncthreads();
    // one warp per output sample and channel: lanes stride over voices
    for (int o2 = warp; o2 < 2 * cnt; o2 += n_warps) {
      const int c = o2 / cnt, t = o2 % cnt;
      float s = 0.0f;
      for (int q = lane; q < lanes; q += 32) s += mix[c][t][q];
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) out[((long)b * N + n0 + t) * 2 + c] = s;
    }
    __syncthreads();
  }
  if (voice && b == B - 1) {
    state_out[p] = y1;
    state_out[P + p] = y2;
    state_out[2 * P + p] = x2;
    state_out[3 * P + p] = x1;
  }
}

}  // namespace

extern "C" {

// Enqueues the three launches on `stream`; returns the cudaError_t of the
// first that failed to launch (0 when all were accepted). Pointers are
// device pointers: rows_f (14, B, P) f32, rows_i (4, B, P) i32, wave (L,)
// f32, state_in / state_out (4, P) f32, out (B * N, 2) f32, scratch
// (10, B, P) f32. Needs N >= 2, 1 <= P <= 256.
int osc_filter_gain_mix_launch(const float* rows_f, const int* rows_i,
                               const float* wave, int L, const float* state_in,
                               float* out, float* state_out, float* scratch,
                               int B, int P, int N, cudaStream_t stream) {
  const long plane = (long)B * P;
  const int threads = 128;
  zero_state<<<(unsigned)((plane + threads - 1) / threads), threads, 0,
               stream>>>(rows_f, rows_i, wave, L, state_in, B, P, N, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry<<<(P + threads - 1) / threads, threads, 0, stream>>>(rows_f, state_in,
                                                               B, P, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int lanes = (P + 31) / 32 * 32;
  render<<<B, lanes, 0, stream>>>(rows_f, rows_i, wave, L, B, P, N, scratch,
                                  out, state_out);
  return (int)cudaGetLastError();
}

const char* pgt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
