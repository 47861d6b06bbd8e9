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
//   out   L/R = sum over voices of y[t] * per-block gain ramp (pos / N)
//
// What bounds it on this card: not bytes (the high-register 3 s score reads
// 68 MB of xt, ~0.02 ms at 3.35 TB/s). The bounds are the biquad's serial
// dependence along T and the reduction over voices behind every output sample.
//
// What the design does about it: the serial chain cut at MIDI-block
// boundaries (block_biquad.cuh), a zero-state pass per (block, voice), a
// per-voice carry over the blocks, a re-run from the true state with a
// shared-memory mixdown; the oscillator's samples read from xt (coalesced:
// neighbouring threads hold neighbouring voices). The fused pass
// (osc_filter_gain_mix.cu) took this design before its own.
//
// Tolerance: the TPU kernel (and its plain version, soundfont/filter_kernels.
// filter_gain_mix_ref) scans each 128-sample chunk in Kogge-Stone order; this
// kernel recurs sample by sample, its multiply-adds contracted into FMAs, and
// sums the voices in another order. It holds the plain version within
// 2e-5 * max(1, peak), the bound the JAX package's tests hold the TPU kernel to
// against its reference (tests/test_filter_pallas.py).

#include <cuda_runtime.h>

#include "block_biquad.cuh"

namespace {

// Plane order of the stacked rows; must match filter_kernels._FILTER_ROWS.
enum Row { B0, B1, B2, A1, A2, FRESHF, PGL, GL, PGR, GR };

__global__ void zero_state(const float* __restrict__ xt,
                           const float* __restrict__ rows, int B, int P, int N,
                           float* __restrict__ scratch) {
  const long plane = (long)B * P;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int b = (int)(idx / P);
  const int p = (int)(idx % P);
  const float* x = xt + (long)b * N * P + p;
  // FIR inputs before the block: zero at an epoch start and before the
  // first block, else the previous block's last two samples
  float xm2 = 0.0f, xm1 = 0.0f;
  if (rows[FRESHF * plane + idx] <= 0.5f && b > 0) {
    xm2 = x[-2L * P];
    xm1 = x[-1L * P];
  }
  zero_state_block(load_biquad(rows + B0 * plane, plane, idx),
                   [&](int n) { return x[(long)n * P]; }, N, xm2, xm1, plane,
                   idx, scratch);
}

__global__ void carry(const float* __restrict__ rows, int B, int P,
                      float* __restrict__ scratch) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  carry_blocks(rows + FRESHF * (long)B * P, 0.0f, 0.0f, B, P, p, scratch);
}

__global__ void render(const float* __restrict__ xt,
                       const float* __restrict__ rows, int B, int P, int N,
                       const float* __restrict__ scratch,
                       float* __restrict__ out) {
  __shared__ float mix[2][kTile][kMaxVoices];
  const long plane = (long)B * P;
  const int b = blockIdx.x;
  const int p = threadIdx.x;
  const bool voice = p < P;
  const long idx = (long)b * P + p;
  const int lanes = blockDim.x;  // a multiple of 32, >= P
  const float inv_n = 1.0f / (float)N;

  Biquad f{0, 0, 0, 0, 0};
  float pgl = 0, gl = 0, pgr = 0, gr = 0;
  float x1 = 0, x2 = 0, y1 = 0, y2 = 0;
  if (voice) {
    f = load_biquad(rows + B0 * plane, plane, idx);
    pgl = rows[PGL * plane + idx]; gl = rows[GL * plane + idx];
    pgr = rows[PGR * plane + idx]; gr = rows[GR * plane + idx];
    x2 = scratch[TAIL2 * plane + idx];
    x1 = scratch[TAIL1 * plane + idx];
    y1 = scratch[YIN1 * plane + idx];
    y2 = scratch[YIN2 * plane + idx];
  }
  const float* x = xt + (long)b * N * P + p;

  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int cnt = min(kTile, N - n0);
    for (int t = 0; t < cnt; ++t) {
      float ml = 0.0f, mr = 0.0f;
      if (voice) {
        const int n = n0 + t;
        const float y = f.step(x[(long)n * P], x1, x2, y1, y2);
        const float ramp = __fmul_rn((float)n, inv_n);  // pos * (1 / N)
        ml = __fmul_rn(gain_at(pgl, gl, ramp), y);
        mr = __fmul_rn(gain_at(pgr, gr, ramp), y);
      }
      mix[0][t][p] = ml;
      mix[1][t][p] = mr;
    }
    __syncthreads();
    mix_tile(mix, cnt, lanes, b, N, n0, out);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Enqueues the three launches on `stream`; returns the cudaError_t of the
// first that failed to launch (0 when all were accepted). Pointers are
// device pointers: xt (B * N, P) f32, rows (10, B, P) f32, out (B * N, 2)
// f32, scratch (10, B, P) f32. Needs N >= 2, 1 <= P <= 256.
int filter_gain_mix_launch(const float* xt, const float* rows, float* out,
                           float* scratch, int B, int P, int N,
                           cudaStream_t stream) {
  const long plane = (long)B * P;
  const int threads = 128;
  zero_state<<<(unsigned)((plane + threads - 1) / threads), threads, 0,
               stream>>>(xt, rows, B, P, N, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry<<<(P + threads - 1) / threads, threads, 0, stream>>>(rows, B, P,
                                                               scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int lanes = (P + 31) / 32 * 32;
  render<<<B, lanes, 0, stream>>>(xt, rows, B, P, N, scratch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
