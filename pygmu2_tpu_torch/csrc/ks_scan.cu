// Karplus-Strong string, serial in time, for Hopper (sm_90a).
//
// Replaces the TPU kernel pygmu2_tpu/ops/ks_pallas.py:ks_scan_pallas
// (:115), which keeps the (L, 128) string in VMEM scratch (one live lane)
// and walks a sequential grid of time chunks.
//
// What it computes (the op order of ks_scan_ref, float32), per sample t
// where act[t] is set (elsewhere y = 0 and the state stands still):
//   rn  = (r + 1) % L
//   out = rho[t] * (buf[r] + buf[rn]) * 0.5              two-point average
//   ap  = c * out + ap_in - c * ap_out                   fractional allpass
//   y[t] = ap; buf[r] = ap; r = rn; ap_in = out; ap_out = ap
//
// What bounds it on this card: the dependent chain, not bytes or
// operations. At the main path's block (T = 16384, L = 535) it moves
// 152 KB (roofline 0.05 us at 3.35 TB/s) and does 8 ops per sample. Each
// sample's reads may hit the value written one sample earlier (L = 2),
// and the allpass chains ap_out through a multiply and a subtract: the
// store of buf[r], the next sample's shared-memory reads (~30 cycles
// each, ordered after the store), the add, two multiplies, the allpass
// (~16) and the output store: ~70 cycles, a serial floor of ~0.6 ms per
// 16384 samples at 1.98 GHz. Measured times: PERF.md's kernel table
// (chip_smoke.py).
//
// What the design does about it: one thread runs the string with r and
// the allpass state in registers; the string (L floats, 8.8 KB at 20 Hz)
// lives in shared memory, loaded and stored once per call by the whole
// block. The loop has no branch around its loads: act[t] and rho[t] are
// read every sample and act only selects the output and guards the state
// update, so the unrolled loop issues the global loads ahead of the
// string's chain (behind an act branch they waited on it: 1.6 ms, not
// 1.3 ms or less, on the H100). A string longer than 51200 samples (200 KB; below 0.862 Hz at
// 44.1 kHz) is refused. Explicitly rounded float ops keep the kernel
// equal to the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 200 * 1024;  // of the 227 KB a block may use
constexpr int kThreads = 128;                // load and store the string

__global__ void ks_scan(const float* __restrict__ rho,
                        const bool* __restrict__ act,
                        const float* __restrict__ buf_in,
                        const int* __restrict__ r_in,
                        const float* __restrict__ ap_in_in,
                        const float* __restrict__ ap_out_in,
                        float* __restrict__ y, float* __restrict__ buf_out,
                        int* __restrict__ r_out, float* __restrict__ ap_in_out,
                        float* __restrict__ ap_out_out, int T, int L, float c) {
  extern __shared__ float buf[];
  for (int l = threadIdx.x; l < L; l += blockDim.x) buf[l] = buf_in[l];
  __syncthreads();
  if (threadIdx.x == 0) {
    int r = *r_in;
    float ai = *ap_in_in, ao = *ap_out_in;
    for (int t = 0; t < T; ++t) {
      const bool a = act[t];
      const float rh = rho[t];
      const int rn = r + 1 == L ? 0 : r + 1;
      const float out =
          __fmul_rn(__fmul_rn(rh, __fadd_rn(buf[r], buf[rn])), 0.5f);
      const float ap = __fsub_rn(__fadd_rn(__fmul_rn(c, out), ai), __fmul_rn(c, ao));
      y[t] = a ? ap : 0.0f;
      if (a) {
        buf[r] = ap;
        r = rn;
        ai = out;
        ao = ap;
      }
    }
    *r_out = r;
    *ap_in_out = ai;
    *ap_out_out = ao;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) buf_out[l] = buf[l];
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0 when
// accepted). Device pointers: rho / y (T,) f32, act (T,) bool, buf_in /
// buf_out (L,) f32, r_in / r_out () i32 in [0, L), ap_* () f32. Needs
// 2 <= L <= kMaxSharedBytes / 4 (else cudaErrorInvalidValue).
int ks_scan_launch(const float* rho, const bool* act, const float* buf_in,
                   const int* r_in, const float* ap_in_in,
                   const float* ap_out_in, float* y, float* buf_out, int* r_out,
                   float* ap_in_out, float* ap_out_out, int T, int L,
                   float allpass_c, cudaStream_t stream) {
  const size_t smem = (size_t)L * sizeof(float);
  if (L < 2 || smem > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ks_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ks_scan<<<1, kThreads, smem, stream>>>(rho, act, buf_in, r_in, ap_in_in,
                                         ap_out_in, y, buf_out, r_out,
                                         ap_in_out, ap_out_out, T, L,
                                         allpass_c);
  return (int)cudaGetLastError();
}

}  // extern "C"
