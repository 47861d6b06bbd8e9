// Order-2 time-varying affine scan over (T, C) planes, for Hopper (sm_90a).
//
// Replaces pygmu2_tpu/ops/linrec_pallas.py:affine_scan_2_pallas (body in
// _scan_kernel): s[t] = A[t] s[t-1] + u[t] with A = [[a11, a12], [a21, a22]],
// u = [u1, u2], an optional state s0 before step 0, in chunks of `chunk`
// samples: a Kogge-Stone scan of the affine maps within each chunk (shifted-in
// rows are the identity map), then the state entering the chunk applied to
// every row, the chunk's last row carried to the next chunk.
//
// What bounds it on this card: bytes, if anything. Per (sample, channel) it
// reads up to six floats and writes two (67 MB at T = 16384, C = 128; 33 MB
// when the four matrix planes are one column shared by the channels, as for
// BiquadPE and SVFilterPE) and does ~20 flops per Kogge-Stone pass, 10 passes
// at chunk 1024: ~0.02 ms of bytes against ~0.006 ms of flops at the data
// sheet's rates. The scan's serial dependence is across chunks only.
//
// What the design does about it: one CUDA block per channel and one thread
// per row of the chunk (C = 128 gives 128 blocks on 132 SMs). A block walks
// its channel's chunks in order; each Kogge-Stone pass publishes the six
// values of every row to a double-buffered shared-memory array (48 KB at chunk
// 1024, so one __syncthreads() per pass) and reads row t - s back. The next
// chunk's inputs are loaded into registers before the current chunk's scan, so
// their global-memory latency hides behind it. A plane may be shared by the
// channels (a bit of `shared`): it is then read as a (T,) column.
//
// Explicitly rounded ops in the plain version's order
// (ops/linrec_kernel.affine_scan_2_chunked_ref): every a*b + c*d is
// __fmaf_rn(a, b, __fmul_rn(c, d)), the one fused multiply-add XLA's CPU
// backend makes of it in the JAX package's reference, every other sum
// __fadd_rn. The plain version computes the same fused multiply-adds exactly
// in float64 (ops/xla_math.fmaf), so the kernel equals it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kPlanes = 6;
constexpr int kMaxChunk = 1024;

struct Row {
  float m11, m12, m21, m22, v1, v2;
};

// a*b + c*d as XLA's CPU backend contracts it in the JAX reference
__device__ __forceinline__ float dot2(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, __fmul_rn(c, d));
}

// Row `t` of the six planes; zero past T (the plain version's zero padding).
__device__ __forceinline__ Row load_row(const float* const* planes, int shared,
                                        long t, int T, int C, int c) {
  Row r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (t < T) {
    float v[kPlanes];
#pragma unroll
    for (int k = 0; k < kPlanes; ++k)
      v[k] = __ldg(planes[k] + ((shared >> k) & 1 ? t : t * C + c));
    r = Row{v[0], v[1], v[2], v[3], v[4], v[5]};
  }
  return r;
}

__global__ void __launch_bounds__(kMaxChunk)
affine_scan_2(const float* __restrict__ a11, const float* __restrict__ a12,
              const float* __restrict__ a21, const float* __restrict__ a22,
              const float* __restrict__ u1, const float* __restrict__ u2,
              const float* __restrict__ s01, const float* __restrict__ s02,
              float* __restrict__ s1_out, float* __restrict__ s2_out, int T,
              int C, int shared) {
  extern __shared__ float smem[];  // [2][kPlanes][chunk], then the carry pair
  const int chunk = blockDim.x;
  const int t = threadIdx.x;
  const int c = blockIdx.x;
  float* carry = smem + 2 * kPlanes * chunk;
  const float* planes[kPlanes] = {a11, a12, a21, a22, u1, u2};
  if (t == 0) {
    carry[0] = 0.0f;
    carry[1] = 0.0f;
  }

  Row next = load_row(planes, shared, t, T, C, c);
  if (t == 0 && s01 != nullptr) {  // fold s0 into u[0]
    next.v1 = __fadd_rn(next.v1, dot2(next.m11, s01[c], next.m12, s02[c]));
    next.v2 = __fadd_rn(next.v2, dot2(next.m21, s01[c], next.m22, s02[c]));
  }
  for (long base = 0; base < T; base += chunk) {
    Row r = next;
    next = load_row(planes, shared, base + chunk + t, T, C, c);

    int buf = 0;
    for (int s = 1; s < chunk; s <<= 1, buf ^= 1) {
      float* b = smem + buf * kPlanes * chunk;
      b[0 * chunk + t] = r.m11;
      b[1 * chunk + t] = r.m12;
      b[2 * chunk + t] = r.m21;
      b[3 * chunk + t] = r.m22;
      b[4 * chunk + t] = r.v1;
      b[5 * chunk + t] = r.v2;
      __syncthreads();
      Row p{1.f, 0.f, 0.f, 1.f, 0.f, 0.f};  // the identity map
      if (t >= s) {
        const int j = t - s;
        p = Row{b[0 * chunk + j], b[1 * chunk + j], b[2 * chunk + j],
                b[3 * chunk + j], b[4 * chunk + j], b[5 * chunk + j]};
      }
      r = Row{dot2(r.m11, p.m11, r.m12, p.m21), dot2(r.m11, p.m12, r.m12, p.m22),
              dot2(r.m21, p.m11, r.m22, p.m21), dot2(r.m21, p.m12, r.m22, p.m22),
              __fadd_rn(dot2(r.m11, p.v1, r.m12, p.v2), r.v1),
              __fadd_rn(dot2(r.m21, p.v1, r.m22, p.v2), r.v2)};
    }
    // the state entering this chunk: written by the last row of the one
    // before, ordered by the scan's barriers (chunk >= 2) and this one
    __syncthreads();
    const float c1 = carry[0], c2 = carry[1];
    const float o1 = __fadd_rn(dot2(r.m11, c1, r.m12, c2), r.v1);
    const float o2 = __fadd_rn(dot2(r.m21, c1, r.m22, c2), r.v2);
    const long row = base + t;
    if (row < T) {
      s1_out[row * C + c] = o1;
      s2_out[row * C + c] = o2;
    }
    __syncthreads();  // every thread has read the carry
    if (t == chunk - 1) {
      carry[0] = o1;
      carry[1] = o2;
    }
  }
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`; returns its cudaError_t (0: accepted).
// Pointers are device pointers: the six planes, each (T, C) f32 or, where
// its bit k of `shared` is set, a (T,) f32 column shared by the channels;
// s01 / s02 (C,) f32 or both null; s1 / s2 (T, C) f32 outputs. Needs chunk a
// power of two in [2, 1024].
int affine_scan_2_launch(const float* a11, const float* a12, const float* a21,
                         const float* a22, const float* u1, const float* u2,
                         const float* s01, const float* s02, float* s1,
                         float* s2, int T, int C, int chunk, int shared,
                         cudaStream_t stream) {
  const size_t smem = (2 * kPlanes * (size_t)chunk + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      affine_scan_2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  affine_scan_2<<<C, chunk, smem, stream>>>(a11, a12, a21, a22, u1, u2, s01,
                                            s02, s1, s2, T, C, shared);
  return (int)cudaGetLastError();
}

}  // extern "C"
