// Sums of per-channel partials over the channels, in channel order: the
// backward kernels' column cotangents (a (T,) column shared by the channels
// gets the sum of every channel's part). One thread per row adds its C
// values from channel 0 up, so two runs give the same bits (no atomics).
#pragma once

#include <cuda_runtime.h>

namespace {

// out[r] = sum over c of part[r * C + c], for r in [0, rows)
__global__ void channel_sum(const float* __restrict__ part, float* __restrict__ out, int rows,
                            int C) {
  for (long r = blockIdx.x * (long)blockDim.x + threadIdx.x; r < rows;
       r += (long)gridDim.x * blockDim.x) {
    const float* row = part + r * C;
    float s = 0.0f;
    for (int c = 0; c < C; ++c) s += row[c];
    out[r] = s;
  }
}

inline cudaError_t launch_channel_sum(const float* part, float* out, int rows, int C,
                                      cudaStream_t stream) {
  const int threads = 256;
  int blocks = (rows + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  channel_sum<<<blocks, threads, 0, stream>>>(part, out, rows, C);
  return cudaGetLastError();
}

}  // namespace
