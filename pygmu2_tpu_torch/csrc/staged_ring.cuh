// Shared-memory staging for Hopper (sm_90a): mbarriers and cp.async.
//
// The serial kernels that stage their rows through a ring of shared-memory
// stages (envelope_ar_scan.cu, slew_scan.cu) and the SoundFont audio pass
// (osc_filter_gain_mix.cu) signal a stage's arrival and release with
// mbarriers: a producer's cp.async copies arrive on a stage's `full`
// barrier when they land (cp_async_arrive), the consumer arrives on its
// `done` barrier when it has written the stage back; each side waits on
// the other's barrier with the phase parity of the stage's round.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               ::"r"(smem(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(smem(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem(dst)), "l"(src)
               : "memory");
}
// Arrives on `bar` once every cp.async this thread issued before has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem(bar))
               : "memory");
}

}  // namespace
