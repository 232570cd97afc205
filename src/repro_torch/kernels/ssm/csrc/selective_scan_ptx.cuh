// PTX helpers of the register-resident selective-scan kernels
// (selective_scan_reg.cu, selective_scan_reg_bwd.cu): the base-2
// exponential and the cp.async copies. Each wraps one PTX instruction.
#pragma once

#include <cstdint>

namespace ssm_ptx {

// 2^x in one MUFU.EX2 (flushes a subnormal result to zero, as __expf does).
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// Copies `src_bytes` (4 or 0) bytes from global `src` to shared `dst`; 0
// writes a zero without reading `src`, which must still be a valid address.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          uint32_t src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The same for 16 bytes (`src_bytes` 16 or 0); both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           uint32_t src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Closes the group of copies this thread has issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `N` of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace ssm_ptx
