// PTX helpers for the tensor-core RWKV6 kernel (rwkv6_mma.cu): 16-byte
// cp.async copies, TF32 rounding and splitting, the m16n8k8 TF32 mma.sync
// product and named barriers. Each wraps one PTX instruction (or a few)
// and nothing more.
#pragma once

#include <cstdint>

namespace wkv {

// ---- cp.async: global -> shared, 16 bytes, no registers -------------------

// Copies `src_bytes` (16 or 0) bytes from global `src` to shared `dst` and
// fills the rest of the 16 with zeros: 0 writes a row of zeros without
// reading `src`, which must still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Waits until every copy this thread has issued has landed (PTX: the same
// as cp.async.commit_group, then cp.async.wait_group 0).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- TF32 ------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as the bits of a float whose low 13 bits are 0.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split: x = hi + lo + (x - hi - lo), hi = tf32(x) and
// lo = tf32(x - hi); x - hi is exact in float32, so hi + lo holds x to
// about 2^-21 of its size.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a * b on the tensor cores: a is 16 x 8 (row), b is 8 x 8 (col), d
// 16 x 8 float32, all as fragments of the warp (PTX ISA, "Matrix Fragments
// for mma.m16n8k8" with .tf32; g = lane / 4, c = lane % 4):
//   a0 (g, c)  a1 (g + 8, c)  a2 (g, c + 4)  a3 (g + 8, c + 4)
//   b0 (k = c, n = g)  b1 (k = c + 4, n = g)
//   d0 (g, 2c)  d1 (g, 2c + 1)  d2 (g + 8, 2c)  d3 (g + 8, 2c + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- named barriers --------------------------------------------------------

// Waits for `threads` threads (a multiple of 32) at barrier `id` (1-15; 0
// is __syncthreads'); orders their shared-memory accesses as
// __syncthreads does.
__device__ __forceinline__ void bar_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace wkv
