// PTX helpers of the tensor-core flash-attention backward
// (flash_attention_bwd_mma.cu): the bf16 mma.sync product and the packing
// of two float32 values into one bf16x2 register.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fbwd {

// d += a b over one m16n8k16 tile: a (16 x 16, row-major fragment: rows g
// and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9 of lane 4g + t), b
// (16 x 8, column-major fragment: rows 2t, 2t + 1 and 2t + 8, 2t + 9 of
// column g), d (16 x 8 float32: rows g and g + 8, columns 2t and 2t + 1).
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(lo) in the low half, bf16(hi) in the high half (round to nearest)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace fbwd
