// Shared pieces of the register-resident selective-scan kernels
// (selective_scan_reg.cu and selective_scan_reg_bwd.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "selective_scan.cuh"
#include "selective_scan_ptx.cuh"

namespace ssm_reg {

// A is scaled by log2(e) once, so that exp(dt A) is one ex2 of dt A'.
constexpr float LOG2E = 1.4426950408889634f;

// Issues the cp.async copies of rows t0 .. t0 + R - 1 (those below S) and
// columns c0 .. c0 + W - 1 of a row-major matrix with `ld` columns into
// s[R][W], spread over NT threads: columns at or past `cols` land as zeros,
// rows at or past S are not written (no walk reads them). With `vec` the
// copies take 16 bytes (`src` 16-byte aligned, ld and c0 multiples of 4),
// else 4. Neighbouring threads copy neighbouring columns.
template <int R, int W, int NT>
__device__ __forceinline__ void stage(float* s, const float* src, int t0,
                                      int c0, int S, int ld, int cols,
                                      bool vec, int tid) {
  if (vec) {
    constexpr int W4 = W / 4, TOTAL = R * W4;
#pragma unroll
    for (int k = 0; k < (TOTAL + NT - 1) / NT; ++k) {
      const int i = k * NT + tid;
      if (TOTAL % NT != 0 && i >= TOTAL) break;
      const int r = i / W4, cc = (i % W4) * 4;
      if (t0 + r >= S) continue;
      const bool ok = c0 + cc < cols;
      ssm_ptx::cp_async16(s + r * W + cc,
                          ok ? src + (size_t)(t0 + r) * ld + c0 + cc : src,
                          ok ? 16u : 0u);
    }
  } else {
    constexpr int TOTAL = R * W;
#pragma unroll
    for (int k = 0; k < (TOTAL + NT - 1) / NT; ++k) {
      const int i = k * NT + tid;
      if (TOTAL % NT != 0 && i >= TOTAL) break;
      const int r = i / W, cc = i % W;
      if (t0 + r >= S) continue;
      const bool ok = c0 + cc < cols;
      ssm_ptx::cp_async4(s + r * W + cc,
                         ok ? src + (size_t)(t0 + r) * ld + c0 + cc : src,
                         ok ? 4u : 0u);
    }
  }
}

// K consecutive floats (K a multiple of 4) from 16-byte aligned `p`.
template <int K>
__device__ __forceinline__ void load4(float (&v)[K], const float* p) {
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + k);
    v[k] = q.x;
    v[k + 1] = q.y;
    v[k + 2] = q.z;
    v[k + 3] = q.w;
  }
}

// K consecutive floats to 16-byte aligned `p`.
template <int K>
__device__ __forceinline__ void store4(float* p, const float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; k += 4)
    *reinterpret_cast<float4*>(p + k) =
        make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

}  // namespace ssm_reg
