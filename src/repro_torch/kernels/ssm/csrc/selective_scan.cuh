// Shared pieces of the selective-scan kernels (selective_scan.cu and
// selective_scan_bwd.cu).
#pragma once

#include <cuda_runtime.h>

namespace ssm {

constexpr int NT = 256;  // threads a block: 256 / N channels x N states
constexpr int T = 32;    // steps a shared-memory tile holds

// s[tt][cc] = src[(t0 + tt) * ld + c0 + cc] for the tile's T rows of W
// columns; zeros past row S or column D. Neighbouring threads read
// neighbouring columns.
template <int W>
__device__ __forceinline__ void load_tile(float (*s)[W], const float* src,
                                          int t0, int c0, int S, int D,
                                          int tid) {
  for (int i = tid; i < T * W; i += NT) {
    const int tt = i / W, cc = i % W;
    const int t = t0 + tt, col = c0 + cc;
    s[tt][cc] = (t < S && col < D) ? src[(size_t)t * D + col] : 0.f;
  }
}

// The sums over a group of N lanes (lane_n = 0..N-1, N a power of two up to
// 32) of N values at once: on entry v[j] is this lane's term of sum j; on
// return lane n holds sum n. Each of log2(N) rounds halves the live values:
// a lane keeps the half its bit selects, sends the other half to the lane
// across that bit and adds what comes back, so the rounds take N - 1
// shuffles where N separate sums would take N log2(N). The order of the
// additions is fixed.
template <int N>
__device__ __forceinline__ float transpose_sum(float (&v)[N], int lane_n) {
#pragma unroll
  for (int s = N / 2; s >= 1; s /= 2) {
    const bool upper = (lane_n & s) != 0;
#pragma unroll
    for (int j = 0; j < s; ++j) {
      const float keep = upper ? v[j + s] : v[j];
      const float send = upper ? v[j] : v[j + s];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  return v[0];
}

}  // namespace ssm
