// Mamba's selective scan for NVIDIA Hopper (sm_90a), CUDA C++: forward.
//
// Replaces no Pallas kernel: the reference computes the scan in plain JAX
// (`_ssm_scan_chunked` in src/repro/models/ssm.py), which XLA fuses on the
// TPU. It was added because PyTorch has no associative scan: a plain
// version materialises exp(dt A), dt u B and the states, each (B, S, d_inner,
// N) in float32 (4.3 GB at jamba's prefill shape, B=8, S=1024, d_inner 8192,
// N 16), or steps through S tokens from Python. It computes, in float32,
//
//   h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t,   y_t = sum_n h_t C_t
//
// from h0 (or zeros) and returns y and the last state.
//
// Bound on the H100. Per launch it must read u and dt (B, S, d_inner), Bm and
// Cm (B, S, N), A and h0, and write y and h_last: at the prefill shape
// 0.81 GB, 0.24 ms at 3.35 TB/s. It takes B S d_inner N exponentials: 1.07 G,
// 0.26 ms at the SFU's rate (16 a clock on each of 132 SMs at 1.98 GHz,
// 4.18 T/s). Nothing else is close: the products are three FMAs an element.
//
// Design, simple first: one thread per (batch, channel, state) holds its h in
// a register, so a block of 256 threads covers 256 / N channels of one
// batch row (jamba's training shape, B=1, S=2048, still runs 131,072
// threads). A block stages T=32 steps of u and dt for its channels and of Bm
// and Cm for its row in shared memory (Bm, Cm read once per block), walks
// them, and stores y through shared memory. y_t is the sum over a channel's N
// lanes: instead of N-1 shuffles per step, each lane keeps its terms of N
// steps and one butterfly of N-1 shuffles leaves step n's sum on lane n
// (`transpose_sum`), in a fixed order. No atomics: repeated calls give the
// same bits. Steps past S and channels past d_inner are read as zeros
// (dt = 0 keeps h as it is).

#include <cuda_runtime.h>

#include "selective_scan.cuh"

namespace {

using ssm::NT;
using ssm::T;

struct FwdParams {
  const float* u;   // (B, S, D), contiguous, as dt and y
  const float* dt;
  const float* Bm;  // (B, S, N), contiguous, as Cm
  const float* Cm;
  const float* A;   // (D, N)
  const float* h0;  // (B, D, N) or null: zeros
  float* y;
  float* h_last;    // (B, D, N)
  int B, S, D;
};

template <int N>
__global__ void __launch_bounds__(NT) ssm_fwd_kernel(FwdParams p) {
  constexpr int CH = NT / N;  // channels a block covers
  __shared__ float s_u[T][CH], s_dt[T][CH], s_y[T][CH + 1];
  __shared__ float s_B[T][N], s_C[T][N];
  const int tid = threadIdx.x;
  const int c = tid / N, n = tid % N;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool live = d < p.D;
  const float A = live ? p.A[(size_t)d * N + n] : 0.f;
  const size_t hidx = ((size_t)b * p.D + d) * N + n;
  float h = (live && p.h0) ? p.h0[hidx] : 0.f;
  const size_t base = (size_t)b * p.S * p.D;
  const float* Bm = p.Bm + (size_t)b * p.S * N;
  const float* Cm = p.Cm + (size_t)b * p.S * N;
  for (int t0 = 0; t0 < p.S; t0 += T) {
    __syncthreads();  // the last tile's y is out of s_y
    ssm::load_tile<CH>(s_u, p.u + base, t0, d0, p.S, p.D, tid);
    ssm::load_tile<CH>(s_dt, p.dt + base, t0, d0, p.S, p.D, tid);
    ssm::load_tile<N>(s_B, Bm, t0, 0, p.S, N, tid);
    ssm::load_tile<N>(s_C, Cm, t0, 0, p.S, N, tid);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < T / N; ++g) {
      float v[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int tt = g * N + j;
        const float dtv = s_dt[tt][c];
        h = fmaf(__expf(dtv * A), h, dtv * s_u[tt][c] * s_B[tt][n]);
        v[j] = h * s_C[tt][n];
      }
      s_y[g * N + n][c] = ssm::transpose_sum<N>(v, n);
    }
    __syncthreads();
    for (int i = tid; i < T * CH; i += NT) {
      const int tt = i / CH, cc = i % CH;
      const int t = t0 + tt, dd = d0 + cc;
      if (t < p.S && dd < p.D) p.y[base + (size_t)t * p.D + dd] = s_y[tt][cc];
    }
  }
  if (live) p.h_last[hidx] = h;
}

template <int N>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  const dim3 grid((p.D + NT / N - 1) / (NT / N), p.B);
  ssm_fwd_kernel<N><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// All tensors float32 and contiguous: u, dt, y (B, S, D); Bm, Cm (B, S, N);
// A (D, N); h0 (B, D, N) or null; h_last (B, D, N). N is 8 or 16. Returns the
// cudaError_t of the launch.
extern "C" int repro_ssm_fwd(const float* u, const float* dt, const float* Bm,
                             const float* Cm, const float* A, const float* h0,
                             float* y, float* h_last, int B, int S, int D,
                             int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdParams p{u, dt, Bm, Cm, A, h0, y, h_last, B, S, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: return static_cast<int>(launch<8>(p, s));
    case 16: return static_cast<int>(launch<16>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Channels one block covers at d_state N (the backward's partials of dBm
// and dCm come one per such block), or -1 for an N the kernels do not take.
extern "C" int repro_ssm_channels_per_block(int N) {
  return (N == 8 || N == 16) ? NT / N : -1;
}

extern "C" const char* repro_ssm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
