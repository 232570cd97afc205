// Mamba's selective scan for NVIDIA Hopper (sm_90a), CUDA C++: backward.
//
// The gradient of selective_scan.cu's forward (which replaces no Pallas
// kernel: the reference differentiates its plain-JAX `_ssm_scan_chunked`).
// With g_t the cotangent of h_t, carried back from g_S = dh_last,
//
//   g_t   = dy_t C_t + a_{t+1} g_{t+1},          a_t = exp(dt_t A),
//   du_t  = sum_n g_t B_t dt_t,                  dB_t = sum_d g_t dt_t u_t,
//   ddt_t = sum_n (g_t B_t u_t + g_t h_{t-1} a_t A),
//   dC_t  = sum_d dy_t h_t,   dA = sum_{b,t} g_t h_{t-1} a_t dt_t,
//   dh0   = a_1 g_1.
//
// Bound on the H100. At jamba's training shape (B=1, S=2048, d_inner 8192,
// N 16) it must read u, dt, dy (B, S, d_inner) and write du and ddt: 0.34
// GB, 0.10 ms at 3.35 TB/s; and take at least one exponential an element,
// 0.27 G, 0.064 ms at the SFU's 4.18 T/s.
//
// Design, simple first, on the forward's layout (one thread per (batch,
// channel, state), 256 threads a block, T=32-step tiles of u, dt, dy, Bm and
// Cm in shared memory). The states are not stored: a first walk forward
// writes only the state at the start of each tile to a workspace (1/32 of
// all the states; the wrapper allocates it), then the tiles are walked in
// reverse, each recomputing its 32 states into registers from its start
// state and walking them back. du and ddt are sums over a channel's N lanes
// (`transpose_sum`, as the forward's y). dBm and dCm are sums over d_inner:
// each block sums its channels' terms through shared memory in a fixed
// order and writes one partial per block, (B, S, blocks, N); dA is summed
// over t in a register and written per batch row, (B, d_inner, N). The
// wrapper sums the partials in a fixed order. No atomics: repeated calls give
// the same bits. Per element that is three exponentials (the first walk,
// the recomputation, the reverse walk) and a few FMAs.

#include <cuda_runtime.h>

#include "selective_scan.cuh"

namespace {

using ssm::NT;
using ssm::T;

struct BwdParams {
  const float* u;   // (B, S, D), contiguous, as dt, dy, du and ddt
  const float* dt;
  const float* Bm;  // (B, S, N), contiguous, as Cm
  const float* Cm;
  const float* A;   // (D, N)
  const float* h0;  // (B, D, N) or null: zeros
  const float* dy;
  const float* dh_last;  // (B, D, N)
  float* du;
  float* ddt;
  float* dB_part;  // (B, S, blocks, N)
  float* dC_part;
  float* dA_part;  // (B, D, N)
  float* dh0;      // (B, D, N)
  float* ckpt;     // (B, tiles, D, N): the state before each tile
  int B, S, D;
};

// Two blocks a SM: left to itself ptxas gives the N = 16 kernel 190
// registers, one block a SM, and jamba's training shape (512 blocks at
// B = 1) runs in four waves; capped at 128 registers it does not spill and
// runs in two. Lower caps spill.
template <int N>
__global__ void __launch_bounds__(NT, 2) ssm_bwd_kernel(BwdParams p) {
  constexpr int CH = NT / N;
  __shared__ float s_u[T][CH], s_dt[T][CH], s_dy[T][CH];
  __shared__ float s_B[T][N], s_C[T][N];
  __shared__ float s_du[T][CH + 1], s_ddt[T][CH + 1];
  __shared__ float s_rB[N][CH][N], s_rC[N][CH][N];  // [step][channel][n]
  const int tid = threadIdx.x;
  const int c = tid / N, n = tid % N;
  const int b = blockIdx.y;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * CH;
  const int d = d0 + c;
  const bool live = d < p.D;
  const int tiles = (p.S + T - 1) / T;
  const float A = live ? p.A[(size_t)d * N + n] : 0.f;
  const size_t hidx = ((size_t)b * p.D + d) * N + n;
  const size_t base = (size_t)b * p.S * p.D;
  const float* Bm = p.Bm + (size_t)b * p.S * N;
  const float* Cm = p.Cm + (size_t)b * p.S * N;
  auto ckpt_at = [&](int k) {
    return p.ckpt + (((size_t)b * tiles + k) * p.D + d) * N + n;
  };

  // the first walk: the state before each tile
  float h = (live && p.h0) ? p.h0[hidx] : 0.f;
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * T;
    if (live) *ckpt_at(k) = h;
    if (k == tiles - 1) break;  // the last tile's states are not needed here
    __syncthreads();
    ssm::load_tile<CH>(s_u, p.u + base, t0, d0, p.S, p.D, tid);
    ssm::load_tile<CH>(s_dt, p.dt + base, t0, d0, p.S, p.D, tid);
    ssm::load_tile<N>(s_B, Bm, t0, 0, p.S, N, tid);
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      const float dtv = s_dt[tt][c];
      h = fmaf(__expf(dtv * A), h, dtv * s_u[tt][c] * s_B[tt][n]);
    }
  }

  // the reverse walk
  float gc = live ? p.dh_last[hidx] : 0.f;  // the cotangent of h_t
  float dA_acc = 0.f;
  for (int k = tiles - 1; k >= 0; --k) {
    const int t0 = k * T;
    __syncthreads();  // the last tile's du and ddt are out of shared memory
    ssm::load_tile<CH>(s_u, p.u + base, t0, d0, p.S, p.D, tid);
    ssm::load_tile<CH>(s_dt, p.dt + base, t0, d0, p.S, p.D, tid);
    ssm::load_tile<CH>(s_dy, p.dy + base, t0, d0, p.S, p.D, tid);
    ssm::load_tile<N>(s_B, Bm, t0, 0, p.S, N, tid);
    ssm::load_tile<N>(s_C, Cm, t0, 0, p.S, N, tid);
    __syncthreads();
    const float h_start = live ? *ckpt_at(k) : 0.f;
    float hs[T];
    float hh = h_start;
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      const float dtv = s_dt[tt][c];
      hh = fmaf(__expf(dtv * A), hh, dtv * s_u[tt][c] * s_B[tt][n]);
      hs[tt] = hh;
    }
#pragma unroll
    for (int g = T / N - 1; g >= 0; --g) {
      float vdu[N], vddt[N];
#pragma unroll
      for (int j = N - 1; j >= 0; --j) {
        const int tt = g * N + j;
        const float dtv = s_dt[tt][c], uv = s_u[tt][c], dyv = s_dy[tt][c];
        const float Bv = s_B[tt][n];
        const float h_prev = tt > 0 ? hs[tt - 1] : h_start;
        const float a = __expf(dtv * A);
        const float gt = fmaf(dyv, s_C[tt][n], gc);
        const float gB = gt * Bv;
        const float ga = gt * h_prev * a;
        vdu[j] = gB * dtv;
        vddt[j] = fmaf(gB, uv, ga * A);
        s_rB[j][c][n] = gt * (dtv * uv);
        s_rC[j][c][n] = dyv * hs[tt];
        dA_acc = fmaf(ga, dtv, dA_acc);
        gc = a * gt;
      }
      s_du[g * N + n][c] = ssm::transpose_sum<N>(vdu, n);
      s_ddt[g * N + n][c] = ssm::transpose_sum<N>(vddt, n);
      __syncthreads();
      for (int i = tid; i < N * N; i += NT) {
        const int j = i / N, nn = i % N;
        const int t = t0 + g * N + j;
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int cc = 0; cc < CH; ++cc) {
          sb += s_rB[j][cc][nn];
          sc += s_rC[j][cc][nn];
        }
        if (t < p.S) {
          const size_t o = (((size_t)b * p.S + t) * nblk + blk) * N + nn;
          p.dB_part[o] = sb;
          p.dC_part[o] = sc;
        }
      }
      __syncthreads();  // s_rB and s_rC are free for the next group
    }
    for (int i = tid; i < T * CH; i += NT) {
      const int tt = i / CH, cc = i % CH;
      const int t = t0 + tt, dd = d0 + cc;
      if (t < p.S && dd < p.D) {
        p.du[base + (size_t)t * p.D + dd] = s_du[tt][cc];
        p.ddt[base + (size_t)t * p.D + dd] = s_ddt[tt][cc];
      }
    }
  }
  if (live) {
    p.dA_part[hidx] = dA_acc;
    p.dh0[hidx] = gc;
  }
}

template <int N>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const dim3 grid((p.D + NT / N - 1) / (NT / N), p.B);
  ssm_bwd_kernel<N><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// All tensors float32 and contiguous: u, dt, dy, du, ddt (B, S, D); Bm, Cm
// (B, S, N); A (D, N); h0 (B, D, N) or null; dh_last, dA_part, dh0 (B, D,
// N); dB_part and dC_part (B, S, blocks, N) with blocks =
// ceil(D / repro_ssm_channels_per_block(N)); ckpt (B, ceil(S / 32), D, N).
// N is 8 or 16. Returns the cudaError_t of the launch.
extern "C" int repro_ssm_bwd(const float* u, const float* dt, const float* Bm,
                             const float* Cm, const float* A, const float* h0,
                             const float* dy, const float* dh_last, float* du,
                             float* ddt, float* dB_part, float* dC_part,
                             float* dA_part, float* dh0, float* ckpt, int B,
                             int S, int D, int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{u,   dt,      Bm,      Cm,      A,   h0,   dy,
                    dh_last, du,  ddt,     dB_part, dC_part, dA_part,
                    dh0, ckpt, B, S,       D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: return static_cast<int>(launch<8>(p, s));
    case 16: return static_cast<int>(launch<16>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
