// Mamba's selective scan for NVIDIA Hopper (sm_90a), CUDA C++: the forward,
// states in registers (variant "reg"; selective_scan.cu, variant "lane",
// is the first design, kept as the comparison).
//
// Replaces no Pallas kernel: the reference computes the scan in plain JAX
// (`_ssm_scan_chunked` in src/repro/models/ssm.py). In float32,
//
//   h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t,   y_t = sum_n h_t C_t
//
// from h0 (or zeros); returns y and the last state.
//
// Bound on the H100. At jamba's prefill (B=8, S=1024, d_inner 8192, N 16) it
// must take B S d_inner N = 1.07 G exponentials, 0.26 ms at the SFU's 16 a
// clock on each of 132 SMs (4.18 T/s), and move 0.81 GB, 0.24 ms at 3.35
// TB/s. There is no product a tensor core could take: A is diagonal and each
// y sums 16 terms. So the kernel is built to spend one MUFU an element and
// little else, with the loads off the walk's path:
//
// - A thread holds K states of one channel in registers: K = N where B
//   d_inner fills the card (65,536 threads at the prefill), K = 4 where it
//   does not (training's B=1: 32,768 threads of four chains each); the
//   wrapper picks K (`ops.fwd_states`). The L = N / K lanes of a channel are
//   neighbours in a warp. dt, u and dt u are read once a (step, channel) and
//   reused over the K states; B_t and C_t, shared by every channel of a
//   batch row, are read as broadcast float4 loads.
// - One exponential an element: A' = A log2(e) once, then a = ex2(dt A') is
//   one FMUL and one MUFU.EX2; the rest is the (dt u) B product, the h FFMA
//   and the y FFMA: five instructions a MUFU, under the eight issue slots a
//   warp's MUFU takes on its sub-partition's four SFU lanes.
// - Loads overlap the walk: tiles of T steps of u and dt (T x channels,
//   coalesced, 16-byte cp.async where d_inner is a multiple of 4) and of B
//   and C go through a three-slot ring in shared memory, two tiles ahead; one
//   __syncthreads a tile, none inside a tile's walk.
// - No padded steps: the last tile, and S = 1 at decode, walk only the steps
//   that exist (a tile's walk is instantiated full and partial).
// - y sums its K states in order in the thread, then over the channel's L
//   lanes by one butterfly per L steps (`ssm::transpose_sum`): a fixed
//   order, no atomics, repeated calls give the same bits.
// Channels past d_inner read zeros and store nothing.

#include <cuda_runtime.h>

#include "selective_scan_reg.cuh"

namespace {

template <int N, int K>
struct FwdShape {
  static constexpr int L = N / K;             // lanes of a channel
  static constexpr int NT = 128;              // threads a block
  static constexpr int CH = NT / L;           // channels a block
  static constexpr int T = K == N ? 8 : 16;   // steps a tile
  static constexpr int SLOTS = 3;             // tiles in the ring
  // K = N: at most 128 registers, so that four blocks (512 threads) share an
  // SM and the prefill's 512 blocks run in one wave; K = 4 needs fewer
  static constexpr int MIN_BLOCKS = K == N ? 4 : 2;
  static_assert(N % K == 0 && K % 4 == 0 && 32 % L == 0, "state split");
  static_assert(T % L == 0, "a tile holds whole butterflies");
};

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
  bool vec;         // 16-byte copies: D % 4 == 0, u, dt, Bm, Cm aligned
};

// One tile's walk: n steps (all T when FULL) from the ring slot `su`..`sC`.
template <int N, int K, bool FULL>
__device__ __forceinline__ void walk(float (&h)[K], const float (&a2)[K],
                                     const float* su, const float* sdt,
                                     const float* sB, const float* sC,
                                     float* y, int n, int c, int j,
                                     bool live, int D) {
  using F = FwdShape<N, K>;
  constexpr int L = F::L, CH = F::CH;
#pragma unroll
  for (int g = 0; g < F::T / L; ++g) {
    if (!FULL && g * L >= n) break;
    float v[L];
#pragma unroll
    for (int jj = 0; jj < L; ++jj) {
      const int tt = g * L + jj;
      v[jj] = 0.f;
      if (FULL || tt < n) {
        const float dtv = sdt[tt * CH + c];
        const float dtu = dtv * su[tt * CH + c];
        float Bv[K], Cv[K];
        ssm_reg::load4<K>(Bv, sB + tt * N + j * K);
        ssm_reg::load4<K>(Cv, sC + tt * N + j * K);
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          h[k] = fmaf(ssm_ptx::ex2(dtv * a2[k]), h[k], dtu * Bv[k]);
          acc = fmaf(h[k], Cv[k], acc);
        }
        v[jj] = acc;
      }
    }
    float ys;
    if constexpr (L == 1) {
      ys = v[0];
    } else {
      ys = ssm::transpose_sum<L>(v, j);
    }
    const int tt = g * L + (L == 1 ? 0 : j);
    if (live && (FULL || tt < n)) y[(size_t)tt * D] = ys;
  }
}

template <int N, int K>
__global__ void __launch_bounds__(FwdShape<N, K>::NT,
                                  FwdShape<N, K>::MIN_BLOCKS)
    ssm_fwd_reg(FwdParams p) {
  using F = FwdShape<N, K>;
  constexpr int L = F::L, NT = F::NT, CH = F::CH, T = F::T, SLOTS = F::SLOTS;
  __shared__ __align__(16) float s_u[SLOTS][T * CH];
  __shared__ __align__(16) float s_dt[SLOTS][T * CH];
  __shared__ __align__(16) float s_B[SLOTS][T * N];
  __shared__ __align__(16) float s_C[SLOTS][T * N];
  const int tid = threadIdx.x;
  const int c = tid / L, j = tid % L;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH, d = d0 + c;
  const bool live = d < p.D;
  const int S = p.S, D = p.D;
  const size_t base = (size_t)b * S * D;
  const float* Bm = p.Bm + (size_t)b * S * N;
  const float* Cm = p.Cm + (size_t)b * S * N;
  const size_t hidx = ((size_t)b * D + d) * N + j * K;

  float a2[K], h[K];
  if (live) {
    ssm_reg::load4<K>(a2, p.A + (size_t)d * N + j * K);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) a2[k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) a2[k] *= ssm_reg::LOG2E;
  if (live && p.h0) {
    ssm_reg::load4<K>(h, p.h0 + hidx);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) h[k] = 0.f;
  }

  const int tiles = (S + T - 1) / T;
  auto fill = [&](int k) {  // tile k into its ring slot, then commit
    if (k < tiles) {
      const int slot = k % SLOTS, t0 = k * T;
      ssm_reg::stage<T, CH, NT>(s_u[slot], p.u + base, t0, d0, S, D, D,
                                p.vec, tid);
      ssm_reg::stage<T, CH, NT>(s_dt[slot], p.dt + base, t0, d0, S, D, D,
                                p.vec, tid);
      ssm_reg::stage<T, N, NT>(s_B[slot], Bm, t0, 0, S, N, N, p.vec, tid);
      ssm_reg::stage<T, N, NT>(s_C[slot], Cm, t0, 0, S, N, N, p.vec, tid);
    }
    ssm_ptx::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < SLOTS - 1; ++k) fill(k);
  for (int k = 0; k < tiles; ++k) {
    ssm_ptx::cp_async_wait<SLOTS - 2>();  // tile k has landed (this thread)
    __syncthreads();  // ... for every thread; tile k - 1's slot is free
    fill(k + SLOTS - 1);
    const int slot = k % SLOTS, t0 = k * T;
    const int n = S - t0 < T ? S - t0 : T;
    float* y = p.y + base + (size_t)t0 * D + d;
    if (n == T)
      walk<N, K, true>(h, a2, s_u[slot], s_dt[slot], s_B[slot], s_C[slot], y,
                       n, c, j, live, D);
    else
      walk<N, K, false>(h, a2, s_u[slot], s_dt[slot], s_B[slot], s_C[slot],
                        y, n, c, j, live, D);
  }
  if (live) ssm_reg::store4<K>(p.h_last + hidx, h);
}

template <int N, int K>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  constexpr int CH = FwdShape<N, K>::CH;
  const dim3 grid((p.D + CH - 1) / CH, p.B);
  ssm_fwd_reg<N, K><<<grid, FwdShape<N, K>::NT, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

}  // namespace

// All tensors float32 and contiguous: u, dt, y (B, S, D); Bm, Cm (B, S, N);
// A (D, N); h0 (B, D, N) or null; h_last (B, D, N). A, h0 and h_last 16-byte
// aligned. N is 8 or 16; K, the states a thread holds, is N or 4. Returns
// the cudaError_t of the launch.
extern "C" int repro_ssm_reg_fwd(const float* u, const float* dt,
                                 const float* Bm, const float* Cm,
                                 const float* A, const float* h0, float* y,
                                 float* h_last, int B, int S, int D, int N,
                                 int K, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(A) || (h0 && !aligned16(h0)) || !aligned16(h_last))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool vec = D % 4 == 0 && aligned16(u) && aligned16(dt) &&
                   aligned16(Bm) && aligned16(Cm);
  const FwdParams p{u, dt, Bm, Cm, A, h0, y, h_last, B, S, D, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 16 && K == 16) return static_cast<int>(launch<16, 16>(p, s));
  if (N == 16 && K == 4) return static_cast<int>(launch<16, 4>(p, s));
  if (N == 8 && K == 8) return static_cast<int>(launch<8, 8>(p, s));
  if (N == 8 && K == 4) return static_cast<int>(launch<8, 4>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
