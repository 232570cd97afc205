// Mamba's selective scan for NVIDIA Hopper (sm_90a), CUDA C++: the backward,
// states in registers (variant "reg"; selective_scan_bwd.cu, variant "lane",
// is the first design, kept as the comparison).
//
// The gradient of the forward (which replaces no Pallas kernel: the
// reference differentiates its plain-JAX `_ssm_scan_chunked`). With g_t the
// cotangent of h_t, carried back from g_S = dh_last,
//
//   g_t   = dy_t C_t + a_{t+1} g_{t+1},          a_t = exp(dt_t A),
//   du_t  = sum_n g_t B_t dt_t,                  dB_t = sum_d g_t dt_t u_t,
//   ddt_t = sum_n (g_t B_t u_t + g_t a_t h_{t-1} A),
//   dC_t  = sum_d dy_t h_t,   dA = sum_{b,t} g_t a_t h_{t-1} dt_t,
//   dh0   = a_1 g_1.
//
// Bound on the H100. At jamba's training shape (B=1, S=2048, d_inner 8192,
// N 16) it must read u, dt, dy and write du, ddt (B, S, d_inner), 0.34 GB:
// 0.10 ms at 3.35 TB/s; and take at least one exponential an element, 0.27
// G: 0.064 ms at the SFU's 4.18 T/s.
//
// Design. A thread holds K = 4 states of one channel; the L = N / 4 lanes of
// a channel are neighbours in a warp; a block of 256 threads covers CH =
// 256 / L channels (64 at N 16). All inputs of a sub-tile of ST = 8 steps
// (u, dt, dy: ST x CH, coalesced; B and C: ST x N; the reverse walk's
// start state: CH x N) come through a four-slot cp.async ring in shared
// memory, three sub-tiles ahead, with one __syncthreads at a sub-tile's
// start and none inside its walks.
// 1. The first walk runs forward and writes the state before each sub-tile
//    (but the last) to a workspace the wrapper allocates: one exponential an
//    element.
// 2. The reverse walk takes the sub-tiles from the last. For each it
//    recomputes the ST states and their a = exp(dt A) into registers from
//    the sub-tile's start state, the second and last exponential an
//    element: ST x K x 2 = 64 registers. It then walks them back, carrying
//    g in registers; no third exponential.
// 3. du and ddt sum the thread's 4 states in registers, then the channel's
//    L lanes by one butterfly per L steps (`ssm::transpose_sum`).
// 4. dBm and dCm sum over d_inner. Each step, the two channels of a pair
//    (neighbour lanes L apart) add their terms by one shuffle each: the
//    lower channel keeps the pair's 4 dB terms, the upper its 4 dC terms,
//    and each stores them as one float4 into a row per (step, pair) in
//    shared memory (a quarter-warp stores one 128-byte row). One output a
//    thread then sums the block's 32 pairs, in a fixed order. The sums
//    trail the walk by one sub-tile (rows double-buffered), so a sub-tile
//    takes one __syncthreads and its sums run beside the next walk. The
//    dBm and dCm terms still cost a quarter of the kernel (`python -m
//    repro_torch.kernels.ssm.ablate`, which also times the walk's phases
//    with clock64). One
//    partial a block is written, (B, S, blocks, 2N): 33.5 MB at the
//    training shape (blocks of 16 channels made 134 MB).
//    `ssm_bwd_reg_finish` sums the partials over the blocks, and dA over the
//    batch, in a fixed order. No atomics: repeated calls give the same bits.
// 5. At B=1 and d_inner 8192 that is 128 blocks of 256 threads: one wave on
//    132 SMs, one block a SM (registers uncapped; the thread count, not the
//    registers, sets the occupancy at B=1).
// Channels past d_inner read zeros (their terms are zeros); steps past S
// are neither loaded nor walked.

#include <cuda_runtime.h>

#include "selective_scan_reg.cuh"

namespace {

template <int N>
struct BwdShape {
  static constexpr int K = 4;                   // states a thread
  static constexpr int L = N / K;               // lanes of a channel
  static constexpr int NT = 256;                // threads a block
  static constexpr int CH = NT / L;             // channels a block
  static constexpr int PAIRS = CH / 2;          // channel pairs a block
  static constexpr int ST = 8;                  // steps a sub-tile
  static constexpr int SLOTS = 4;               // sub-tiles in the ring
  // shared memory in floats: a ring slot (u, dt, dy: ST x CH; B, C: ST x N;
  // the start state: CH x N) and two buffers of rows (ST x PAIRS x 2N)
  static constexpr int HS = 3 * ST * CH + 2 * ST * N;  // the start state
  static constexpr int SLOT = HS + CH * N;
  static constexpr int RED = ST * PAIRS * 2 * N;
  static constexpr size_t SMEM =
      sizeof(float) * (SLOTS * SLOT + 2 * RED);
  static_assert(L == 2 || L == 4, "N is 8 or 16");
  static_assert(PAIRS % 4 == 0, "the sum's four accumulators");
  static_assert(ST * 2 * N <= NT, "one output a thread");
  static_assert(ST % L == 0, "a sub-tile holds whole butterflies");
  static_assert(SMEM <= 227 * 1024, "shared memory over 227 KB");
};

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
  float* part;     // (B, S, blocks, 2N): dBm's, then dCm's sums a block
  float* dA_part;  // (B, D, N)
  float* dh0;      // (B, D, N)
  float* ckpt;     // (B, sub-tiles, D, N): the state before each sub-tile
  int B, S, D;
  bool vec;        // 16-byte copies: D % 4 == 0, u, dt, dy, Bm, Cm aligned
};

// A sub-tile's states and their exp(dt A), recomputed into registers from
// its start state `hs` and its ring slot `q` (n steps; all ST when FULL):
// the second and last exponential an element.
template <int N, bool FULL, int K = BwdShape<N>::K>
__device__ __forceinline__ void recompute(
    const float* q, const float (&hs)[K], const float (&a2)[K],
    float (&H)[BwdShape<N>::ST][K], float (&E)[BwdShape<N>::ST][K],
    int n, int c, int j) {
  using G = BwdShape<N>;
  constexpr int CH = G::CH, ST = G::ST;
  const float* su = q;
  const float* sdt = q + ST * CH;
  const float* sB = q + 3 * ST * CH;
  float hh[K];
#pragma unroll
  for (int k = 0; k < K; ++k) hh[k] = hs[k];
#pragma unroll
  for (int tt = 0; tt < ST; ++tt) {
    if (FULL || tt < n) {
      const float dtv = sdt[tt * CH + c];
      const float dtu = dtv * su[tt * CH + c];
      float Bv[K];
      ssm_reg::load4<K>(Bv, sB + tt * N + j * K);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        E[tt][k] = ssm_ptx::ex2(dtv * a2[k]);
        hh[k] = fmaf(E[tt][k], hh[k], dtu * Bv[k]);
        H[tt][k] = hh[k];
      }
    }
  }
}

// A sub-tile walked back (n steps; all ST when FULL) from its ring slot `q`,
// its start state `hs` and its recomputed H and E, carrying g in `gc`:
// stores du and ddt, adds to dA, and leaves each step's dB and dC terms,
// summed over each channel pair, in the rows `red`.
template <int N, bool FULL, int K = BwdShape<N>::K>
__device__ __forceinline__ void walk_back(
    const float* q, float* red, const float (&hs)[K],
    const float (&H)[BwdShape<N>::ST][K],
    const float (&E)[BwdShape<N>::ST][K], float (&gc)[K], float (&dA)[K],
    const float (&A)[K], float* du, float* ddt, int n, int c, int j,
    bool live, int D) {
  using G = BwdShape<N>;
  constexpr int L = G::L, CH = G::CH, ST = G::ST;
  const float* su = q;
  const float* sdt = q + ST * CH;
  const float* sdy = q + 2 * ST * CH;
  const float* sB = q + 3 * ST * CH;
  const float* sC = sB + ST * N;
  const bool upper = c & 1;  // the pair's upper channel keeps the dC sums
  float* rows = red + (size_t)(c >> 1) * 2 * N + (upper ? N : 0) + j * K;
#pragma unroll
  for (int g = ST / L - 1; g >= 0; --g) {
    if (!FULL && g * L >= n) continue;
    float vdu[L], vddt[L];
#pragma unroll
    for (int jj = L - 1; jj >= 0; --jj) {
      const int tt = g * L + jj;
      vdu[jj] = 0.f;
      vddt[jj] = 0.f;
      if (FULL || tt < n) {
        const float dtv = sdt[tt * CH + c];
        const float uv = su[tt * CH + c];
        const float dyv = sdy[tt * CH + c];
        const float dtu = dtv * uv;
        float Bv[K], Cv[K], rB[K], rC[K];
        ssm_reg::load4<K>(Bv, sB + tt * N + j * K);
        ssm_reg::load4<K>(Cv, sC + tt * N + j * K);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float hp = tt > 0 ? H[tt > 0 ? tt - 1 : 0][k] : hs[k];
          const float gt = fmaf(dyv, Cv[k], gc[k]);
          s1 = fmaf(gt, Bv[k], s1);  // sum_n g B
          const float ga = gt * (E[tt][k] * hp);
          s2 = fmaf(ga, A[k], s2);
          dA[k] = fmaf(ga, dtv, dA[k]);
          rB[k] = gt * dtu;
          rC[k] = dyv * H[tt][k];
          gc[k] = E[tt][k] * gt;
        }
        float keep[K];  // the pair's sums: dB terms (lower), dC (upper)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float send = upper ? rB[k] : rC[k];
          keep[k] = (upper ? rC[k] : rB[k]) +
                    __shfl_xor_sync(0xffffffffu, send, L);
        }
        ssm_reg::store4<K>(rows + (size_t)tt * G::PAIRS * 2 * N, keep);
        vdu[jj] = s1 * dtv;
        vddt[jj] = fmaf(s1, uv, s2);
      }
    }
    const float du_s = ssm::transpose_sum<L>(vdu, j);
    const float ddt_s = ssm::transpose_sum<L>(vddt, j);
    const int tt = g * L + j;
    if (live && (FULL || tt < n)) {
      du[(size_t)tt * D] = du_s;
      ddt[(size_t)tt * D] = ddt_s;
    }
  }
}

// A sub-tile's rows summed over the block's channel pairs, one output a
// thread (four accumulators over quarters of the pairs, added in a fixed
// order), into the block's partial of steps t0 .. t0 + n - 1 at `out`.
template <int N>
__device__ __forceinline__ void sum_rows(const float* red, float* out, int n,
                                         int nblk, int tid) {
  using G = BwdShape<N>;
  constexpr int ST = G::ST, TWO_N = 2 * N, P4 = G::PAIRS / 4;
  if (tid >= ST * TWO_N) return;
  const int tt = tid / TWO_N, col = tid % TWO_N;
  if (tt >= n) return;
  const float* r = red + (size_t)tt * G::PAIRS * TWO_N + col;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int m = 0; m < P4; ++m) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += r[(size_t)(q * P4 + m) * TWO_N];
  }
  out[(size_t)tt * nblk * TWO_N + col] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <int N>
__global__ void __launch_bounds__(BwdShape<N>::NT, 1)
    ssm_bwd_reg(BwdParams p) {
  using G = BwdShape<N>;
  constexpr int K = G::K, L = G::L, NT = G::NT, CH = G::CH, ST = G::ST;
  constexpr int SLOTS = G::SLOTS, TWO_N = 2 * N;
  extern __shared__ __align__(16) float smem[];
  float* red = smem + SLOTS * G::SLOT;  // two buffers of G::RED
  const int tid = threadIdx.x;
  const int c = tid / L, j = tid % L;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * CH, d = d0 + c;
  const bool live = d < p.D;
  const int S = p.S, D = p.D;
  const int subs = (S + ST - 1) / ST;
  const size_t base = (size_t)b * S * D;
  const float* Bm = p.Bm + (size_t)b * S * N;
  const float* Cm = p.Cm + (size_t)b * S * N;
  const size_t hidx = ((size_t)b * D + d) * N + j * K;
  float A[K], a2[K];
  if (live) {
    ssm_reg::load4<K>(A, p.A + (size_t)d * N + j * K);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) A[k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) a2[k] = A[k] * ssm_reg::LOG2E;
  // sub-tile s into ring slot `slot`: u, dt and B; dy, C and (from the
  // workspace) the start state too for the reverse walk
  auto fill = [&](int slot, int s, bool grads) {
    float* q = smem + slot * G::SLOT;
    const int t0 = s * ST;
    ssm_reg::stage<ST, CH, NT>(q, p.u + base, t0, d0, S, D, D, p.vec, tid);
    ssm_reg::stage<ST, CH, NT>(q + ST * CH, p.dt + base, t0, d0, S, D, D,
                               p.vec, tid);
    if (grads)
      ssm_reg::stage<ST, CH, NT>(q + 2 * ST * CH, p.dy + base, t0, d0, S, D,
                                 D, p.vec, tid);
    ssm_reg::stage<ST, N, NT>(q + 3 * ST * CH, Bm, t0, 0, S, N, N, p.vec,
                              tid);
    if (grads)
      ssm_reg::stage<ST, N, NT>(q + 3 * ST * CH + ST * N, Cm, t0, 0, S, N, N,
                                p.vec, tid);
    if (grads && s < subs - 1)  // the last one's is the first walk's h
      ssm_reg::stage<1, CH * N, NT>(q + G::HS,
                                    p.ckpt + (size_t)b * subs * D * N, s,
                                    d0 * N, subs, D * N, D * N, p.vec, tid);
  };

  // 1. the first walk: the state before each sub-tile but the last
  float h[K];
  if (live && p.h0) {
    ssm_reg::load4<K>(h, p.h0 + hidx);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) h[k] = 0.f;
  }
  const int walks = subs - 1;
#pragma unroll
  for (int i = 0; i < SLOTS - 1; ++i) {
    if (i < walks) fill(i, i, false);
    ssm_ptx::cp_async_commit();
  }
  for (int s = 0; s < walks; ++s) {
    ssm_ptx::cp_async_wait<SLOTS - 2>();
    __syncthreads();
    {
      const int nx = s + SLOTS - 1;
      if (nx < walks) fill(nx % SLOTS, nx, false);
      ssm_ptx::cp_async_commit();
    }
    if (live)
      ssm_reg::store4<K>(p.ckpt + (((size_t)b * subs + s) * D + d) * N + j * K,
                         h);
    const float* q = smem + (s % SLOTS) * G::SLOT;
#pragma unroll
    for (int tt = 0; tt < ST; ++tt) {
      const float dtv = q[ST * CH + tt * CH + c];
      const float dtu = dtv * q[tt * CH + c];
      float Bv[K];
      ssm_reg::load4<K>(Bv, q + 3 * ST * CH + tt * N + j * K);
#pragma unroll
      for (int k = 0; k < K; ++k)
        h[k] = fmaf(ssm_ptx::ex2(dtv * a2[k]), h[k], dtu * Bv[k]);
    }
  }
  ssm_ptx::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the reverse walk

  // 2. the reverse walk, from the last sub-tile; h is its start state
  float gc[K], dA[K];
  if (live) {
    ssm_reg::load4<K>(gc, p.dh_last + hidx);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) gc[k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) dA[k] = 0.f;
#pragma unroll
  for (int i = 0; i < SLOTS - 1; ++i) {
    if (subs - 1 - i >= 0) fill(i, subs - 1 - i, true);
    ssm_ptx::cp_async_commit();
  }
  float H[ST][K], E[ST][K];  // a sub-tile's states and exp(dt A)
  auto steps = [&](int s) { return S - s * ST < ST ? S - s * ST : ST; };
  // The sums of dBm and dCm trail the walk by one step of the loop: step i
  // walks into rows[i & 1] and sums the rows of step i - 1, which its
  // barrier has made whole; one more step drains the sums.
  for (int i = 0; i < subs + 1; ++i) {
    ssm_ptx::cp_async_wait<SLOTS - 2>();
    __syncthreads();  // sub-tile subs-1-i has landed; the last rows are in
    if (i >= 1) {
      const int s1 = subs - i;
      sum_rows<N>(red + ((i - 1) & 1) * G::RED,
                  p.part + (((size_t)b * S + s1 * ST) * nblk + blk) * TWO_N,
                  steps(s1), nblk, tid);
    }
    if (i < subs) {
      const int s = subs - 1 - i, t0 = s * ST, n = steps(s);
      {
        const int sn = s - (SLOTS - 1);
        if (sn >= 0) fill((i + SLOTS - 1) % SLOTS, sn, true);
        ssm_ptx::cp_async_commit();
      }
      const float* q = smem + (i % SLOTS) * G::SLOT;
      if (i > 0) ssm_reg::load4<K>(h, q + G::HS + c * N + j * K);
      float* du = p.du + base + (size_t)t0 * D + d;
      float* ddt = p.ddt + base + (size_t)t0 * D + d;
      float* rows = red + (i & 1) * G::RED;
      if (n == ST) {
        recompute<N, true>(q, h, a2, H, E, n, c, j);
        walk_back<N, true>(q, rows, h, H, E, gc, dA, A, du, ddt, n, c, j,
                           live, D);
      } else {
        recompute<N, false>(q, h, a2, H, E, n, c, j);
        walk_back<N, false>(q, rows, h, H, E, gc, dA, A, du, ddt, n, c, j,
                            live, D);
      }
    }
  }
  if (live) {
    ssm_reg::store4<K>(p.dA_part + hidx, dA);
    ssm_reg::store4<K>(p.dh0 + hidx, gc);
  }
}

// dBm and dCm: the blocks' partials summed in block order; dA: the batch
// rows' in row order. One output a thread, grid-strided.
template <int N>
__global__ void __launch_bounds__(256)
    ssm_bwd_reg_finish(const float* part, const float* dA_part, float* dBm,
                       float* dCm, float* dA, int B, int S, int D, int nblk) {
  constexpr int TWO_N = 2 * N;
  const size_t rows = (size_t)B * S * TWO_N, cols = (size_t)D * N;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < rows + cols; i += stride) {
    if (i < rows) {
      const size_t bs = i / TWO_N;
      const int col = static_cast<int>(i % TWO_N);
      const float* src = part + bs * nblk * TWO_N + col;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < nblk; ++k) acc += src[(size_t)k * TWO_N];
      if (col < N)
        dBm[bs * N + col] = acc;
      else
        dCm[bs * N + col - N] = acc;
    } else {
      const size_t o = i - rows;
      float acc = 0.f;
      for (int bb = 0; bb < B; ++bb) acc += dA_part[(size_t)bb * cols + o];
      dA[o] = acc;
    }
  }
}

template <int N>
cudaError_t launch(const BwdParams& p, float* dBm, float* dCm, float* dA,
                   cudaStream_t stream) {
  using G = BwdShape<N>;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd_reg<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return err;
  const int nblk = (p.D + G::CH - 1) / G::CH;
  ssm_bwd_reg<N><<<dim3(nblk, p.B), G::NT, G::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)p.B * p.S * 2 * N + (size_t)p.D * N;
  const size_t want = (total + 255) / 256, cap = 132 * 16;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  ssm_bwd_reg_finish<N><<<blocks, 256, 0, stream>>>(
      p.part, p.dA_part, dBm, dCm, dA, p.B, p.S, p.D, nblk);
  return cudaGetLastError();
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

}  // namespace

// All tensors float32 and contiguous: u, dt, dy, du, ddt (B, S, D); Bm, Cm,
// dBm, dCm (B, S, N); A, dA (D, N); h0 (B, D, N) or null; dh_last, dA_part,
// dh0 (B, D, N); part (B, S, blocks, 2N) with blocks = ceil(D /
// repro_ssm_reg_bwd_channels(N)); ckpt (B, ceil(S / 8), D, N). A, h0,
// dh_last, dA_part, dh0 and ckpt 16-byte aligned. N is 8 or 16. Two
// launches: the walk, then the sums of the partials. Returns the
// cudaError_t of the first that fails.
extern "C" int repro_ssm_reg_bwd(const float* u, const float* dt,
                                 const float* Bm, const float* Cm,
                                 const float* A, const float* h0,
                                 const float* dy, const float* dh_last,
                                 float* du, float* ddt, float* part,
                                 float* dA_part, float* dBm, float* dCm,
                                 float* dA, float* dh0, float* ckpt, int B,
                                 int S, int D, int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(A) || (h0 && !aligned16(h0)) || !aligned16(dh_last) ||
      !aligned16(dA_part) || !aligned16(dh0) || !aligned16(ckpt))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool vec = D % 4 == 0 && aligned16(u) && aligned16(dt) &&
                   aligned16(dy) && aligned16(Bm) && aligned16(Cm);
  const BwdParams p{u,   dt,   Bm,      Cm,      A,   h0,   dy,
                    dh_last, du, ddt, part, dA_part, dh0, ckpt,
                    B,   S,    D,       vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: return static_cast<int>(launch<8>(p, dBm, dCm, dA, s));
    case 16: return static_cast<int>(launch<16>(p, dBm, dCm, dA, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Channels one block of the backward covers at d_state N (its partials of
// dBm and dCm come one per such block), or -1 for an N it does not take.
extern "C" int repro_ssm_reg_bwd_channels(int N) {
  return N == 8 ? BwdShape<8>::CH : N == 16 ? BwdShape<16>::CH : -1;
}

// Steps a sub-tile of the backward walks (its workspace keeps the state
// before each).
extern "C" int repro_ssm_reg_bwd_steps() { return BwdShape<16>::ST; }
