// Flash attention backward for NVIDIA Hopper (sm_90a) on bf16 tensor cores
// (mma.sync), CUDA C++: bf16 q, k, v, o and dO at head dims 64 and 128.
// The training path runs its successor, flash_attention_bwd_sm90.cu
// (wgmma, TMA, the forward's LSE); this design stays as the comparison,
// launched by name. float32 inputs and the other head dims run the first
// design, flash_attention_bwd.cu (float32 FMAs). All three compute the
// same function.
//
// The gradient of the forward kernels in this folder, which replace the
// Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:94 (the
// reference has no backward kernel: it differentiates `_plain_gqa`). Same
// masks, GQA, q_offset, softcap, ragged edges and zero gradient for a fully
// masked row as the first design, and the same three kernels in stream
// order, no atomics:
//   (a) bwd_prep_mma, per (64 queries, head, batch): the rows' LSE over
//       their visible keys and D = rowsum(dO o O), float32 into scratch;
//   (b) bwd_dkdv_mma, per (64 keys, KV head, batch): dK and dV in
//       registers over the G heads and the query tiles (32 rows) that see
//       those keys;
//   (c) bwd_dq_mma, per (64 queries, head, batch): dQ in registers over
//       the key tiles (32 rows) it sees.
//
// Bound on the H100. At the granite-8b training shape (B=1, S=2048, H=32,
// KV=8, hd=128, causal) the four backward products are 68.75 GFLOP, 0.0695
// ms at 989 TFLOP/s of bf16 tensor-core rate (0.025 ms for the 80 MiB moved):
// bound by its operations. What the design does about it:
//
// * Every product runs on tensor cores: mma.sync m16n8k16 bf16 with float32
//   accumulators (wgmma, the only way to the full rate, is the design of
//   flash_attention_bwd_sm90.cu). Each of the 4 warps of a block owns 16
//   rows of the block's tile: the S (or S^T) and dP tiles of its rows stay
//   in registers, and so do its dK and dV (or dQ) accumulators.
// * P and dS are rounded to bf16 for the products that take them (dV, dK,
//   dQ); their accumulator fragments are the A fragments of those products
//   directly (two adjacent 16 x 8 accumulator tiles are one 16 x 16 A
//   fragment), so they never pass through shared memory. The rounding
//   costs at most 2^-9 of each term; the card's gate (2^-6 of the scale)
//   allows it.
// * The operands that enter as B with their other axis contracted (dO and
//   Q in (b), K in (c)) are also kept transposed in shared memory, so
//   that every fragment is one 32-bit load. Row strides of hd + 8 (and 40
//   for the transposed tiles) put the 32 lanes of a fragment load in 32
//   banks.
// * Tiles outside the causal cone or the window are skipped, as in the
//   first design; S is still recomputed in (a), (b) and (c), and dP in (b)
//   and (c): 16 hd operations per visible pair and head against the
//   bound's 8. flash_attention_bwd_sm90.cu takes the LSE from the forward
//   instead, which removes S from (a): 14.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_ptx.cuh"

namespace {

using namespace fbwd;
using bf16 = __nv_bfloat16;

constexpr int NT = 128;          // 4 warps, 16 rows each
constexpr int BM = 64;           // rows of the block's own tile
constexpr int BN = 32;           // rows of each tile (b) and (c) loop over
constexpr int BK = 64;           // key tile of (a)
constexpr int TS = BN + 8;       // row stride of a transposed (hd x BN) tile
constexpr float NEG = -1e30f;    // finite "minus infinity" for the running max

#include "flash_bwd_common.cuh"

// Row stride (bf16) of a row-major (rows x hd) tile in shared memory.
template <int D> __host__ __device__ constexpr int rs() { return D + 8; }

// Rows [r0, r0 + R) of a (S, D) bf16 slice with row stride `ss` into
// shared memory: row-major at `rows_dst` (stride rs<D>()) when not null,
// transposed (D x R, stride TS) at `t_dst` when not null; rows past S
// zero. 16-byte loads: the wrapper checks the alignment.
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* rows_dst, bf16* t_dst,
                                          const bf16* src, long long ss,
                                          int r0, int S) {
  constexpr int CH = D / 8;                 // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const int gr = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < S)
      v = *reinterpret_cast<const uint4*>(src + (long long)gr * ss + c);
    if (rows_dst != nullptr)
      *reinterpret_cast<uint4*>(rows_dst + r * rs<D>() + c) = v;
    if (t_dst != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) t_dst[(c + j) * TS + r] = e[j];
    }
  }
}

// A fragment (16 x 16) of rows [r0, r0 + 16) and columns [k0, k0 + 16) of
// a row-major tile with row stride STR.
template <int STR>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int r0, int k0, int lane) {
  const bf16* p = s + (r0 + (lane >> 2)) * STR + k0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * STR);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * STR + 8);
}

// B fragment (16 x 8, k x n) whose element (k, n) is s[(n0 + n) * STR + k0
// + k]: the n axis runs over the rows of a row-major tile.
template <int STR>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int n0, int k0,
                                       int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * STR + k0 + (lane & 3) * 2;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// A fragments over a k axis of 16 columns per step, from float32
// accumulator tiles of 8 columns: tiles 2t and 2t + 1 make step t.
template <int NTILE>
__device__ __forceinline__ void to_a(uint32_t (&a)[NTILE / 2][4],
                                     const float (&c)[NTILE][4]) {
#pragma unroll
  for (int t = 0; t < NTILE / 2; ++t) {
    a[t][0] = pack_bf16(c[2 * t][0], c[2 * t][1]);
    a[t][1] = pack_bf16(c[2 * t][2], c[2 * t][3]);
    a[t][2] = pack_bf16(c[2 * t + 1][0], c[2 * t + 1][1]);
    a[t][3] = pack_bf16(c[2 * t + 1][2], c[2 * t + 1][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// Stores a warp's (16 x D) float32 accumulator times `mul` as bf16 rows
// r0 + g and r0 + g + 8 of a (S, D) slice with row stride `ss`.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long ss,
                                           const float (&c)[D / 8][4],
                                           int r0, int S, float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= S) continue;
    bf16* row = dst + (long long)r * ss + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(c[n][2 * half] * mul, c[n][2 * half + 1] * mul);
  }
}

// ---------------------------------------------------------------- (a) prep
template <int D>
__global__ void __launch_bounds__(NT) bwd_prep_mma(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);           // BM x rs
  bf16* sK = sQ + BM * rs<D>();                       // BK x rs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* O = static_cast<const bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const bf16* dO =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int qr = q0 + warp * 16 + g;                  // and qr + 8

  load_rows<D, BM>(sQ, nullptr, Q, p.q_ss, q0, p.Sq);
  __syncthreads();
  uint32_t aq[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a<rs<D>()>(aq[kk], sQ, warp * 16, kk * 16, lane);

  int k_begin, k_end;
  key_range(p, q0, BM, BK, &k_begin, &k_end);
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();                      // the previous sK is consumed
    load_rows<D, BK>(sK, nullptr, K, p.k_ss, kt, p.Sk);
    __syncthreads();
    float s[BK / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t b0, b1;
        load_b<rs<D>()>(b0, b1, sK, j * 8, kk * 16, lane);
        mma_16816(s[j], aq[kk], b0, b1);
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = qr + 8 * half;
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float tt;
          float& x = s[j][2 * half + e];
          x = score(p, x, &tt);
          if (!visible(p, q, kt + j * 8 + t * 2 + e)) x = NEG;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[half], mt);
      float rs_ = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * half + e];
          if (x > NEG) rs_ += expf(x - m_new);
        }
      rs_ += __shfl_xor_sync(0xffffffffu, rs_, 1);
      rs_ += __shfl_xor_sync(0xffffffffu, rs_, 2);
      l[half] = l[half] * expf(m[half] - m_new) + rs_;
      m[half] = m_new;
    }
  }

  const long long base = ((long long)b * p.H + h) * p.Sq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = qr + 8 * half;
    float dsum = 0.f;
    if (q < p.Sq) {
      const bf16* orow = O + (long long)q * p.o_ss;
      const bf16* grow = dO + (long long)q * p.do_ss;
      for (int c = t * 2; c < D; c += 8)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dsum = fmaf(__bfloat162float(grow[c + e]),
                      __bfloat162float(orow[c + e]), dsum);
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
    if (q < p.Sq && t == 0) {
      p.lse[base + q] = l[half] > 0.f ? m[half] + logf(l[half]) : inf();
      p.delta[base + q] = dsum;
    }
  }
}

// P and dS (with the softcap's derivative, without the scale) of one
// (16-row, BN-column) pair of accumulator tiles, in place: rows are keys
// (`keys_rows`, kernel (b)) or queries (kernel (c)).
template <bool keys_rows>
__device__ __forceinline__ void probs_and_dscores(
    const Params& p, float (&s)[BN / 8][4], float (&dp)[BN / 8][4],
    const float* s_lse, const float* s_delta, int row, int row_loc,
    int col0, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + 8 * (e >> 1);
      const int c = col0 + j * 8 + t * 2 + (e & 1);
      const int q = keys_rows ? c : r;
      const int k = keys_rows ? r : c;
      const int stat = keys_rows ? j * 8 + t * 2 + (e & 1)
                                 : row_loc + 8 * (e >> 1);
      float tt = 0.f;
      const float x = score(p, s[j][e], &tt);
      float pr = 0.f, ds = 0.f;
      if (visible(p, q, k)) {
        pr = expf(x - s_lse[stat]);
        ds = pr * (dp[j][e] - s_delta[stat]);
        if (p.softcap > 0.f) ds *= 1.f - tt * tt;
      }
      s[j][e] = pr;
      dp[j][e] = ds;
    }
}

// ---------------------------------------------------------------- (b) dK dV
template <int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_mma(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);           // BM x rs
  bf16* sV = sK + BM * rs<D>();                       // BM x rs
  bf16* sQ = sV + BM * rs<D>();                       // BN x rs
  bf16* sG = sQ + BN * rs<D>();                       // dO, BN x rs
  bf16* sQT = sG + BN * rs<D>();                      // D x TS
  bf16* sGT = sQT + D * TS;                           // D x TS
  float* s_lse = reinterpret_cast<float*>(sGT + D * TS);   // BN
  float* s_delta = s_lse + BN;                              // BN
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BM, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_rows<D, BM>(sK, nullptr, K, p.k_ss, k0, p.Sk);
  load_rows<D, BM>(sV, nullptr, V, p.v_ss, k0, p.Sk);
  const int kr = k0 + warp * 16 + (lane >> 2);        // and kr + 8

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  int q_begin, q_end;
  query_range(p, k0, BM, BN, &q_begin, &q_end);
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* dO =
        static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long base = ((long long)b * p.H + h) * p.Sq;
    for (int qt = q_begin; qt < q_end; qt += BN) {
      __syncthreads();                    // the previous tiles are consumed
      load_rows<D, BN>(sQ, sQT, Q, p.q_ss, qt, p.Sq);
      load_rows<D, BN>(sG, sGT, dO, p.do_ss, qt, p.Sq);
      for (int i = threadIdx.x; i < BN; i += NT) {
        const bool in = qt + i < p.Sq;
        s_lse[i] = in ? p.lse[base + qt + i] : inf();
        s_delta[i] = in ? p.delta[base + qt + i] : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys
      float s[BN / 8][4], dp[BN / 8][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a<rs<D>()>(ak, sK, warp * 16, kk * 16, lane);
        load_a<rs<D>()>(av, sV, warp * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          uint32_t b0, b1;
          load_b<rs<D>()>(b0, b1, sQ, j * 8, kk * 16, lane);
          mma_16816(s[j], ak, b0, b1);
          load_b<rs<D>()>(b0, b1, sG, j * 8, kk * 16, lane);
          mma_16816(dp[j], av, b0, b1);
        }
      }
      probs_and_dscores<true>(p, s, dp, s_lse, s_delta, kr, 0, qt, lane);
      uint32_t pa[BN / 16][4], da[BN / 16][4];
      to_a<BN / 8>(pa, s);
      to_a<BN / 8>(da, dp);
      // dV += P^T dO, dK += dS^T Q (the queries contracted)
#pragma unroll
      for (int tk = 0; tk < BN / 16; ++tk)
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1;
          load_b<TS>(b0, b1, sGT, n * 8, tk * 16, lane);
          mma_16816(dv[n], pa[tk], b0, b1);
          load_b<TS>(b0, b1, sQT, n * 8, tk * 16, lane);
          mma_16816(dk[n], da[tk], b0, b1);
        }
    }
  }
  bf16* dK = static_cast<bf16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  bf16* dV = static_cast<bf16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
  store_rows<D>(dK, p.dk_ss, dk, k0 + warp * 16, p.Sk, p.scale, lane);
  store_rows<D>(dV, p.dv_ss, dv, k0 + warp * 16, p.Sk, 1.f, lane);
}

// ---------------------------------------------------------------- (c) dQ
template <int D>
__global__ void __launch_bounds__(NT) bwd_dq_mma(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);           // BM x rs
  bf16* sG = sQ + BM * rs<D>();                       // dO, BM x rs
  bf16* sK = sG + BM * rs<D>();                       // BN x rs
  bf16* sV = sK + BN * rs<D>();                       // BN x rs
  bf16* sKT = sV + BN * rs<D>();                      // D x TS
  float* s_lse = reinterpret_cast<float*>(sKT + D * TS);   // BM
  float* s_delta = s_lse + BM;                              // BM
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dO =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const long long base = ((long long)b * p.H + h) * p.Sq;

  load_rows<D, BM>(sQ, nullptr, Q, p.q_ss, q0, p.Sq);
  load_rows<D, BM>(sG, nullptr, dO, p.do_ss, q0, p.Sq);
  for (int i = threadIdx.x; i < BM; i += NT) {
    const bool in = q0 + i < p.Sq;
    s_lse[i] = in ? p.lse[base + q0 + i] : inf();
    s_delta[i] = in ? p.delta[base + q0 + i] : 0.f;
  }
  const int row_loc = warp * 16 + (lane >> 2);        // and row_loc + 8
  float dq[D / 8][4];
  zero(dq);
  int k_begin, k_end;
  key_range(p, q0, BM, BN, &k_begin, &k_end);
  for (int kt = k_begin; kt < k_end; kt += BN) {
    __syncthreads();                      // the previous tiles are consumed
    load_rows<D, BN>(sK, sKT, K, p.k_ss, kt, p.Sk);
    load_rows<D, BN>(sV, nullptr, V, p.v_ss, kt, p.Sk);
    __syncthreads();
    // S = Q K^T and dP = dO V^T over this warp's 16 queries
    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      load_a<rs<D>()>(aq, sQ, warp * 16, kk * 16, lane);
      load_a<rs<D>()>(ag, sG, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t b0, b1;
        load_b<rs<D>()>(b0, b1, sK, j * 8, kk * 16, lane);
        mma_16816(s[j], aq, b0, b1);
        load_b<rs<D>()>(b0, b1, sV, j * 8, kk * 16, lane);
        mma_16816(dp[j], ag, b0, b1);
      }
    }
    probs_and_dscores<false>(p, s, dp, s_lse, s_delta, q0 + row_loc,
                             row_loc, kt, lane);
    uint32_t da[BN / 16][4];
    to_a<BN / 8>(da, dp);
    // dQ += dS K (the keys contracted)
#pragma unroll
    for (int tk = 0; tk < BN / 16; ++tk)
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b<TS>(b0, b1, sKT, n * 8, tk * 16, lane);
        mma_16816(dq[n], da[tk], b0, b1);
      }
  }
  bf16* dQ = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<D>(dQ, p.dq_ss, dq, q0 + warp * 16, p.Sq, p.scale, lane);
}

template <int D> constexpr size_t smem_prep() {
  return sizeof(bf16) * (BM + BK) * rs<D>();
}
template <int D> constexpr size_t smem_dkdv() {
  return sizeof(bf16) * ((2 * BM + 2 * BN) * rs<D>() + 2 * D * TS) +
         sizeof(float) * 2 * BN;
}
template <int D> constexpr size_t smem_dq() {
  return sizeof(bf16) * ((2 * BM + 2 * BN) * rs<D>() + D * TS) +
         sizeof(float) * 2 * BM;
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int q_tiles = (p.Sq + BM - 1) / BM;
  const int k_tiles = (p.Sk + BM - 1) / BM;
  cudaError_t err = launch_one(bwd_prep_mma<D>, dim3(q_tiles, p.H, p.B),
                               smem_prep<D>(), p, stream);
  if (err != cudaSuccess) return err;
  if (k_tiles > 0) {
    err = launch_one(bwd_dkdv_mma<D>, dim3(k_tiles, p.KV, p.B),
                     smem_dkdv<D>(), p, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_one(bwd_dq_mma<D>, dim3(q_tiles, p.H, p.B), smem_dq<D>(), p,
                    stream);
}

}  // namespace

// bf16 q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, KV, D); D 64 or
// 128; lse and delta: float32 (B, H, Sq) scratch. Strides in elements, the
// head dim contiguous; every base 16-byte aligned and every other stride a
// multiple of 8 elements (16-byte loads; the wrapper checks). Returns the
// cudaError_t of the launches.
extern "C" int repro_flash_attention_bwd_mma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse,
    float* delta, int B, int H, int KV, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, int window, int q_offset, float softcap,
    void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk < 0 ||
      (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,     k,     v,     o,     dout,  dq,    dk,    dv,
                 lse,   delta, B,     H,     KV,    Sq,    Sk,    q_sb,
                 q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,  v_sh,
                 o_sb,  o_ss,  o_sh,  do_sb, do_ss, do_sh, dq_sb, dq_ss,
                 dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale,
                 softcap, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(launch<64>(p, s));
  return static_cast<int>(launch<128>(p, s));
}
