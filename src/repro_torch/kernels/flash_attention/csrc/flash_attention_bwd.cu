// Flash attention backward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// The gradient of the forward kernels in this folder (flash_attention.cu,
// flash_attention_sm90.cu), which replace the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:94 (`flash_attention_kernel`).
// The reference has no backward kernel: it trains through XLA's attention
// (`_plain_gqa`, differentiated by JAX). The port sends every multi-token
// attention call of a training step to the forward kernel, so its backward
// is this kernel. It computes dQ, dK and dV of exactly the forward's
// function: GQA (head h reads KV head h / (H / KV)), scale 1/sqrt(hd),
// causal mask kpos <= qpos, window mask kpos > qpos - window, `q_offset`,
// `softcap` (s = c tanh(s_raw / c), so ds_raw = ds (1 - tanh^2)), ragged Sq
// and Sk, tensors read and written through strides with a contiguous head
// dim, and a zero gradient for a row whose every key is masked.
//
// With P = softmax(S) over the visible keys, O = P V and dO given:
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  D = rowsum(dO o O),
//   dQ = dS K scale,  dK = dS^T Q scale.
// Three kernels, in stream order, no atomics (so every call is bit-for-bit
// repeatable, which the plan runtime's gates need):
//   (a) bwd_prep, per (query tile, head, batch): the row's log-sum-exp over
//       its visible keys (the forward kernels do not emit it), recomputed
//       from Q K^T, and D from dO and O; both float32 into scratch.
//   (b) bwd_dkdv, per (key tile, KV head, batch): dK and dV of the tile,
//       accumulated in registers over the G query heads of the group and
//       every query tile that sees those keys.
//   (c) bwd_dq, per (query tile, head, batch): dQ of the tile, accumulated
//       in registers over the key tiles it sees.
// Tiles that lie wholly outside the causal cone or the window are skipped;
// the masks are applied per element.
//
// Bound on the H100. At the training shape of granite-8b (B=1, S=2048,
// H=32, KV=8, hd=128, bf16, causal) the four backward products over the
// visible (query, key) pairs are 8 B H hd S(S+1)/2 = 68.75 GFLOP, 0.0695 ms
// at 989 TFLOP/s of bf16 tensor-core rate, against 0.025 ms for the 80 MiB
// of q, k, v, o, dO, dq, dk and dv at 3.35 TB/s: bound by its operations. This first design runs every product as float32 FMAs from
// shared memory (the forward's first kernel's layout: 256 threads as 16 row
// groups x 16 column lanes, each thread a 4 x 4 score tile and a 4 x hd/16
// accumulator tile), plus the recomputed S twice and dP twice: about 16 hd
// operations per visible pair and head, at most the 67 TFLOP/s float32 rate
// outside the tensor cores. Emitting the LSE from the forward, mma/wgmma and
// TMA are the next design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads: 16 row groups x 16 column lanes
constexpr float NEG = -1e30f;    // finite "minus infinity" for the running max

#include "flash_bwd_common.cuh"

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tile rows: 64 up to hd 128; 32 at hd 192 and 256, so that the four
// hd-wide tiles of kernel (b) fit in shared memory (107,520 B at 192,
// 140,288 B at 256).
template <int D> __host__ __device__ constexpr int rows() {
  return D > 128 ? 32 : 64;
}
// Row stride of an hd-wide tile in shared memory: odd, so that 16 lanes
// reading 16 rows at one column hit 16 banks.
template <int D> __host__ __device__ constexpr int tstride() { return D + 1; }

// A (BM x D) tile of rows [r0, r0 + BM) of a (S, D) slice with row stride
// `ss` into shared memory as float32, rows past `S` zero.
template <typename T, int D, int BM>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int S) {
  constexpr int STR = tstride<D>();
  for (int i = threadIdx.x; i < BM * D; i += NT) {
    const int r = i / D, c = i % D;
    const int gr = r0 + r;
    dst[r * STR + c] = gr < S ? to_f32(src[(long long)gr * ss + c]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ra + i][d] * B[rb + 16 j][d] over two tiles with the
// tstride<D>() layout: the thread's RPT rows of A against its CPT rows of B.
template <int D, int RPT, int CPT>
__device__ __forceinline__ void dot_tile(float (&acc)[RPT][CPT],
                                         const float* A, int ra,
                                         const float* Bm, int rb) {
  constexpr int STR = tstride<D>();
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RPT], b[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = A[(ra + i) * STR + d];
#pragma unroll
    for (int j = 0; j < CPT; ++j) b[j] = Bm[(rb + 16 * j) * STR + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_j W[ra + i][j] * X[j][lane + 16 c]: W a (BM x BM) tile
// with row stride BM + 1, X an hd-wide tile.
template <int D, int BM, int RPT>
__device__ __forceinline__ void accumulate(float (&acc)[RPT][D / 16],
                                           const float* W, int ra,
                                           const float* X, int lane) {
  constexpr int STR = tstride<D>();
  constexpr int WSTR = BM + 1;
#pragma unroll 4
  for (int j = 0; j < BM; ++j) {
    float w[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) w[i] = W[(ra + i) * WSTR + j];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float x = X[j * STR + lane + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(w[i], x, acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------- (a) prep
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_prep(const Params p) {
  constexpr int BM = rows<D>();
  constexpr int RPT = BM / 16;
  constexpr int STR = tstride<D>();
  extern __shared__ float smem[];
  float* sQ = smem;                     // BM x STR
  float* sK = sQ + BM * STR;            // BM x STR

  const int lane = threadIdx.x & 15;
  const int row0 = (threadIdx.x >> 4) * RPT;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* O = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

  load_tile<T, D, BM>(sQ, Q, p.q_ss, q0, p.Sq);
  int k_begin, k_end;
  key_range(p, q0, BM, BM, &k_begin, &k_end);

  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
  }
  for (int kt = k_begin; kt < k_end; kt += BM) {
    __syncthreads();                    // the previous sK is consumed
    load_tile<T, D, BM>(sK, K, p.k_ss, kt, p.Sk);
    __syncthreads();
    float s[RPT][RPT];
    dot_tile<D, RPT, RPT>(s, sQ, row0, sK, lane);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mt = NEG;
      bool ok[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        float t;
        s[i][j] = score(p, s[i][j], &t);
        ok[j] = visible(p, q0 + row0 + i, kt + lane + 16 * j);
        if (ok[j]) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        if (ok[j]) rs += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }

  const long long base = ((long long)b * p.H + h) * p.Sq;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + row0 + i;
    float dsum = 0.f;
    if (qi < p.Sq) {
      const T* orow = O + (long long)qi * p.o_ss;
      const T* grow = dO + (long long)qi * p.do_ss;
      for (int c = lane; c < D; c += 16)
        dsum = fmaf(to_f32(grow[c]), to_f32(orow[c]), dsum);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (qi < p.Sq && lane == 0) {
      // a row with no visible key: +inf, so that no P of it is ever made
      p.lse[base + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : inf();
      p.delta[base + qi] = dsum;
    }
  }
}

// dS (and P) of one (row tile, column tile) pair: rows `r` and columns `c`
// are query and key indices, or key and query indices when `keys_rows`.
// Writes P and dS (dS with the softcap's derivative, without the scale)
// into W_p and W_ds at the thread's entries.
template <int D, int BM, int RPT, bool keys_rows>
__device__ __forceinline__ void probs_and_dscores(
    const Params& p, const float* sA, const float* sB, const float* sGA,
    const float* sGB, const float* s_lse, const float* s_delta, int r0,
    int c0, int row0, int lane, float* W_p, float* W_ds) {
  constexpr int WSTR = BM + 1;
  float s[RPT][RPT], dp[RPT][RPT];
  // S: rows of sA against rows of sB; dP: rows of sGA against rows of sGB
  dot_tile<D, RPT, RPT>(s, sA, row0, sB, lane);
  dot_tile<D, RPT, RPT>(dp, sGA, row0, sGB, lane);
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int ri = row0 + i, cj = lane + 16 * j;
      const int qi = keys_rows ? c0 + cj : r0 + ri;
      const int kj = keys_rows ? r0 + ri : c0 + cj;
      const int qloc = keys_rows ? cj : ri;
      float t = 0.f;
      const float x = score(p, s[i][j], &t);
      float pr = 0.f, ds = 0.f;
      if (visible(p, qi, kj)) {
        pr = expf(x - s_lse[qloc]);
        ds = pr * (dp[i][j] - s_delta[qloc]);
        if (p.softcap > 0.f) ds *= 1.f - t * t;
      }
      if (W_p != nullptr) W_p[ri * WSTR + cj] = pr;
      W_ds[ri * WSTR + cj] = ds;
    }
}

// ---------------------------------------------------------------- (b) dK dV
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dkdv(const Params p) {
  constexpr int BM = rows<D>();
  constexpr int RPT = BM / 16;
  constexpr int STR = tstride<D>();
  constexpr int WSTR = BM + 1;
  extern __shared__ float smem[];
  float* sK = smem;                     // BM x STR each
  float* sV = sK + BM * STR;
  float* sQ = sV + BM * STR;
  float* sG = sQ + BM * STR;            // dO
  float* sP = sG + BM * STR;            // P^T, BM x WSTR
  float* sS = sP + BM * WSTR;           // dS^T, BM x WSTR
  float* s_lse = sS + BM * WSTR;        // BM
  float* s_delta = s_lse + BM;          // BM

  const int lane = threadIdx.x & 15;
  const int row0 = (threadIdx.x >> 4) * RPT;
  const int k0 = blockIdx.x * BM;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile<T, D, BM>(sK, K, p.k_ss, k0, p.Sk);
  load_tile<T, D, BM>(sV, V, p.v_ss, k0, p.Sk);

  float dk[RPT][D / 16], dv[RPT][D / 16];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;

  int q_begin, q_end;
  query_range(p, k0, BM, BM, &q_begin, &q_end);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long base = ((long long)b * p.H + h) * p.Sq;
    for (int qt = q_begin; qt < q_end; qt += BM) {
      __syncthreads();                  // the previous tiles are consumed
      load_tile<T, D, BM>(sQ, Q, p.q_ss, qt, p.Sq);
      load_tile<T, D, BM>(sG, dO, p.do_ss, qt, p.Sq);
      for (int i = threadIdx.x; i < BM; i += NT) {
        const bool in = qt + i < p.Sq;
        s_lse[i] = in ? p.lse[base + qt + i] : inf();
        s_delta[i] = in ? p.delta[base + qt + i] : 0.f;
      }
      __syncthreads();
      // rows: this block's keys; columns: the tile's queries
      probs_and_dscores<D, BM, RPT, true>(p, sK, sQ, sV, sG, s_lse, s_delta,
                                          k0, qt, row0, lane, sP, sS);
      __syncthreads();
      accumulate<D, BM, RPT>(dv, sP, row0, sG, lane);
      accumulate<D, BM, RPT>(dk, sS, row0, sQ, lane);
    }
  }

  T* dK = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  T* dV = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kj = k0 + row0 + i;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dK[(long long)kj * p.dk_ss + lane + 16 * c] =
          from_f32<T>(dk[i][c] * p.scale);
      dV[(long long)kj * p.dv_ss + lane + 16 * c] = from_f32<T>(dv[i][c]);
    }
  }
}

// ---------------------------------------------------------------- (c) dQ
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dq(const Params p) {
  constexpr int BM = rows<D>();
  constexpr int RPT = BM / 16;
  constexpr int STR = tstride<D>();
  constexpr int WSTR = BM + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                     // BM x STR each
  float* sG = sQ + BM * STR;            // dO
  float* sK = sG + BM * STR;
  float* sV = sK + BM * STR;
  float* sS = sV + BM * STR;            // dS, BM x WSTR
  float* s_lse = sS + BM * WSTR;        // BM
  float* s_delta = s_lse + BM;          // BM

  const int lane = threadIdx.x & 15;
  const int row0 = (threadIdx.x >> 4) * RPT;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const long long base = ((long long)b * p.H + h) * p.Sq;

  load_tile<T, D, BM>(sQ, Q, p.q_ss, q0, p.Sq);
  load_tile<T, D, BM>(sG, dO, p.do_ss, q0, p.Sq);
  for (int i = threadIdx.x; i < BM; i += NT) {
    const bool in = q0 + i < p.Sq;
    s_lse[i] = in ? p.lse[base + q0 + i] : inf();
    s_delta[i] = in ? p.delta[base + q0 + i] : 0.f;
  }
  float dq[RPT][D / 16];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq[i][c] = 0.f;

  int k_begin, k_end;
  key_range(p, q0, BM, BM, &k_begin, &k_end);
  for (int kt = k_begin; kt < k_end; kt += BM) {
    __syncthreads();                    // the previous tiles are consumed
    load_tile<T, D, BM>(sK, K, p.k_ss, kt, p.Sk);
    load_tile<T, D, BM>(sV, V, p.v_ss, kt, p.Sk);
    __syncthreads();
    // rows: this block's queries; columns: the tile's keys
    probs_and_dscores<D, BM, RPT, false>(p, sQ, sK, sG, sV, s_lse, s_delta,
                                         q0, kt, row0, lane, nullptr, sS);
    __syncthreads();
    accumulate<D, BM, RPT>(dq, sS, row0, sK, lane);
  }

  T* dQ = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      dQ[(long long)qi * p.dq_ss + lane + 16 * c] =
          from_f32<T>(dq[i][c] * p.scale);
  }
}

template <int D> constexpr size_t smem_prep() {
  return sizeof(float) * 2 * rows<D>() * tstride<D>();
}
template <int D> constexpr size_t smem_dkdv() {
  return sizeof(float) * (4 * rows<D>() * tstride<D>() +
                          2 * rows<D>() * (rows<D>() + 1) + 2 * rows<D>());
}
template <int D> constexpr size_t smem_dq() {
  return sizeof(float) * (4 * rows<D>() * tstride<D>() +
                          rows<D>() * (rows<D>() + 1) + 2 * rows<D>());
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

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BM = rows<D>();
  const int q_tiles = (p.Sq + BM - 1) / BM;
  const int k_tiles = (p.Sk + BM - 1) / BM;
  cudaError_t err = launch_one(bwd_prep<T, D>, dim3(q_tiles, p.H, p.B),
                               smem_prep<D>(), p, stream);
  if (err != cudaSuccess) return err;
  if (k_tiles > 0) {
    err = launch_one(bwd_dkdv<T, D>, dim3(k_tiles, p.KV, p.B),
                     smem_dkdv<D>(), p, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_one(bwd_dq<T, D>, dim3(q_tiles, p.H, p.B), smem_dq<D>(), p,
                    stream);
}

template <typename T>
cudaError_t dispatch(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 96: return launch<T, 96>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 192: return launch<T, 192>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk, dv alike.
// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, KV, D); lse and delta:
// float32 (B, H, Sq) scratch, written by the first kernel. Strides are in
// elements; the head dim must be contiguous. Every element of dk and dv is
// written (zero where no query sees the key) when Sq > 0. Returns the
// cudaError_t of the launches.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse,
    float* delta, int dtype, int B, int H, int KV, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, int window, int q_offset, float softcap,
    void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,     k,     v,     o,     dout,  dq,    dk,    dv,
                 lse,   delta, B,     H,     KV,    Sq,    Sk,    q_sb,
                 q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,  v_sh,
                 o_sb,  o_ss,  o_sh,  do_sb, do_ss, do_sh, dq_sb, dq_ss,
                 dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, scale,
                 softcap, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(D, p, s));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(D, p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
