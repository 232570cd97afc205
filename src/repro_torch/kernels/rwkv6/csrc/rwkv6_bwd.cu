// RWKV6 (Finch) chunked recurrence, backward, for NVIDIA Hopper (sm_90a),
// CUDA C++.
//
// The gradient of the forward kernels in this folder (rwkv6_mma.cu and
// rwkv6.cu, which replace the Pallas TPU kernel `_rwkv6_kernel` in
// src/repro/kernels/rwkv6/kernel.py). The reference has no backward kernel:
// it trains through the model's `_wkv_chunked` (src/repro/models/rwkv.py),
// which JAX differentiates. This kernel computes that gradient, the function
// of the plain version `wkv_bwd_ref` (../ref.py): from (r, k, v, w, u,
// state0) and the cotangents dy of y and dS_last of the last state, it
// gives (dr, dk, dv, dw, du, dstate0).
//
// Per chunk of C tokens, with cum the cumulative log-decay, cum_ex the same
// one token later, tot = cum[C-1] and m = tot / 2 (per channel), r~ = r
// e^{cum_ex - m}, k~ = k e^{m - cum}, A = strictly lower (r~ k~^T), k_tail
// = k e^{tot - cum} and dS the cotangent of the state leaving the chunk:
//   dA    = strictly lower (dy v^T) = dA2 + b, b_t = dA[t][t-1] (the band)
//   dr    = (dA2 k~) e^{cum_ex - m} + b_t k_{t-1} + (dy S_in^T) e^{cum_ex}
//           + delta u k
//   dk    = (dA2^T r~) e^{m - cum} + b_{s+1} r_{s+1} + (v dS^T) e^{tot - cum}
//           + delta u r
//   dv    = A^T dy + (r u k)_t dy_t + k_tail dS
//   du   += sum_t delta_t r_t k_t,            delta_t = dy_t . v_t
//   dS_in = (r e^{cum_ex})^T dy + e^{tot} dS
// (the band's pairwise decay is exactly 1), and for the log-decay
//   dlog w_j = sum_{t > j} [(dA2 k~)_t r~_t + (dy S_in^T)_t r_t e^{cum_ex_t}]
//            - sum_{t >= j} (dA2^T r~)_t k~_t
//            + sum_{s < j} (v dS^T)_s k_tail_s + e^{tot} sum_e S_in dS,
//   dw = dlog w / w.
// The band's pairs and the tail's terms at j <= s enter the cum, cum_ex and
// tot terms with opposite signs and cancel exactly: they are left out, not
// summed and cancelled in float32, where under strong decay they are the
// largest terms and their rounding dominated dw (the first card run held
// dw at chunk 16 and |tot| = 150 to 3.06 x the gate below, with the plain
// version as far from a float64 evaluation; without them, 7e-6 of max
// |dw| on the CPU).
//
// Range. The factors e^{+-(cum - m)} reach e^{|tot|/2}, and dA k~ and
// dA^T r~ add 64 such terms times |dA| (itself a sum of hd products dy v),
// so float32 holds while each channel's summed log-decay over a chunk (tot)
// stays above about -150: e^75 = 3.7e32 leaves a factor of 9e5 for 64 |dA|
// |k| below float32's largest 3.4e38. The forward kernels hold to -176
// (fma) and -174.7 (mma); the backward's range is the narrower one for
// training. At random init tot is about -0.16. Nothing is clamped: outside
// the range the result overflows to inf or NaN.
//
// Design. One block of 256 threads per (batch, head), in two phases: it
// first walks the chunks forward, writing each chunk's start state into a
// float32 workspace (B, H, n_chunks, hd, hd) (32 MiB at the rwkv6-7b
// training shape), then walks them in reverse, holding dS in shared memory
// and reading each start state back (the same block wrote it, mostly still
// in L2). Every tile is 64 x 64, zero-padded where the chunk or the head
// dim is smaller, with a row stride of 65 floats, so a 16 x 16 thread grid
// (each thread a 4 x 4 register tile, rows ti + 16a, columns tj + 16c)
// reads any tile by row or by column without bank conflicts. The ten 64^3
// products of a chunk (the forward's state update, A, dA, and the seven
// above) are float32 FMAs from shared memory; prefix sums over a chunk are
// serial per channel. No atomics: each block writes its own outputs, du as
// a per-(b, h) partial that the wrapper sums over B, so repeated calls give
// the same bits.
//
// Bound on the H100. At the rwkv6-7b training shape (B=1, S=2048, H=64,
// hd=64; r, k, v and their gradients bf16, w, dy, dw float32) the function
// moves r, k, v, w, dy in and dr, dk, dv, dw out, 100.7 MB (0.030 ms at
// 3.35 TB/s; 0.050 ms with the 33.6 MB workspace written and read), and the
// chunked form's backward needs eight products per (b, h, chunk), 8.6 GFLOP
// (0.009 ms on bf16 tensor cores, 0.13 ms at the 67 TFLOP/s float32 FMA
// rate); this kernel does ten, 10.7 GFLOP. 64 blocks fill 64 of the 132
// SMs, and each inner step reads 8 floats from shared memory for 16 FMAs:
// shared-memory bandwidth and the barriers limit it, far above the bound
// (PERF.md has its time). Tensor cores, TMA loads and splitting dS's value
// columns across blocks are the next steps.
//
// Tolerance (chip_smoke.py's gate, written before the kernel first ran).
// The kernel and the plain version compute the same float32 sums in other
// orders (64-term products, serial against tree prefix sums, a chain of
// chunks through dS) from the same inputs. Two errors dominate. The sums
// themselves: on the CPU the plain version in float32 lies within 6e-7 of
// each gradient's largest magnitude from the exact recurrence differentiated
// in float64, at decays of the model's and the reference test's (|tot| <=
// 20). And the exponents: cum is a float32 sum of up to 64 log-decays, off
// by about 2^-24 sqrt(64) |tot| = 5e-7 |tot|, and each factor e^{+-(cum -
// m)} carries that as a relative error (the same comparison at |tot| = 150
// gave 1.5e-5 for dw). Two float32 orders differ by up to twice either, so
// the gate is 2e-5 x max(1, |tot|_max / 20) x max(1, max |plain|) for every
// gradient (the max over the run's channels and chunks). dr, dk and dv in
// bf16 are also rounded once to bf16 (half a step of an 8-bit significand,
// up to 2^-8 of the value): their gate adds 2^-7 x max |plain|. A g++
// emulation of this source (threads as std::thread, a barrier for
// __syncthreads) met these gates on every case chip_smoke.py runs, before
// the first card run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int T = 64;            // tile rows and columns (chunk, head dim)
constexpr int LD = T + 1;        // padded row stride
constexpr int TILE = T * LD;
constexpr int NT = 256;          // threads: a 16 x 16 grid
constexpr int N_TILES = 12;
constexpr int N_VECS = 6;
constexpr size_t SMEM = (N_TILES * TILE + N_VECS * T) * sizeof(float);

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;               // (H, D), contiguous
  const float* state0;          // (B, H, D, D), contiguous, or null: zeros
  const float* dy;
  const float* ds_last;         // (B, H, D, D), contiguous
  void* dr;                     // r's dtype, the output strides
  void* dk;
  void* dv;
  float* dw;
  float* du;                    // (B, H, D) partials, contiguous
  float* dstate0;               // (B, H, D, D), contiguous
  float* work;                  // (B, H, n_chunks, D, D)
  int B, S, H, D, chunk;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long g_sb, g_ss, g_sh;   // dy
  long long o_sb, o_ss, o_sh;   // dr, dk, dv, dw
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// dst[t][d] = src row t0 + t, channel d (zero outside rows x D); with
// `log_decay`, log of it (0 outside: the padding's decay is 1).
template <typename In>
__device__ void load_tile(float* dst, const In* src, long long sb,
                          long long ss, long long sh, int b, int h, int t0,
                          int rows, int D, bool log_decay) {
  const In* base = src + b * sb + h * sh + t0 * ss;
  for (int i = threadIdx.x; i < T * T; i += NT) {
    const int t = i / T, d = i % T;
    float x = 0.f;
    if (t < rows && d < D) {
      x = to_f32(base[t * ss + d]);
      if (log_decay) x = logf(x);
    }
    dst[t * LD + d] = x;
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
}

// acc[a][c] += sum_k X(ti + 16a, k) Y(k, tj + 16c) over 64 k, where
// X(i, k) is X[i][k] (or X[k][i] when XT) and Y(k, j) is Y[k][j] (or Y[j][k]
// when YT), all tiles of row stride LD in shared memory.
template <bool XT, bool YT>
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* X,
                                   const float* Y, int ti, int tj) {
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = XT ? X[k * LD + ti + 16 * a] : X[(ti + 16 * a) * LD + k];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = YT ? Y[(tj + 16 * c) * LD + k] : Y[k * LD + tj + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
  }
}

// In place: each channel's inclusive prefix sum over the 64 rows; tot[d]
// the last row. Threads 0..63, one channel each.
__device__ __forceinline__ void scan_rows(float* cum, float* tot) {
  const int d = threadIdx.x;
  float run = 0.f;
  for (int t = 0; t < T; ++t) {
    run += cum[t * LD + d];
    cum[t * LD + d] = run;
  }
  tot[d] = run;
}

__device__ __forceinline__ float cum_ex_at(const float* cum, int t, int d) {
  return t > 0 ? cum[(t - 1) * LD + d] : 0.f;
}

template <typename In>
__global__ void __launch_bounds__(NT, 1) wkv6_bwd_kernel(const Params p) {
  extern __shared__ float sm[];
  float* r_ = sm;                // r, then r e^{cum_ex}
  float* k_ = r_ + TILE;
  float* v_ = k_ + TILE;
  float* dy_ = v_ + TILE;
  float* cum_ = dy_ + TILE;      // log w, then its prefix sums
  float* rt_ = cum_ + TILE;      // r~, then (v dS^T) k_tail's prefix sums
  float* kt_ = rt_ + TILE;       // k~ (k_tail in the forward and for dv)
  float* S_ = kt_ + TILE;        // the chunk's start state
  float* dS_ = S_ + TILE;        // the cotangent of the state it leaves
  float* A_ = dS_ + TILE;
  float* dA_ = A_ + TILE;
  float* D_ = dA_ + TILE;        // the cotangent of each cum
  float* tot = D_ + TILE;
  float* u_ = tot + T;
  float* delta = u_ + T;         // dy_t . v_t
  float* diag = delta + T;       // r_t . u . k_t
  float* du_ = diag + T;
  float* band = du_ + T;         // dA[t][t-1]

  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int D = p.D, chunk = p.chunk, n = (p.S + chunk - 1) / chunk;
  const In* r = static_cast<const In*>(p.r);
  const In* k = static_cast<const In*>(p.k);
  const In* v = static_cast<const In*>(p.v);
  In* dr = static_cast<In*>(p.dr);
  In* dk = static_cast<In*>(p.dk);
  In* dv = static_cast<In*>(p.dv);
  const long long sq = static_cast<long long>(bh) * D * D;
  float* work = p.work + static_cast<long long>(bh) * n * D * D;
  const long long o_base = b * p.o_sb + h * p.o_sh;
  const long long w_base = b * p.w_sb + h * p.w_sh;

  if (tid < T) {
    u_[tid] = tid < D ? p.u[h * D + tid] : 0.f;
    du_[tid] = 0.f;
  }
  for (int i = tid; i < T * T; i += NT) {
    const int d = i / T, e = i % T;
    const bool in = d < D && e < D;
    S_[d * LD + e] = in && p.state0 ? p.state0[sq + d * D + e] : 0.f;
    dS_[d * LD + e] = in ? p.ds_last[sq + d * D + e] : 0.f;
  }
  __syncthreads();

  float acc[4][4], acc2[4][4];
  // ---- 1. forward: each chunk's start state into the workspace
  for (int c = 0; c < n; ++c) {
    const int t0 = c * chunk, rows = min(chunk, p.S - t0);
    for (int i = tid; i < D * D; i += NT)
      work[static_cast<long long>(c) * D * D + i] = S_[(i / D) * LD + i % D];
    load_tile(k_, k, p.k_sb, p.k_ss, p.k_sh, b, h, t0, rows, D, false);
    load_tile(v_, v, p.v_sb, p.v_ss, p.v_sh, b, h, t0, rows, D, false);
    load_tile(cum_, p.w, p.w_sb, p.w_ss, p.w_sh, b, h, t0, rows, D, true);
    __syncthreads();
    if (tid < T) scan_rows(cum_, tot);
    __syncthreads();
    for (int i = tid; i < T * T; i += NT) {
      const int t = i / T, d = i % T;
      kt_[t * LD + d] = k_[t * LD + d] * expf(tot[d] - cum_[t * LD + d]);
    }
    __syncthreads();
    // S = e^{tot} S + k_tail^T v
    zero(acc);
    mm<true, false>(acc, kt_, v_, ti, tj);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = ti + 16 * a, j = tj + 16 * cc;
        S_[i * LD + j] = expf(tot[i]) * S_[i * LD + j] + acc[a][cc];
      }
    __syncthreads();
  }

  // ---- 2. backward: the chunks in reverse, carrying dS
  for (int c = n - 1; c >= 0; --c) {
    const int t0 = c * chunk, rows = min(chunk, p.S - t0);
    load_tile(r_, r, p.r_sb, p.r_ss, p.r_sh, b, h, t0, rows, D, false);
    load_tile(k_, k, p.k_sb, p.k_ss, p.k_sh, b, h, t0, rows, D, false);
    load_tile(v_, v, p.v_sb, p.v_ss, p.v_sh, b, h, t0, rows, D, false);
    load_tile(dy_, p.dy, p.g_sb, p.g_ss, p.g_sh, b, h, t0, rows, D, false);
    load_tile(cum_, p.w, p.w_sb, p.w_ss, p.w_sh, b, h, t0, rows, D, true);
    for (int i = tid; i < T * T; i += NT) {
      const int d = i / T, e = i % T;
      S_[d * LD + e] = d < D && e < D
          ? work[static_cast<long long>(c) * D * D + d * D + e] : 0.f;
    }
    __syncthreads();
    if (tid < T) {
      scan_rows(cum_, tot);
    } else if (tid < 2 * T) {
      const int t = tid - T;
      float dl = 0.f, dg = 0.f;
      for (int d = 0; d < T; ++d) {
        dl = fmaf(dy_[t * LD + d], v_[t * LD + d], dl);
        dg = fmaf(r_[t * LD + d] * u_[d], k_[t * LD + d], dg);
      }
      delta[t] = dl;
      diag[t] = dg;
    }
    __syncthreads();
    for (int i = tid; i < T * T; i += NT) {
      const int t = i / T, d = i % T;
      const float m = 0.5f * tot[d];
      rt_[t * LD + d] = r_[t * LD + d] * expf(cum_ex_at(cum_, t, d) - m);
      kt_[t * LD + d] = k_[t * LD + d] * expf(m - cum_[t * LD + d]);
    }
    if (tid < T) {
      float s = 0.f;
      for (int t = 0; t < T; ++t)
        s = fmaf(delta[t] * r_[t * LD + tid], k_[t * LD + tid], s);
      du_[tid] += s;
    }
    __syncthreads();

    // A = strictly lower (r~ k~^T); dy v^T as dA2 (below the band) and
    // the band
    zero(acc);
    mm<false, true>(acc, rt_, kt_, ti, tj);
    zero(acc2);
    mm<false, true>(acc2, dy_, v_, ti, tj);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = ti + 16 * a, j = tj + 16 * cc;
        A_[i * LD + j] = j < i ? acc[a][cc] : 0.f;
        dA_[i * LD + j] = j < i - 1 ? acc2[a][cc] : 0.f;
        if (j == i - 1) band[i] = acc2[a][cc];
        else if (i == 0 && j == 0) band[0] = 0.f;
      }
    __syncthreads();

    // G = dA2 k~ and Q = dy S_in^T: dr, and the cotangent of cum_ex
    zero(acc);
    mm<false, false>(acc, dA_, kt_, ti, tj);
    zero(acc2);
    mm<false, true>(acc2, dy_, S_, ti, tj);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int t = ti + 16 * a, d = tj + 16 * cc;
        const float ce = cum_ex_at(cum_, t, d);
        const float e_ex = expf(ce), e_m = expf(ce - 0.5f * tot[d]);
        const float rv = r_[t * LD + d], kv = k_[t * LD + d];
        const float bk = t > 0 ? band[t] * k_[(t - 1) * LD + d] : 0.f;
        if (t < rows && d < D)
          put(dr + o_base + (t0 + t) * p.o_ss + d,
              acc[a][cc] * e_m + bk + acc2[a][cc] * e_ex
                  + delta[t] * u_[d] * kv);
        const float dce = acc[a][cc] * rt_[t * LD + d]
            + acc2[a][cc] * rv * e_ex;
        if (t > 0) D_[(t - 1) * LD + d] = dce;
        else D_[(T - 1) * LD + d] = 0.f;
      }

    // H = dA2^T r~ and P = v dS^T: dk, and the cotangent of cum
    zero(acc);
    mm<true, false>(acc, dA_, rt_, ti, tj);
    zero(acc2);
    mm<false, true>(acc2, v_, dS_, ti, tj);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int s = ti + 16 * a, d = tj + 16 * cc;
        const float cs = cum_[s * LD + d];
        const float tail = expf(tot[d] - cs), e_m = expf(0.5f * tot[d] - cs);
        const float rv = r_[s * LD + d], kv = k_[s * LD + d];
        const float k_tail = kv * tail;
        const float br = s + 1 < T ? band[s + 1] * r_[(s + 1) * LD + d] : 0.f;
        if (s < rows && d < D)
          put(dk + o_base + (t0 + s) * p.o_ss + d,
              acc[a][cc] * e_m + br + acc2[a][cc] * tail
                  + delta[s] * u_[d] * rv);
        D_[s * LD + d] -= acc[a][cc] * kt_[s * LD + d];
        kt_[s * LD + d] = k_tail;
        rt_[s * LD + d] = acc2[a][cc] * k_tail;
      }
    __syncthreads();

    // r e^{cum_ex} for dS_in; the tail's exclusive prefix sums, then dw
    for (int i = tid; i < T * T; i += NT) {
      const int t = i / T, d = i % T;
      r_[t * LD + d] *= expf(cum_ex_at(cum_, t, d));
    }
    if (tid < T) {
      const int d = tid;
      float pre = 0.f, s2 = 0.f;
      for (int j = 0; j < T; ++j) {
        const float pk = rt_[j * LD + d];
        rt_[j * LD + d] = pre;
        pre += pk;
        s2 = fmaf(S_[d * LD + j], dS_[d * LD + j], s2);
      }
      D_[(T - 1) * LD + d] += expf(tot[d]) * s2;
      float run = 0.f;
      for (int j = T - 1; j >= 0; --j) {
        run += D_[j * LD + d];
        if (j < rows && d < D) {
          const long long off = (t0 + j) * p.w_ss + d;
          p.dw[o_base + (t0 + j) * p.o_ss + d] =
              (run + rt_[j * LD + d]) / p.w[w_base + off];
        }
      }
    }
    __syncthreads();

    // dv = A^T dy + k_tail dS + diag dy;
    // dS_in = (r e^{cum_ex})^T dy + e^tot dS
    zero(acc);
    mm<true, false>(acc, A_, dy_, ti, tj);
    mm<false, false>(acc, kt_, dS_, ti, tj);
    zero(acc2);
    mm<true, false>(acc2, r_, dy_, ti, tj);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = ti + 16 * a, j = tj + 16 * cc;
        if (i < rows && j < D)
          put(dv + o_base + (t0 + i) * p.o_ss + j,
              acc[a][cc] + diag[i] * dy_[i * LD + j]);
        dS_[i * LD + j] = acc2[a][cc] + expf(tot[i]) * dS_[i * LD + j];
      }
    __syncthreads();
  }

  for (int i = tid; i < D * D; i += NT)
    p.dstate0[sq + i] = dS_[(i / D) * LD + i % D];
  if (tid < D) p.du[static_cast<long long>(bh) * D + tid] = du_[tid];
}

template <typename In>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<In><<<p.B * p.H, NT, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype of r, k, v and of dr, dk, dv: 0 = float32, 1 = bfloat16; w, u, dy,
// the states and dw float32. Strides are in elements; every head dim must be
// contiguous, u, the states and du contiguous; state0 may be null (zeros).
// 1 <= D <= 64, 1 <= chunk <= 64. `work` holds B * H * ceil(S / chunk) * D
// * D floats. Returns the cudaError_t of the launch.
extern "C" int repro_wkv6_bwd(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* state0, const float* dy,
    const float* ds_last, void* dr, void* dk, void* dv, float* dw, float* du,
    float* dstate0, float* work, int dtype, int B, int S, int H, int D,
    int chunk, long long r_sb, long long r_ss, long long r_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long w_sb, long long w_ss, long long w_sh,
    long long g_sb, long long g_ss, long long g_sh, long long o_sb,
    long long o_ss, long long o_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > T || chunk < 1 ||
      chunk > T)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{r,    k,    v,    w,    u,    state0, dy,   ds_last,
                 dr,   dk,   dv,   dw,   du,   dstate0, work, B,
                 S,    H,    D,    chunk, r_sb, r_ss,  r_sh, k_sb,
                 k_ss, k_sh, v_sb, v_ss, v_sh, w_sb,   w_ss, w_sh,
                 g_sb, g_ss, g_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
