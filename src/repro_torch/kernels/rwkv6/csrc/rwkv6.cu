// RWKV6 (Finch) chunked recurrence for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/rwkv6/kernel.py
// (`_rwkv6_kernel`, launched by `rwkv6_kernel`) and the transposes, padding
// and slicing of its wrapper ops.py (`rwkv6`). It computes the function of
// the reference model's `_wkv_chunked` (src/repro/models/rwkv.py), which the
// TPU kernel computes from a zero state without returning one:
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// with a float32 state S0 in and (y, S_last) out, all in float32. Per chunk
// of C tokens, with cum the cumulative log-decay and cum_ex = cum shifted by
// one token:
//   y   = (r e^{cum_ex}) S + A v,
//   A   = strictly lower part of (r e^{cum_ex - m}) (k e^{m - cum})^T,
//         plus (r . u . k) on the diagonal (the bonus term),
//   S  <- e^{cum[-1]} S + (k e^{cum[-1] - cum})^T v.
//
// Range. m is half the chunk's summed log-decay, tot, per channel: exact
// algebra that halves the exponents of the two factors, so no factor
// exceeds e^{|tot|/2}. The factorised form therefore holds while every
// channel's tot stays above about -176 (float32 e^x overflows at x = 88.7),
// i.e. a geometric-mean decay above e^{-176/64} = 0.064 over a 64-token
// chunk; a smaller chunk widens it. The TPU kernel and the reference, with
// no m, hold to -88. At random init (w = exp(-exp(-6 + ...)) ~ 0.9975) tot is
// about -0.16. Outside the range the result overflows to inf or NaN; nothing
// is clamped.
//
// Translation. The TPU kernel runs a grid (B, H, S/C) whose last axis is
// sequential and carries the hd x hd state in VMEM scratch. GPU blocks run
// in no order, so here one thread block owns one (batch, head) pair and
// loops over the chunks in order, keeping the state in shared memory for
// the whole sequence. It reads the model layout (B, S, H, hd) through
// strides and masks the ragged tail per element as if w = 1 and k = 0
// there, so it needs none of the wrapper's copies.
//
// Bound on the H100. At the rwkv6-7b prefill shape (B=8, S=1024, H=64,
// hd=64; r, k, v bf16, w and the states float32, y float32) one launch moves
// 464 MiB (0.145 ms at 3.35 TB/s) and does four 64^3 products per (b, h,
// chunk), 17.2 GFLOP (0.017 ms at the 989 TFLOP/s bf16 tensor-core rate,
// 0.26 ms at the 67 TFLOP/s float32 rate without tensor cores): bound by
// bytes. This first design is simple: every product runs as float32 FMAs
// from shared memory (a 16 x 16 thread grid, each thread a 4 x 4 or
// 4 x hd/16 register tile), one block of 256 threads per SM for want of
// shared memory (~134 KB at hd = 64), and the per-channel prefix sum is
// serial. Shared-memory bandwidth and the barriers should limit it, well
// above the bound (PERF.md has its measured time); tensor cores, a
// parallel scan and overlapped loads are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 64;           // rows of a chunk tile (the largest chunk)
constexpr int NT = 256;         // threads: a 16 x 16 grid
constexpr int CS = C + 1;       // padded row stride of the A tile

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;               // (H, D), contiguous
  const float* state0;          // (B, H, D, D), contiguous, or null: zeros
  float* y;
  float* s_last;                // (B, H, D, D), contiguous
  int B, S, H, chunk;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Six C x (D+1) tiles, the A tile, the state and four small vectors.
template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * (6 * size_t(C) * (D + 1) + size_t(C) * CS +
                          size_t(D) * (D + 1) + 3 * size_t(D) + C);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) wkv6_kernel(const Params p) {
  constexpr int LD = D + 1;     // odd row stride: column reads hit 16 banks
  constexpr int RI = C / 16;    // rows of a chunk tile per thread
  constexpr int DJ = D / 16;    // head-dim columns per thread
  extern __shared__ float smem[];
  float* sR = smem;             // r, then r e^{cum_ex}
  float* sRn = sR + C * LD;     // r e^{cum_ex - m}
  float* sK = sRn + C * LD;     // k, then k e^{m - cum}
  float* sKt = sK + C * LD;     // k e^{tot - cum}
  float* sV = sKt + C * LD;     // v
  float* sW = sV + C * LD;      // log w, then cum
  float* sA = sW + C * LD;      // C x CS
  float* sS = sA + C * CS;      // state, D x LD
  float* sU = sS + D * LD;      // u
  float* sM = sU + D;           // m = tot / 2
  float* sDec = sM + D;         // e^{tot}
  float* sDiag = sDec + D;      // r . u . k per row

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const T* R = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* W = p.w + b * p.w_sb + h * p.w_sh;
  float* Y = p.y + b * p.y_sb + h * p.y_sh;
  const long long s_base = ((long long)b * p.H + h) * D * D;

  for (int i = tid; i < D; i += NT) sU[i] = p.u[h * D + i];
  for (int i = tid; i < D * D; i += NT)
    sS[(i / D) * LD + i % D] = p.state0 ? p.state0[s_base + i] : 0.f;

  for (int t0 = 0; t0 < p.S; t0 += p.chunk) {
    const int n = min(p.chunk, p.S - t0);   // real rows of this chunk
    __syncthreads();  // the previous chunk's tiles and state are done

    // Tiles in float32; rows at or past n read as r = k = v = 0, w = 1.
    for (int i = tid; i < C * D; i += NT) {
      const int t = i / D, d = i % D;
      float rx = 0.f, kx = 0.f, vx = 0.f, lw = 0.f;
      if (t < n) {
        const long long tt = t0 + t;
        rx = to_f32(R[tt * p.r_ss + d]);
        kx = to_f32(K[tt * p.k_ss + d]);
        vx = to_f32(V[tt * p.v_ss + d]);
        lw = logf(W[tt * p.w_ss + d]);
      }
      sR[t * LD + d] = rx;
      sK[t * LD + d] = kx;
      sV[t * LD + d] = vx;
      sW[t * LD + d] = lw;
    }
    __syncthreads();

    // Cumulative log-decay, one thread per channel; the bonus r . u . k,
    // one thread per row.
    if (tid < D) {
      float c = 0.f;
      for (int t = 0; t < n; ++t) {
        c += sW[t * LD + tid];
        sW[t * LD + tid] = c;
      }
      sM[tid] = 0.5f * c;
      sDec[tid] = expf(c);
    } else if (tid >= 64 && tid < 64 + n) {
      const int t = tid - 64;
      float s = 0.f;
      for (int d = 0; d < D; ++d)
        s = fmaf(sR[t * LD + d] * sU[d], sK[t * LD + d], s);
      sDiag[t] = s;
    }
    __syncthreads();

    // The decay factors; each element is read and written by one thread.
    for (int i = tid; i < C * D; i += NT) {
      const int t = i / D, d = i % D;
      float ri = 0.f, rn = 0.f, kn = 0.f, kt = 0.f;
      if (t < n) {
        const float c = sW[t * LD + d];
        const float ce = t > 0 ? sW[(t - 1) * LD + d] : 0.f;
        const float m = sM[d];
        const float rx = sR[t * LD + d], kx = sK[t * LD + d];
        ri = rx * expf(ce);
        rn = rx * expf(ce - m);
        kn = kx * expf(m - c);
        kt = kx * expf(2.f * m - c);
      }
      sR[t * LD + d] = ri;
      sRn[t * LD + d] = rn;
      sK[t * LD + d] = kn;
      sKt[t * LD + d] = kt;
    }
    __syncthreads();

    // A[t][s], t = ty + 16 i, s = tx + 16 j.
    {
      float acc[RI][RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[RI], bk[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = sRn[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < RI; ++j) bk[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RI; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int s = tx + 16 * j;
          float x = 0.f;
          if (t < n) x = s < t ? acc[i][j] : (s == t ? sDiag[t] : 0.f);
          sA[t * CS + s] = x;
        }
      }
    }
    __syncthreads();

    // y[t][e] = sum_d r_inter[t][d] S[d][e] + sum_s A[t][s] v[s][e],
    // t = ty + 16 i, e = tx + 16 j.
    {
      float acc[RI][DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[RI], sv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = sR[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < DJ; ++j) sv[j] = sS[d * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(a[i], sv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        float a[RI], vv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = sA[(ty + 16 * i) * CS + s];
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[j] = sV[s * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(a[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int t = ty + 16 * i;
        if (t >= n) continue;
        float* out = Y + (long long)(t0 + t) * p.y_ss;
#pragma unroll
        for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = acc[i][j];
      }
    }
    __syncthreads();  // every y has read the state

    // S[d][e] = e^{tot[d]} S[d][e] + sum_s k_tail[s][d] v[s][e],
    // d = ty + 16 i, e = tx + 16 j; each thread updates only its own.
    {
      float acc[DJ][DJ];
#pragma unroll
      for (int i = 0; i < DJ; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = ty + 16 * i;
          acc[i][j] = sDec[d] * sS[d * LD + tx + 16 * j];
        }
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        float a[DJ], vv[DJ];
#pragma unroll
        for (int i = 0; i < DJ; ++i) a[i] = sKt[s * LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[j] = sV[s * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < DJ; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(a[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < DJ; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          sS[(ty + 16 * i) * LD + tx + 16 * j] = acc[i][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < D * D; i += NT)
    p.s_last[s_base + i] = sS[(i / D) * LD + i % D];
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  wkv6_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v: 0 = float32, 1 = bfloat16; w, u, the states and y are
// float32. Strides are in elements; the head dim must be contiguous, u and
// the states contiguous. state0 may be null (zeros); 1 <= chunk <= 64.
// Returns the cudaError_t of the launch.
extern "C" int repro_wkv6_fwd(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* state0, float* y, float* s_last, int dtype,
    int B, int S, int H, int D, int chunk, long long r_sb, long long r_ss,
    long long r_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long w_sb,
    long long w_ss, long long w_sh, long long y_sb, long long y_ss,
    long long y_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk < 1 || chunk > C)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{r,    k,    v,    w,    u,    state0, y,    s_last,
                 B,    S,    H,    chunk, r_sb, r_ss,  r_sh, k_sb,
                 k_ss, k_sh, v_sb, v_ss, v_sh, w_sb,   w_ss, w_sh,
                 y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(D, p, s));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(D, p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
