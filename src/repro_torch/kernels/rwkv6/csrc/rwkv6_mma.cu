// RWKV6 (Finch) chunked recurrence on Hopper's tensor cores (sm_90a),
// CUDA C++: bf16 r, k, v at head dim 64.
//
// Replaces, like rwkv6.cu, the Pallas TPU kernel in
// src/repro/kernels/rwkv6/kernel.py (`_rwkv6_kernel`, launched by
// `rwkv6_kernel`), and computes the same function as rwkv6.cu's
// `repro_wkv6_fwd` (the plain version is `wkv_ref` in ../ref.py):
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// with a float32 state S0 in (or zeros) and (y, S_last) out in float32,
// any S (a ragged tail, and every chunk shorter than 64, is masked as
// w = 1, k = 0), the model layout (B, S, H, hd) read through strides.
// rwkv6.cu keeps float32 r, k, v and head dims 16 and 32.
//
// Per chunk of C tokens, with cum the cumulative log-decay, cum_ex = cum
// shifted by one token, m = tot / 2 (tot = cum at the chunk's end) and
// e^m applied per channel d:
//   Rn = r e^{cum_ex - m},  Kn = k e^{m - cum}          (two exponentials)
//   y  = Rn (diag(e^m) S) + A v,
//   A  = strictly lower part of Rn Kn^T, plus r . u . k on the diagonal,
//   S <- diag(e^m) (diag(e^m) S + Kn^T v).
// This is rwkv6.cu's algebra with r e^{cum_ex} = Rn diag(e^m) and
// k e^{tot - cum} = Kn diag(e^m) folded into the state, so the tile
// r e^{cum_ex} is never stored and each element takes two exponentials,
// not four. Range: no factor exceeds e^{|tot|/2}, and e^m must stay a
// normal float, so the result holds while every channel's tot stays above
// 2 ln(FLT_MIN) = -174.7 (rwkv6.cu: -176); at random init tot is about
// -0.16. The exponentials are exp2f of log2-scaled values (log2f of w, a
// prefix sum in log2 units): CUDA's exp2f is within 2 ulp and log2f
// within 1 ulp, and an error e in an argument costs e ln 2 of relative
// error in the factor, ~1e-7 here against the 2e-5 gate.
//
// Bound on the H100. At the rwkv6-7b prefill shape (B=8, S=1024, H=64,
// hd=64) one launch moves 464 MiB: 0.145 ms at 3.35 TB/s. The four 64^3
// products per (b, h, chunk) are 17.2 GFLOP; with the 3xTF32 split below
// they are 2.5x that on the tensor cores (42.9 GFLOP, 0.087 ms at the 495
// TFLOP/s TF32 rate) before the upper triangle of A is skipped. So bytes
// bound it.
//
// Design.
// - One block of 256 threads (8 warps) per (batch, head) walks the chunks
//   in order with the 64 x 64 float32 state in shared memory, as in
//   rwkv6.cu: the state never goes back to device memory between chunks.
// - Two blocks per SM: 106.75 KB of shared memory (raw bf16 r and k
//   tiles, two v buffers, w as float32 then its prefix sum in place, Rn,
//   Kn, the state, small vectors) and at most 128 registers a thread
//   (__launch_bounds__(256, 2)), so 264 blocks run at once and one
//   block's barriers and serial phases overlap the other's products.
// - Loads: 16-byte cp.async from global to shared memory; rows at or past
//   the chunk's end are zero-filled (r = k = v = 0, and w = 0 is read as
//   log w = 0). The next chunk's r, k and w load as soon as the factors
//   are formed, its v into the second buffer, while this chunk's
//   products run (about 5% faster than loading at the chunk's start,
//   timed in turns on the card; PERF.md).
// - Log-decay prefix sum in parallel: each warp sums 16 tokens of 32
//   channels (one channel a lane), and the four segments' totals are
//   combined when the factors are formed.
// - Every product is mma.sync m16n8k8 TF32 with a float32 accumulator, in
//   3xTF32: an operand that TF32 does not hold exactly is split as
//   hi + lo at fragment load, and hi.hi + hi.lo + lo.hi is summed. One
//   TF32 pass per product misses the 2e-5 gate by 10-20x; bf16 r, k, v are
//   exact in TF32, so a product with v needs two passes. Warp w owns the
//   16-row strip w / 2 of y, A and the state update and half w % 2 of
//   their columns (of A: every other 8-column tile at or left of the
//   diagonal; tiles right of it are skipped, and so are A v's matching
//   k-steps). A leaves the accumulators through shared memory, written
//   over the warp pair's own rows of Rn once both warps have read them
//   (a 64-thread named barrier), because the accumulator's layout is not
//   the A operand's.
// - Six barriers a chunk: four block-wide, two of a warp pair.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rwkv6_ptx.cuh"

namespace {

constexpr int C = 64;           // rows of a chunk tile (the largest chunk)
constexpr int D = 64;           // head dim
constexpr int NT = 256;         // 8 warps
constexpr int LDB = D + 8;      // bf16 tiles: 144-byte rows
constexpr int LDF = D + 4;      // float32 w, Rn, Kn: 272-byte rows
constexpr int LDS = D + 8;      // the state: 288-byte rows

// bytes: r, k, two v buffers (bf16), w, Rn, Kn, the state, then u, the
// four segment totals, e^m and the bonus term per row (float32)
constexpr size_t kSmemBytes = 4 * sizeof(__nv_bfloat16) * C * LDB +
                              sizeof(float) * (3 * C * LDF + D * LDS + 7 * D);

struct Params {
  const __nv_bfloat16* r;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
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

// bf16 as the bits of the float32 (and TF32) of the same value
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

// The chunk's rows [t0, t0 + n) into the tiles; rows at or past n are
// zero-filled (their source is the chunk's first row, not read).
__device__ __forceinline__ void load_chunk(
    const Params& p, const __nv_bfloat16* R, const __nv_bfloat16* K,
    const __nv_bfloat16* V, const float* W, __nv_bfloat16* sR,
    __nv_bfloat16* sK, __nv_bfloat16* sV, float* sW, int t0, int n,
    int tid) {
  for (int i = tid; i < C * (D / 8); i += NT) {
    const int t = i / (D / 8), c = (i % (D / 8)) * 8;
    const uint32_t bytes = t < n ? 16 : 0;
    const long long tt = t < n ? t0 + t : t0;
    wkv::cp_async16(sR + t * LDB + c, R + tt * p.r_ss + c, bytes);
    wkv::cp_async16(sK + t * LDB + c, K + tt * p.k_ss + c, bytes);
    wkv::cp_async16(sV + t * LDB + c, V + tt * p.v_ss + c, bytes);
  }
  for (int i = tid; i < C * (D / 4); i += NT) {
    const int t = i / (D / 4), c = (i % (D / 4)) * 4;
    const long long tt = t < n ? t0 + t : t0;
    wkv::cp_async16(sW + t * LDF + c, W + tt * p.w_ss + c, t < n ? 16 : 0);
  }
}

// A[t][s] of the chunk: the product below the diagonal, the bonus term on
// it, 0 above.
__device__ __forceinline__ float mask_a(int t, int s, float x,
                                        const float* sDiag) {
  return s < t ? x : (s == t ? sDiag[t] : 0.f);
}

__global__ void __launch_bounds__(NT, 2) wkv6_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sR = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sR + C * LDB;
  __nv_bfloat16* sV2 = sK + C * LDB;  // v, two buffers
  float* sW = reinterpret_cast<float*>(sV2 + 2 * C * LDB);  // w, then cum
  float* sRn = sW + C * LDF;    // Rn, then A over each strip's own rows
  float* sKn = sRn + C * LDF;
  float* sS = sKn + C * LDF;    // the state, D x LDS
  float* sU = sS + D * LDS;
  float* sSeg = sU + D;         // 4 x D: each 16-token segment's sum
  float* sEm = sSeg + 4 * D;    // e^m
  float* sDiag = sEm + D;       // r . u . k per row

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;     // fragment row and column
  const int strip = warp >> 1, half = warp & 1;
  const int r0 = 16 * strip;                  // this warp's rows
  const int e0 = 32 * half;                   // and columns
  const int h = blockIdx.x, b = blockIdx.y;
  const __nv_bfloat16* R = p.r + b * p.r_sb + h * p.r_sh;
  const __nv_bfloat16* K = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* V = p.v + b * p.v_sb + h * p.v_sh;
  const float* W = p.w + b * p.w_sb + h * p.w_sh;
  float* Y = p.y + b * p.y_sb + h * p.y_sh;
  const long long s_base = ((long long)b * p.H + h) * D * D;

  for (int i = tid; i < D; i += NT) sU[i] = p.u[h * D + i];
  for (int i = tid; i < D * D; i += NT)
    sS[(i / D) * LDS + i % D] = p.state0 ? p.state0[s_base + i] : 0.f;

  load_chunk(p, R, K, V, W, sR, sK, sV2, sW, 0, min(p.chunk, p.S), tid);
  for (int t0 = 0, it = 0; t0 < p.S; t0 += p.chunk, ++it) {
    const int n = min(p.chunk, p.S - t0);     // real rows of this chunk
    const __nv_bfloat16* sV = sV2 + (it & 1) * C * LDB;
    wkv::cp_async_wait_all();
    __syncthreads();  // the tiles, and the last chunk's state update

    // Prefix sums of log2 w: warp w sums tokens 16 (w / 2) .. + 15 of
    // channel 32 (w % 2) + lane, in place; masked rows add 0.
    {
      const int d = e0 + lane;
      float c = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int t = r0 + j;
        float* cell = sW + t * LDF + d;
        c += t < n ? log2f(*cell) : 0.f;
        *cell = c;
      }
      sSeg[strip * D + d] = c;
    }
    __syncthreads();

    // The factors: warp w forms rows 8w .. 8w + 7 (all in segment w / 2),
    // lane channels lane and lane + 32; and the bonus term per row.
    {
      const int q = warp >> 1;
      float m2[2], off[2], ce[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = lane + 32 * j;
        float tot = 0.f, before = 0.f;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float x = sSeg[s * D + d];
          tot += x;
          if (s < q) before += x;
        }
        m2[j] = 0.5f * tot;
        off[j] = before;
        // cum at the row before 8w: the end of the last segment, or a row
        // of this one
        ce[j] = (warp & 1) ? sW[(8 * warp - 1) * LDF + d] + before : before;
        if (warp == 0) sEm[d] = exp2f(m2[j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * warp + i;
        float diag = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = lane + 32 * j;
          const float c = sW[t * LDF + d] + off[j];
          const float rx = __bfloat162float(sR[t * LDB + d]);
          const float kx = __bfloat162float(sK[t * LDB + d]);
          sRn[t * LDF + d] = rx * exp2f(ce[j] - m2[j]);
          sKn[t * LDF + d] = kx * exp2f(m2[j] - c);
          diag = fmaf(rx * sU[d], kx, diag);
          ce[j] = c;
        }
#pragma unroll
        for (int o = 16; o; o >>= 1)
          diag += __shfl_xor_sync(0xffffffffu, diag, o);
        if (lane == 0) sDiag[t] = diag;
      }
    }
    __syncthreads();

    // r, k and w are consumed: the next chunk's tiles load into them, and
    // its v into the other buffer (last read before the previous chunk's
    // state update), while this chunk's products run.
    if (t0 + p.chunk < p.S)
      load_chunk(p, R, K, V, W, sR, sK, sV2 + ((it + 1) & 1) * C * LDB, sW,
                 t0 + p.chunk, min(p.chunk, p.S - t0 - p.chunk), tid);

    // y[strip] = Rn[strip] (diag(e^m) S)[:, half] and this warp's tiles of
    // A[strip] = Rn[strip] Kn^T, both 3xTF32, over the head dim.
    float yacc[4][4], aacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] = aacc[i][j] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t ahi[4], alo[4];
      wkv::tf32_split(sRn[(r0 + g) * LDF + k0 + tg], ahi[0], alo[0]);
      wkv::tf32_split(sRn[(r0 + g + 8) * LDF + k0 + tg], ahi[1], alo[1]);
      wkv::tf32_split(sRn[(r0 + g) * LDF + k0 + tg + 4], ahi[2], alo[2]);
      wkv::tf32_split(sRn[(r0 + g + 8) * LDF + k0 + tg + 4], ahi[3], alo[3]);
      const float em0 = sEm[k0 + tg], em1 = sEm[k0 + tg + 4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int e = e0 + 8 * nt + g;
        uint32_t b0h, b0l, b1h, b1l;
        wkv::tf32_split(em0 * sS[(k0 + tg) * LDS + e], b0h, b0l);
        wkv::tf32_split(em1 * sS[(k0 + tg + 4) * LDS + e], b1h, b1l);
        wkv::mma_tf32(yacc[nt], alo, b0h, b1h);
        wkv::mma_tf32(yacc[nt], ahi, b0l, b1l);
        wkv::mma_tf32(yacc[nt], ahi, b0h, b1h);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j > strip) break;   // tiles right of the diagonal: skipped
        const int s = 8 * (half + 2 * j) + g;
        uint32_t b0h, b0l, b1h, b1l;
        wkv::tf32_split(sKn[s * LDF + k0 + tg], b0h, b0l);
        wkv::tf32_split(sKn[s * LDF + k0 + tg + 4], b1h, b1l);
        wkv::mma_tf32(aacc[j], alo, b0h, b1h);
        wkv::mma_tf32(aacc[j], ahi, b0l, b1l);
        wkv::mma_tf32(aacc[j], ahi, b0h, b1h);
      }
    }

    // A over the strip's rows of Rn, once both warps of the pair have read
    // them (no other warp reads them).
    wkv::bar_sync(1 + strip, 64);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j > strip) break;
      const int s = 8 * (half + 2 * j) + 2 * tg;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = r0 + g + 8 * rr;
        *reinterpret_cast<float2*>(sRn + t * LDF + s) =
            make_float2(mask_a(t, s, aacc[j][2 * rr], sDiag),
                        mask_a(t, s + 1, aacc[j][2 * rr + 1], sDiag));
      }
    }
    wkv::bar_sync(1 + strip, 64);

    // y[strip] += A[strip] v[:, half] over the k-steps left of the
    // diagonal; v is exact in TF32, so two passes.
    const int ks_end = min(2 * strip + 2, (n + 7) >> 3);
    for (int ks = 0; ks < ks_end; ++ks) {
      const int s0 = 8 * ks;
      uint32_t ahi[4], alo[4];
      wkv::tf32_split(sRn[(r0 + g) * LDF + s0 + tg], ahi[0], alo[0]);
      wkv::tf32_split(sRn[(r0 + g + 8) * LDF + s0 + tg], ahi[1], alo[1]);
      wkv::tf32_split(sRn[(r0 + g) * LDF + s0 + tg + 4], ahi[2], alo[2]);
      wkv::tf32_split(sRn[(r0 + g + 8) * LDF + s0 + tg + 4], ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int e = e0 + 8 * nt + g;
        const uint32_t b0 = bf16_bits(sV[(s0 + tg) * LDB + e]);
        const uint32_t b1 = bf16_bits(sV[(s0 + tg + 4) * LDB + e]);
        wkv::mma_tf32(yacc[nt], alo, b0, b1);
        wkv::mma_tf32(yacc[nt], ahi, b0, b1);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = r0 + g + 8 * rr;
      if (t >= n) continue;
      float* out = Y + (long long)(t0 + t) * p.y_ss + e0 + 2 * tg;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(out + 8 * nt) =
            make_float2(yacc[nt][2 * rr], yacc[nt][2 * rr + 1]);
    }

    // Kn^T v for the state's rows (channels) of this strip and columns of
    // this half, two passes, over the chunk's real rows.
    float uacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) uacc[i][j] = 0.f;
    for (int s0 = 0; s0 < n; s0 += 8) {
      uint32_t ahi[4], alo[4];
      wkv::tf32_split(sKn[(s0 + tg) * LDF + r0 + g], ahi[0], alo[0]);
      wkv::tf32_split(sKn[(s0 + tg) * LDF + r0 + g + 8], ahi[1], alo[1]);
      wkv::tf32_split(sKn[(s0 + tg + 4) * LDF + r0 + g], ahi[2], alo[2]);
      wkv::tf32_split(sKn[(s0 + tg + 4) * LDF + r0 + g + 8], ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int e = e0 + 8 * nt + g;
        const uint32_t b0 = bf16_bits(sV[(s0 + tg) * LDB + e]);
        const uint32_t b1 = bf16_bits(sV[(s0 + tg + 4) * LDB + e]);
        wkv::mma_tf32(uacc[nt], alo, b0, b1);
        wkv::mma_tf32(uacc[nt], ahi, b0, b1);
      }
    }
    __syncthreads();  // every warp has read the state for y

    // S <- diag(e^m) (diag(e^m) S + Kn^T v); each thread its own cells.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int d = r0 + g + 8 * rr;
      const float em = sEm[d];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float2* cell =
            reinterpret_cast<float2*>(sS + d * LDS + e0 + 8 * nt + 2 * tg);
        float2 s = *cell;
        s.x = em * fmaf(em, s.x, uacc[nt][2 * rr]);
        s.y = em * fmaf(em, s.y, uacc[nt][2 * rr + 1]);
        *cell = s;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < D * D; i += NT)
    p.s_last[s_base + i] = sS[(i / D) * LDS + i % D];
}

cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  // as much of the SM's 256 KB as shared memory as it gives, so that two
  // blocks fit
  return cudaFuncSetAttribute(wkv6_mma_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The kernel's attributes hold per device: they are set at the first
// launch on each device, not on every launch.
constexpr int kMaxDevices = 64;
std::atomic<bool> configured[kMaxDevices];

cudaError_t configure() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && configured[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = set_attributes();
  if (err == cudaSuccess && dev < kMaxDevices)
    configured[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// The arguments of repro_wkv6_fwd (rwkv6.cu). Takes dtype 1 (bfloat16 r,
// k, v) at D = 64 only; w, u, the states and y are float32. Strides are in
// elements; the head dim must be contiguous, every other stride and every
// base 16-byte aligned (cp.async), u and the states contiguous. state0 may
// be null (zeros); 1 <= chunk <= 64. Returns the cudaError_t of the launch.
extern "C" int repro_wkv6_mma_fwd(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* state0, float* y, float* s_last, int dtype,
    int B, int S, int H, int D_, int chunk, long long r_sb, long long r_ss,
    long long r_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long w_sb,
    long long w_ss, long long w_sh, long long y_sb, long long y_ss,
    long long y_sh, void* stream) {
  if (dtype != 1 || D_ != D || B <= 0 || S <= 0 || H <= 0 || chunk < 1 ||
      chunk > C)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const __nv_bfloat16*>(r),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 w, u, state0, y, s_last, B, S, H, chunk,
                 r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 w_sb, w_ss, w_sh, y_sb, y_ss, y_sh};
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_mma_kernel<<<dim3(H, B), NT, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the kernel an SM holds at once (the occupancy
// calculator's answer with its shared memory), or a negative cudaError_t.
extern "C" int repro_wkv6_mma_blocks_per_sm() {
  cudaError_t err = configure();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, wkv6_mma_kernel, NT, kSmemBytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
