// RWKV6 (Finch) chunked recurrence, backward, on Hopper's tensor cores
// (sm_90a), CUDA C++: bf16 r, k, v at head dim 64, every chunk from 1 to 64,
// any S.
//
// Computes the function of rwkv6_bwd.cu (`repro_wkv6_bwd`), the gradient of
// the forward kernels in this folder, which replace the Pallas TPU kernel
// `_rwkv6_kernel` in src/repro/kernels/rwkv6/kernel.py. The reference has no
// backward kernel: JAX differentiates `_wkv_chunked`
// (src/repro/models/rwkv.py). The plain version is `wkv_bwd_ref` in
// ../ref.py; `wkv_bwd_staged_ref` there is this kernel's decomposition in
// plain PyTorch. rwkv6_bwd.cu keeps float32 r, k, v and head dims 16, 32.
//
// Algebra (rwkv6_bwd.cu's header has it in full). Per chunk, with cum the
// cumulative log-decay, cum_ex the same one token later, tot = cum at the
// chunk's end, m = tot / 2, fr = e^{cum_ex - m}, fk = e^{m - cum},
// r~ = r fr, k~ = k fk, A = strictly lower (r~ k~^T), dA2 = dy v^T below the
// band, b the band dA[t][t-1], S_in the state entering the chunk and dS the
// cotangent of the one leaving it:
//   G = dA2 k~,  Q = dy S_in^T,  Hs = dA2^T r~,  P = v dS^T
//   dr = fr G + fr e^m Q + b_t k_{t-1} + delta u k
//   dk = fk Hs + fk e^m P + b_{s+1} r_{s+1} + delta u r
//   dv = A^T dy + k~ (e^m dS) + (r u k)_t dy_t
// and the two state recurrences, which act on the state element by element:
//   S_out[d][e]  = e^{tot[d]} S_in[d][e] + sum_t k_tail[t][d] v[t][e]
//   dS_in[d][e]  = sum_t r[t][d] e^{cum_ex[t][d]} dy[t][e] + e^{tot[d]} dS[d][e]
// (k_tail = k e^{tot - cum} = k~ e^m, r e^{cum_ex} = r~ e^m).
//
// Design. Two kernels, launched one after the other on the caller's stream.
// 1. `wkv6_bwd_walk_mma`: both state walks in one launch. Because both
//    recurrences act on the state element by element, a walk splits into
//    independent state tiles: a block walks 16 state rows (channels d) and
//    all 64 value columns, so it needs only its 16 channels' decay and k
//    (or r) and computes their factors once (a tile of value columns would
//    recompute all 64 channels' factors in each of its 4 blocks). Grid:
//    (4 row tiles x {forward, backward}, H, B), 512 blocks of 128 threads at
//    B=1, H=64, 4 a SM. The forward walk starts from state0 (or zeros) and
//    writes every chunk's S_in into the workspace S_ws; the backward walk
//    starts from dS_last, writes every chunk's dS into dS_ws and returns
//    dstate0. The state stays in the mma accumulators; each step is one
//    16 x 64 x 64 product, its per-row e^{tot} factor and its log-decay
//    prefix sum in parallel (eight segments of 8 tokens a channel); the next
//    chunk's tiles load with 16-byte cp.async while this one is computed.
// 2. `wkv6_bwd_grad_mma`: one block of 256 threads per (b, h, chunk), 2,048
//    at the training shape, two a SM. With S_in and dS in the workspaces,
//    every other product and every gradient is local to a chunk: it loads
//    r, k, v, dy, w, S_in and dS, forms fr and fk, then computes A, Q, then
//    dv (A^T dy + k~ e^m dS), dA2 and the band, G with dr, Hs and P with dk,
//    and dw: eight products, no chain across chunks. du leaves as a
//    per-(b, h, chunk) partial, which the wrapper sums in a fixed order: no
//    atomics, so repeated calls give the same bits.
// 3. Every product is mma.sync m16n8k8 TF32 with a float32 accumulator, in
//    3xTF32 (hi.hi + hi.lo + lo.hi, hi = tf32(x), lo = tf32(x - hi)); bf16
//    v, and r and k before scaling, are exact in TF32, so a product with one
//    of them takes two passes. One TF32 pass misses the gate below by
//    10-20x (rwkv6_mma.cu's header). Warp w of the gradient pass owns the
//    16-row strip w / 2 of each 64 x 64 output and the 32 columns of half
//    w % 2; products over the strictly lower A and dA2 skip the tiles right
//    of the diagonal and the k-steps that only meet zeros. mma.sync rather
//    than wgmma: wgmma's TF32 form takes only K-major operands from shared
//    memory, and five of these products read an operand transposed (dA2^T,
//    A^T, S_in^T, dS^T, and r e^{cum_ex} in the walk); an mma.sync fragment
//    is gathered in any layout.
// 4. Shared-memory tiles have no padding: 64 x 64 float32 tiles keep
//    element (row, col) at row * 64 + (col ^ (8 (row & 3) | (row & 4))),
//    bf16 tiles at row * 64 + (col ^ 8 (row & 7)), so an A or a B fragment
//    reads 32 banks whether it walks a tile by rows or by columns, and each
//    16-byte cp.async chunk stays whole. 110,336 bytes a gradient block.
//
// Numerics, as in rwkv6_bwd.cu: the band goes into dr and dk directly and
// the tail of dw uses an exclusive prefix sum, so no term of the log-decay's
// gradient is summed and then cancelled (under strong decay those terms are
// the largest and their rounding lost dw); the factors are e^{+-(cum - m)}.
// Exponentials are exp2f of log2-scaled sums (log2f of w): within 2 ulp.
//
// Range: each channel's summed log-decay over a chunk (tot) above about
// -150, as rwkv6_bwd.cu: the factors reach e^{75} and G and Hs add 64 such
// terms. Near that edge a factor e^{-75} times a small k or r falls below
// 2^11 FLT_MIN, where the lo part of its 3xTF32 split is subnormal; at
// random init tot is about -0.16. Nothing is clamped.
//
// Bound on the H100. At the rwkv6-7b training shape (B=1, S=2048, H=64,
// hd=64) the function moves r, k, v, w, dy, u, state0, dS_last in and dr,
// dk, dv, dw, du, dstate0 out, 195 MiB: 0.061 ms at 3.35 TB/s; its eight
// products per (b, h, chunk), 8.6 GFLOP, are 0.009 ms at the bf16 rate. So
// bytes bound it. The workspaces (two 32 MiB writes and reads, mostly in
// L2) are not counted in the bound.
//
// Tolerance: chip_smoke.py holds it to the plain version under the gate of
// rwkv6_bwd.cu, unchanged (2e-5 x max(1, |tot|_max / 20) x max(1,
// max |plain|) per gradient, bf16 dr, dk, dv one rounding more).

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rwkv6_ptx.cuh"

namespace {

constexpr int C = 64;            // rows of a chunk tile (the largest chunk)
constexpr int D = 64;            // head dim
constexpr int TILE = C * D;
constexpr int DT = 16;           // state rows (channels) of a walk block
constexpr int N_DTILES = D / DT;
constexpr int SEGS = 8;          // 8-token segments of a walk's prefix sum
constexpr int WALK_NT = 128;
constexpr int GRAD_NT = 256;

// a walk stage: the 16-channel strips of k (or r, bf16) and w (float32,
// then the factor), v (bf16) or dy (float32) whole
constexpr size_t kStripBf16 = sizeof(__nv_bfloat16) * C * DT;
constexpr size_t kStripF32 = sizeof(float) * C * DT;
constexpr size_t kWalkStage = kStripBf16 + kStripF32 + sizeof(float) * TILE;
constexpr size_t kWalkSmem = 2 * kWalkStage + sizeof(float) * (SEGS + 1) * DT;
// r, k, v (bf16); fr, fk, dy, X, dS (float32); u, e^m, e^tot, s2, delta,
// diag, band; eight rows of segment sums
constexpr size_t kGradSmem = 3 * sizeof(__nv_bfloat16) * TILE +
                             5 * sizeof(float) * TILE +
                             sizeof(float) * (7 * D + 8 * D);

struct Params {
  const __nv_bfloat16* r;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* w;
  const float* u;               // (H, D), contiguous
  const float* state0;          // (B, H, D, D), contiguous, or null: zeros
  const float* dy;
  const float* ds_last;         // (B, H, D, D), contiguous
  __nv_bfloat16* dr;            // the output strides
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* dw;
  float* du;                    // (B, H, n, D) partials, contiguous
  float* dstate0;               // (B, H, D, D), contiguous
  float* s_ws;                  // (B, H, n, D, D): each chunk's S_in
  float* ds_ws;                 // (B, H, n, D, D): each chunk's dS
  int B, S, H, chunk, n;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long g_sb, g_ss, g_sh;   // dy
  long long o_sb, o_ss, o_sh;   // dr, dk, dv, dw
};

// ---- tile layouts -----------------------------------------------------------

// 64 x 64 float32 tile
__device__ __forceinline__ int f32_at(int row, int col) {
  return row * D + (col ^ (((row & 3) << 3) | (row & 4)));
}
// 64 x 64 bf16 tile
__device__ __forceinline__ int bf16_at(int row, int col) {
  return row * D + (col ^ ((row & 7) << 3));
}
// 64 x 16 float32 strip (a walk's w, then its factor)
__device__ __forceinline__ int strip_at(int row, int col) {
  return row * DT + (col ^ ((row & 2) << 2));
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows [0, 64) of a tile from `src` (row stride `ss` elements); rows at or
// past `n` are zero-filled, their source the first row, not read.
template <int NT>
__device__ __forceinline__ void load_bf16_tile(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long ss, int n, int tid) {
  for (int i = tid; i < C * 8; i += NT) {
    const int t = i >> 3, q = i & 7;
    const bool in = t < n;
    wkv::cp_async16(dst + t * D + 8 * (q ^ (t & 7)),
                    src + (in ? t : 0) * ss + 8 * q, in ? 16 : 0);
  }
}

template <int NT>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src,
                                              long long ss, int n, int tid) {
  for (int i = tid; i < C * 16; i += NT) {
    const int t = i >> 4, q = i & 15;
    const bool in = t < n;
    wkv::cp_async16(dst + t * D + 4 * (q ^ (((t & 3) << 1) | ((t & 4) >> 2))),
                    src + (in ? t : 0) * ss + 4 * q, in ? 16 : 0);
  }
}

// ---- the warp's products ----------------------------------------------------

// hi (and lo) of x for the 3xTF32 split; EXACT: x is a TF32 value already
// (a bf16), its lo is 0 and never used.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    wkv::tf32_split(x, hi, lo);
  }
}

// acc[j] += A B over the k-steps [ks0, ks1) (8 k each), for the warp's
// 16 x 8 output tiles j < NT at columns n0 + nstep * j: a(i, k) is A's
// element at the warp's row i (0..15), b(k, n) is B's. 3xTF32, or two
// passes when one operand is exact in TF32 (AX, BX); the small terms are
// added first. NT is known at compile time, so no run-time branch sits
// between the tiles (with one, the gradient pass spilled 8 bytes).
template <int NT, bool AX, bool BX, int N, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[N][4], int n0,
                                         int nstep, int ks0, int ks1, FA a,
                                         FB b) {
  static_assert(NT <= N, "more tiles than accumulators");
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  for (int ks = ks0; ks < ks1; ++ks) {
    const int k0 = 8 * ks;
    uint32_t ah[4], al[4];
    split<AX>(a(g, k0 + c), ah[0], al[0]);
    split<AX>(a(g + 8, k0 + c), ah[1], al[1]);
    split<AX>(a(g, k0 + c + 4), ah[2], al[2]);
    split<AX>(a(g + 8, k0 + c + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + nstep * j + g;
      uint32_t bh0, bl0, bh1, bl1;
      split<BX>(b(k0 + c, col), bh0, bl0);
      split<BX>(b(k0 + c + 4, col), bh1, bl1);
      if (!AX) wkv::mma_tf32(acc[j], al, bh0, bh1);
      if (!BX) wkv::mma_tf32(acc[j], ah, bl0, bl1);
      wkv::mma_tf32(acc[j], ah, bh0, bh1);
    }
  }
}

// warp_mma over the first nt tiles (1 <= nt <= 4), nt known at run time
// (the tiles at or left of a diagonal)
template <bool AX, bool BX, class FA, class FB>
__device__ __forceinline__ void warp_mma_first(float (&acc)[4][4], int nt,
                                               int n0, int nstep, int ks0,
                                               int ks1, FA a, FB b) {
  switch (nt) {
    case 1: warp_mma<1, AX, BX>(acc, n0, nstep, ks0, ks1, a, b); break;
    case 2: warp_mma<2, AX, BX>(acc, n0, nstep, ks0, ks1, a, b); break;
    case 3: warp_mma<3, AX, BX>(acc, n0, nstep, ks0, ks1, a, b); break;
    default: warp_mma<4, AX, BX>(acc, n0, nstep, ks0, ks1, a, b);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// ---- 1. the state walks -----------------------------------------------------

// One chunk's tiles for a walk: the channel strip of k (forward) or r
// (backward), the strip of w, and v (forward) or dy (backward) whole.
__device__ __forceinline__ void walk_load(const Params& p, unsigned char* st,
                                          bool bwd, int b, int h, int d0,
                                          int t0, int n, int tid) {
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(st);
  float* sW = reinterpret_cast<float*>(st + kStripBf16);
  unsigned char* big = st + kStripBf16 + kStripF32;
  const __nv_bfloat16* X = bwd ? p.r + b * p.r_sb + h * p.r_sh
                               : p.k + b * p.k_sb + h * p.k_sh;
  const long long x_ss = bwd ? p.r_ss : p.k_ss;
  const float* W = p.w + b * p.w_sb + h * p.w_sh + t0 * p.w_ss + d0;
  X += t0 * x_ss + d0;
  for (int i = tid; i < C * 2; i += WALK_NT) {
    const int t = i >> 1, q = i & 1;
    const bool in = t < n;
    wkv::cp_async16(sX + t * DT + 8 * q, X + (in ? t : 0) * x_ss + 8 * q,
                    in ? 16 : 0);
  }
  for (int i = tid; i < C * 4; i += WALK_NT) {
    const int t = i >> 2, q = i & 3;
    const bool in = t < n;
    wkv::cp_async16(sW + t * DT + 4 * (q ^ (t & 2)),
                    W + (in ? t : 0) * p.w_ss + 4 * q, in ? 16 : 0);
  }
  if (bwd)
    load_f32_tile<WALK_NT>(reinterpret_cast<float*>(big),
                           p.dy + b * p.g_sb + h * p.g_sh + t0 * p.g_ss,
                           p.g_ss, n, tid);
  else
    load_bf16_tile<WALK_NT>(reinterpret_cast<__nv_bfloat16*>(big),
                            p.v + b * p.v_sb + h * p.v_sh + t0 * p.v_ss,
                            p.v_ss, n, tid);
}

__global__ void __launch_bounds__(WALK_NT, 4)
    wkv6_bwd_walk_mma(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sSeg = reinterpret_cast<float*>(smem + 2 * kWalkStage);  // 8 x 16
  float* sEtot = sSeg + SEGS * DT;                                 // e^tot

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const bool bwd = blockIdx.x >= N_DTILES;
  const int d0 = DT * (blockIdx.x % N_DTILES);
  const int h = blockIdx.y, b = blockIdx.z, n_chunks = p.n;
  const long long bh = static_cast<long long>(b) * p.H + h;
  // the prefix sum's thread: channel dd, tokens 8 q .. 8 q + 7
  const int dd = lane & 15, q = 2 * warp + (lane >> 4);
  // the product's: state rows g and g + 8, value columns 16 warp + 8 j
  // + 2 c (+1) of n-tile j

  // the state (forward) or its cotangent (backward) in the accumulators
  float acc[2][4];
  {
    const float* init = bwd ? p.ds_last : p.state0;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = d0 + g + 8 * (i >> 1);
        const int col = 16 * warp + 8 * j + 2 * c + (i & 1);
        acc[j][i] = init ? init[bh * D * D + row * D + col] : 0.f;
      }
  }

  // the forward walk's last chunk needs no update (its S_out is not used)
  const int updates = bwd ? n_chunks : n_chunks - 1;
  auto chunk_at = [&](int it) { return bwd ? n_chunks - 1 - it : it; };
  if (updates > 0) {
    const int t0 = chunk_at(0) * p.chunk;
    walk_load(p, smem, bwd, b, h, d0, t0, min(p.chunk, p.S - t0), tid);
  }
  for (int it = 0; it < n_chunks; ++it) {
    const int cc = chunk_at(it), t0 = cc * p.chunk;
    const int n = min(p.chunk, p.S - t0);
    unsigned char* st = smem + (it & 1) * kWalkStage;
    const __nv_bfloat16* sX = reinterpret_cast<const __nv_bfloat16*>(st);
    float* sW = reinterpret_cast<float*>(st + kStripBf16);
    const unsigned char* big = st + kStripBf16 + kStripF32;

    // this chunk's S_in (forward) or dS (backward) into its workspace
    {
      float* ws = (bwd ? p.ds_ws : p.s_ws) + (bh * n_chunks + cc) * D * D;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = d0 + g + 8 * rr;
          const int col = 16 * warp + 8 * j + 2 * c;
          *reinterpret_cast<float2*>(ws + row * D + col) =
              make_float2(acc[j][2 * rr], acc[j][2 * rr + 1]);
        }
    }
    if (it == updates) break;

    wkv::cp_async_wait_all();
    __syncthreads();  // this chunk's tiles; the other stage is free
    if (it + 1 < updates) {
      const int t1 = chunk_at(it + 1) * p.chunk;
      walk_load(p, smem + ((it + 1) & 1) * kWalkStage, bwd, b, h, d0, t1,
                min(p.chunk, p.S - t1), tid);
    }

    // prefix sums of log2 w over each 8-token segment, in registers
    float lg[8];
    {
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = 8 * q + j;
        run += t < n ? log2f(sW[strip_at(t, dd)]) : 0.f;
        lg[j] = run;
      }
      sSeg[q * DT + dd] = run;
    }
    __syncthreads();
    // the factor, in place of w: k e^{tot - cum} (forward) or
    // r e^{cum_ex} (backward)
    {
      float tot = 0.f, off = 0.f;
#pragma unroll
      for (int s = 0; s < SEGS; ++s) {
        const float x = sSeg[s * DT + dd];
        tot += x;
        if (s < q) off += x;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = 8 * q + j;
        const float x = bf(sX[t * DT + dd]);
        const float ex = bwd ? (j ? off + lg[j - 1] : off)
                             : tot - (off + lg[j]);
        sW[strip_at(t, dd)] = x * exp2f(ex);
      }
      if (q == 0) sEtot[dd] = exp2f(tot);
    }
    __syncthreads();

    // S <- e^tot S + k_tail^T v, or dS <- e^tot dS + (r e^{cum_ex})^T dy,
    // over the chunk's real tokens
    {
      const float e0 = sEtot[g], e1 = sEtot[g + 8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
      const int ks1 = (n + 7) >> 3;
      auto a = [&](int i, int kk) { return sW[strip_at(kk, i)]; };
      if (bwd) {
        const float* sDy = reinterpret_cast<const float*>(big);
        warp_mma<2, false, false>(
            acc, 16 * warp, 8, 0, ks1, a,
            [&](int kk, int e) { return sDy[f32_at(kk, e)]; });
      } else {
        const __nv_bfloat16* sV = reinterpret_cast<const __nv_bfloat16*>(big);
        warp_mma<2, false, true>(
            acc, 16 * warp, 8, 0, ks1, a,
            [&](int kk, int e) { return bf(sV[bf16_at(kk, e)]); });
      }
    }
  }
  if (bwd) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = d0 + g + 8 * rr;
        const int col = 16 * warp + 8 * j + 2 * c;
        *reinterpret_cast<float2*>(p.dstate0 + bh * D * D + row * D + col) =
            make_float2(acc[j][2 * rr], acc[j][2 * rr + 1]);
      }
  }
}

// ---- 2. the chunk-parallel gradient pass ------------------------------------

__device__ __forceinline__ void put2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__global__ void __launch_bounds__(GRAD_NT, 2)
    wkv6_bwd_grad_mma(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sR = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sR + TILE;
  __nv_bfloat16* sV = sK + TILE;
  float* sFr = reinterpret_cast<float*>(sV + TILE);  // w, then fr
  float* sFk = sFr + TILE;
  float* sDy = sFk + TILE;      // dy, then the cotangent of each cum (Dc)
  float* sX = sDy + TILE;       // S_in, then A, dA2, the tail's P k_tail
  float* sDS = sX + TILE;
  float* sU = sDS + TILE;
  float* sEm = sU + D;          // e^m
  float* sEtot = sEm + D;
  float* sS2 = sEtot + D;       // sum_e S_in dS per row d
  float* sDelta = sS2 + D;      // dy_t . v_t
  float* sDiag = sDelta + D;    // r_t . u . k_t
  float* sBand = sDiag + D;     // dA[t][t-1]
  float* sSeg = sBand + D;      // 8 x D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int cc = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = cc * p.chunk, n = min(p.chunk, p.S - t0);
  const long long bhc = (static_cast<long long>(b) * p.H + h) * p.n + cc;
  const long long o_base = b * p.o_sb + h * p.o_sh + t0 * p.o_ss;

  load_bf16_tile<GRAD_NT>(sR, p.r + b * p.r_sb + h * p.r_sh + t0 * p.r_ss,
                          p.r_ss, n, tid);
  load_bf16_tile<GRAD_NT>(sK, p.k + b * p.k_sb + h * p.k_sh + t0 * p.k_ss,
                          p.k_ss, n, tid);
  load_bf16_tile<GRAD_NT>(sV, p.v + b * p.v_sb + h * p.v_sh + t0 * p.v_ss,
                          p.v_ss, n, tid);
  load_f32_tile<GRAD_NT>(sFr, p.w + b * p.w_sb + h * p.w_sh + t0 * p.w_ss,
                         p.w_ss, n, tid);
  load_f32_tile<GRAD_NT>(sDy, p.dy + b * p.g_sb + h * p.g_sh + t0 * p.g_ss,
                         p.g_ss, n, tid);
  load_f32_tile<GRAD_NT>(sX, p.s_ws + bhc * D * D, D, C, tid);
  load_f32_tile<GRAD_NT>(sDS, p.ds_ws + bhc * D * D, D, C, tid);
  if (tid < D) sU[tid] = p.u[h * D + tid];
  wkv::cp_async_wait_all();
  __syncthreads();

  // the prefix sum's thread: channel sd, tokens 16 sq .. 16 sq + 15
  const int sq = warp >> 1, sd = 32 * (warp & 1) + lane;
  float cum[16];
  {
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int t = 16 * sq + j;
      run += t < n ? log2f(sFr[f32_at(t, sd)]) : 0.f;
      cum[j] = run;
    }
    sSeg[sq * D + sd] = run;
  }
  // per-row dot products: warp w rows 8w .. 8w + 7, lanes over columns
#pragma unroll 2
  for (int i = 0; i < 8; ++i) {
    const int t = 8 * warp + i;
    float dl = 0.f, dg = 0.f, s2 = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int e = lane + 32 * hh;
      dl = fmaf(sDy[f32_at(t, e)], bf(sV[bf16_at(t, e)]), dl);
      dg = fmaf(bf(sR[bf16_at(t, e)]) * sU[e], bf(sK[bf16_at(t, e)]), dg);
      s2 = fmaf(sX[f32_at(t, e)], sDS[f32_at(t, e)], s2);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      dl += __shfl_xor_sync(0xffffffffu, dl, o);
      dg += __shfl_xor_sync(0xffffffffu, dg, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      sDelta[t] = dl;
      sDiag[t] = dg;
      sS2[t] = s2;
    }
  }
  __syncthreads();

  // the factors, fr in place of w
  {
    float tot = 0.f, off = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float x = sSeg[s * D + sd];
      tot += x;
      if (s < sq) off += x;
    }
    const float m = 0.5f * tot;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int t = 16 * sq + j;
      const float ce = j ? off + cum[j - 1] : off;
      sFr[f32_at(t, sd)] = exp2f(ce - m);
      sFk[f32_at(t, sd)] = exp2f(m - (off + cum[j]));
    }
    if (sq == 0) {
      sEm[sd] = exp2f(m);
      sEtot[sd] = exp2f(tot);
    }
  }
  __syncthreads();

  // du's partial over this thread's 16 tokens
  {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int t = 16 * sq + j;
      s = fmaf(sDelta[t] * bf(sR[bf16_at(t, sd)]), bf(sK[bf16_at(t, sd)]), s);
    }
    sSeg[(4 + sq) * D + sd] = s;
  }

  const int strip = warp >> 1, half = warp & 1, m0 = 16 * strip;
  const int ks_n = (n + 7) >> 3;  // k-steps over tokens that are real
  auto rt = [&](int t, int d) {
    return bf(sR[bf16_at(t, d)]) * sFr[f32_at(t, d)];
  };
  auto kt = [&](int s, int d) {
    return bf(sK[bf16_at(s, d)]) * sFk[f32_at(s, d)];
  };

  // A = r~ k~^T (this warp's tiles at or left of the diagonal) and
  // Q = dy S_in^T, kept until dr
  float acc[4][4], accQ[4][4];
  zero(acc);
  zero(accQ);
  warp_mma_first<false, false>(
      acc, strip + 1, 8 * half, 16, 0, 8,
      [&](int i, int kk) { return rt(m0 + i, kk); },
      [&](int kk, int s) { return kt(s, kk); });
  warp_mma<4, false, false>(
      accQ, 32 * half, 8, 0, 8,
      [&](int i, int kk) { return sDy[f32_at(m0 + i, kk)]; },
      [&](int kk, int d) { return sX[f32_at(d, kk)]; });
  __syncthreads();  // every warp has read S_in
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j > strip) break;
    const int s = 8 * half + 16 * j + 2 * c;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = m0 + g + 8 * rr;
      *reinterpret_cast<float2*>(sX + f32_at(t, s)) =
          make_float2(s < t ? acc[j][2 * rr] : 0.f,
                      s + 1 < t ? acc[j][2 * rr + 1] : 0.f);
    }
  }
  __syncthreads();
  if (tid < D)
    p.du[bhc * D + tid] = sSeg[4 * D + tid] + sSeg[5 * D + tid] +
                          sSeg[6 * D + tid] + sSeg[7 * D + tid];

  // dv = A^T dy + k~ (e^m dS) + diag dy
  zero(acc);
  warp_mma<4, false, false>(
      acc, 32 * half, 8, 2 * strip, ks_n,
      [&](int i, int kk) { return sX[f32_at(kk, m0 + i)]; },
      [&](int kk, int e) { return sDy[f32_at(kk, e)]; });
  warp_mma<4, false, false>(
      acc, 32 * half, 8, 0, 8,
      [&](int i, int kk) { return kt(m0 + i, kk); },
      [&](int kk, int e) { return sEm[kk] * sDS[f32_at(kk, e)]; });
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = 32 * half + 8 * j + 2 * c;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = m0 + g + 8 * rr;
      if (s < n)
        put2(p.dv + o_base + s * p.o_ss + e,
             acc[j][2 * rr] + sDiag[s] * sDy[f32_at(s, e)],
             acc[j][2 * rr + 1] + sDiag[s] * sDy[f32_at(s, e + 1)]);
    }
  }
  __syncthreads();  // A is consumed

  // dA = dy v^T: dA2 (below the band) over A, and the band
  zero(acc);
  warp_mma_first<false, true>(
      acc, strip + 1, 8 * half, 16, 0, 8,
      [&](int i, int kk) { return sDy[f32_at(m0 + i, kk)]; },
      [&](int kk, int s) { return bf(sV[bf16_at(s, kk)]); });
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j > strip) break;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = m0 + g + 8 * rr;
      const int s = 8 * half + 16 * j + 2 * c;
      const float x0 = acc[j][2 * rr], x1 = acc[j][2 * rr + 1];
      *reinterpret_cast<float2*>(sX + f32_at(t, s)) =
          make_float2(s < t - 1 ? x0 : 0.f, s + 1 < t - 1 ? x1 : 0.f);
      if (s == t - 1) sBand[t] = x0;
      if (s + 1 == t - 1) sBand[t] = x1;
      if (t == 0 && s == 0) sBand[0] = 0.f;
    }
  }
  __syncthreads();  // dA2 and the band; dy is consumed

  // G = dA2 k~ with Q: dr, and the cotangent of cum_ex (that of cum one
  // row up) into Dc over dy
  zero(acc);
  warp_mma<4, false, false>(
      acc, 32 * half, 8, 0, min(2 * strip + 2, ks_n),
      [&](int i, int kk) { return sX[f32_at(m0 + i, kk)]; },
      [&](int kk, int d) { return kt(kk, d); });
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = 32 * half + 8 * j + 2 * c;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = m0 + g + 8 * rr;
      float out[2], dce[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float G = acc[j][2 * rr + e], Q = accQ[j][2 * rr + e];
        const float fr = sFr[f32_at(t, d + e)], em = sEm[d + e];
        const float kv = bf(sK[bf16_at(t, d + e)]);
        const float rtv = bf(sR[bf16_at(t, d + e)]) * fr;
        const float bk = t > 0 ? sBand[t] * bf(sK[bf16_at(t - 1, d + e)])
                               : 0.f;
        out[e] = G * fr + Q * (fr * em) + sDelta[t] * sU[d + e] * kv + bk;
        dce[e] = G * rtv + Q * (rtv * em);
      }
      if (t < n) put2(p.dr + o_base + t * p.o_ss + d, out[0], out[1]);
      *reinterpret_cast<float2*>(sDy + f32_at(t > 0 ? t - 1 : C - 1, d)) =
          t > 0 ? make_float2(dce[0], dce[1]) : make_float2(0.f, 0.f);
    }
  }

  // Hs = dA2^T r~ and P = v dS^T: dk; Dc -= Hs k~; P k_tail over dA2
  float accP[4][4];
  zero(acc);
  zero(accP);
  warp_mma<4, false, false>(
      acc, 32 * half, 8, 2 * strip, ks_n,
      [&](int i, int kk) { return sX[f32_at(kk, m0 + i)]; },
      [&](int kk, int d) { return rt(kk, d); });
  warp_mma<4, true, false>(
      accP, 32 * half, 8, 0, 8,
      [&](int i, int kk) { return bf(sV[bf16_at(m0 + i, kk)]); },
      [&](int kk, int d) { return sDS[f32_at(d, kk)]; });
  __syncthreads();  // dA2 is consumed; Dc is written
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = 32 * half + 8 * j + 2 * c;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = m0 + g + 8 * rr;
      float out[2], dc[2], pk[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float Hs = acc[j][2 * rr + e], P = accP[j][2 * rr + e];
        const float fk = sFk[f32_at(s, d + e)], em = sEm[d + e];
        const float rv = bf(sR[bf16_at(s, d + e)]);
        const float ktv = bf(sK[bf16_at(s, d + e)]) * fk;
        const float br = s + 1 < C
            ? sBand[s + 1] * bf(sR[bf16_at(s + 1, d + e)]) : 0.f;
        out[e] = Hs * fk + P * (fk * em) + sDelta[s] * sU[d + e] * rv + br;
        dc[e] = Hs * ktv;
        pk[e] = P * (ktv * em);
      }
      if (s < n) put2(p.dk + o_base + s * p.o_ss + d, out[0], out[1]);
      float2* cell = reinterpret_cast<float2*>(sDy + f32_at(s, d));
      float2 x = *cell;
      x.x -= dc[0];
      x.y -= dc[1];
      *cell = x;
      *reinterpret_cast<float2*>(sX + f32_at(s, d)) =
          make_float2(pk[0], pk[1]);
    }
  }
  __syncthreads();

  // dlog w_j = sum_{t >= j} Dc_t (+ e^tot s2 at the last row)
  //          + sum_{s < j} P k_tail_s; dw = dlog w / w
  float dcv[16], pkv[16];
  {
    float sdc = 0.f, spk = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int t = 16 * sq + j;
      dcv[j] = sDy[f32_at(t, sd)];
      pkv[j] = sX[f32_at(t, sd)];
    }
    if (sq == 3) dcv[15] += sEtot[sd] * sS2[sd];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sdc += dcv[j];
      spk += pkv[j];
    }
    sSeg[sq * D + sd] = sdc;
    sSeg[(4 + sq) * D + sd] = spk;
  }
  __syncthreads();
  {
    float run = 0.f, pre = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s > sq) run += sSeg[s * D + sd];
      if (s < sq) pre += sSeg[(4 + s) * D + sd];
    }
    float excl[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      excl[j] = pre;
      pre += pkv[j];
    }
    const float* W = p.w + b * p.w_sb + h * p.w_sh + t0 * p.w_ss + sd;
#pragma unroll
    for (int j = 15; j >= 0; --j) {
      run += dcv[j];
      const int t = 16 * sq + j;
      if (t < n) p.dw[o_base + t * p.o_ss + sd] = (run + excl[j]) / W[t * p.w_ss];
    }
  }
}

// ---- host side --------------------------------------------------------------

cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_walk_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWalkSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_walk_mma,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        wkv6_bwd_grad_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kGradSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_grad_mma,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// The kernels' attributes hold per device: set at the first launch on each.
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

// The arguments of repro_wkv6_bwd (rwkv6_bwd.cu), with two workspaces in
// place of one. Takes dtype 1 (bfloat16 r, k, v, dr, dk, dv) at D = 64
// only; w, u, dy, the states and dw float32. Strides are in elements; the
// head dim must be contiguous, every other stride of r, k, v, w and dy and
// every base 16-byte aligned (cp.async); u, the states, du and the
// workspaces contiguous; state0 may be null (zeros); 1 <= chunk <= 64.
// du holds B * H * n * 64 partials (n = ceil(S / chunk)); s_ws and ds_ws
// B * H * n * 64 * 64 floats each. Returns the cudaError_t of the launches.
extern "C" int repro_wkv6_bwd_mma(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* state0, const float* dy,
    const float* ds_last, void* dr, void* dk, void* dv, float* dw, float* du,
    float* dstate0, float* s_ws, float* ds_ws, int dtype, int B, int S,
    int H, int D_, int chunk, long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long w_sb, long long w_ss,
    long long w_sh, long long g_sb, long long g_ss, long long g_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  if (dtype != 1 || D_ != D || B <= 0 || S <= 0 || H <= 0 || chunk < 1 ||
      chunk > C)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = (S + chunk - 1) / chunk;
  const Params p{static_cast<const __nv_bfloat16*>(r),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 w, u, state0, dy, ds_last,
                 static_cast<__nv_bfloat16*>(dr),
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv),
                 dw, du, dstate0, s_ws, ds_ws, B, S, H, chunk, n,
                 r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 w_sb, w_ss, w_sh, g_sb, g_ss, g_sh, o_sb, o_ss, o_sh};
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wkv6_bwd_walk_mma<<<dim3(2 * N_DTILES, H, B), WALK_NT, kWalkSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_grad_mma<<<dim3(n, H, B), GRAD_NT, kGradSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the walk (which = 0) or gradient (which = 1) kernel an SM holds
// at once, by the occupancy calculator, or a negative cudaError_t.
extern "C" int repro_wkv6_bwd_mma_blocks_per_sm(int which) {
  cudaError_t err = configure();
  int blocks = 0;
  if (err == cudaSuccess)
    err = which == 0
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, wkv6_bwd_walk_mma, WALK_NT, kWalkSmem)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, wkv6_bwd_grad_mma, GRAD_NT, kGradSmem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
