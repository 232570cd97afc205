// Flash attention backward for NVIDIA Hopper (sm_90a), designed for the
// card: wgmma on TMA-fed, 128-byte swizzled tiles, the row LSE taken from
// the forward, warp-specialised persistent blocks with a balanced walk.
// bf16 q, k, v, o and dO, templated on the q/k head dim DQK and the v
// width DV and instantiated at (64, 64), (128, 128), (192, 128) (MLA,
// v read at its own 128), (256, 256) and (80, 80) (hubert-xlarge;
// repro_flash_attention_bwd_sm90 refuses other pairs). Two earlier
// designs compute the same function and stay as the comparison:
// flash_attention_bwd_mma.cu (mma.sync, v as wide as q) and
// flash_attention_bwd.cu (float32 FMAs; float32 and the other shapes).
//
// The gradient of the forward kernels in this folder, which replace the
// Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:94 (the
// reference has no backward kernel: it differentiates `_plain_gqa`). The
// same masks (causal, window, q_offset), GQA, softcap, ragged edges and
// zero gradient for a fully masked row as the earlier designs, and no
// atomics, so a repeated call is bit-equal. Four kernels in stream order:
//   (a') bwd_delta_sm90, per row: D = rowsum(dO o O) in float32, and the
//        forward's LSE times log2(e), into scratch padded to 128 rows
//        (+inf and 0 past Sq, so tiles read them whole);
//   (b') bwd_dkdv_sm90, per (128 keys, query head; 64 at (256, 256)):
//        dK and dV of that head over the query tiles that see the keys,
//        float32 partials;
//   (c') bwd_reduce_sm90, per (key, KV head): the G heads' partials summed
//        in a fixed order, dK times the scale, bf16 out;
//   (d') bwd_dq_sm90, per (128 queries, head; 64 at (256, 256)): dQ over
//        the key tiles it sees.
//
// Bound on the H100. At the granite-8b training shape (B=1, S=2048, H=32,
// KV=8, hd=128, causal) the four backward products are 68.75 GFLOP, 0.0695
// ms at 989 TFLOP/s of bf16 tensor-core rate (0.025 ms for the 80 MiB of
// q, k, v, o, dO, dq, dk, dv): bound by its operations. This design does
// seven products per visible pair (S and dP twice, dV, dK, dQ): 14 hd
// operations against the bound's 8 (the mma design did 16, recomputing S
// for the LSE). What each choice does about it:
//
// * Every product is a wgmma with float32 accumulators in registers: S^T =
//   K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T from shared memory
//   (m64n64k16, both operands K-major: a [row][hd] tile), dV += P^T dO,
//   dK += dS^T Q and dQ += dS K with A from registers (the float32
//   accumulator fragment of P^T, dS^T or dS is, rounded to bf16, the A
//   fragment for 16-bit A) and B the same swizzled [row][hd] tile read
//   MN-major (trans-b). No tile is stored twice or transposed.
// * P and dS are rounded to bf16 for the products that take them (2^-9 of
//   each term; the card's gate is 2^-6 of the scale). P = exp2(S scale
//   log2e - LSE log2e): one multiply-add before ex2, no row max, since the
//   forward's LSE already normalises.
// * Blocks are persistent, one per SM: two consumer warpgroups and a
//   producer warpgroup, which gives its registers to the consumers
//   (setmaxnreg 24 / 240: a consumer of (b') holds dK and dV, 64 + 64
//   float32 at hd 128, beside S^T and dP^T, 32 + 32; with one producer
//   warp and no setmaxnreg ptxas still capped every thread at 168 and
//   spilled). The producer's one thread issues every TMA copy: the item's
//   K and V (or Q and dO) tiles once, then the streamed tiles through a
//   ring of up to 4 slots with full and empty mbarriers; the row
//   statistics ride along as 1-d bulk copies.
// * Products overlap the softmax-side arithmetic inside a warpgroup, and
//   the two warpgroups fill each other's gaps. (b'): S^T and dP^T are
//   committed apart, P^T is formed while dP^T runs, and dV's product runs
//   while dS^T is formed (under a softcap, whose derivative needs tanh of
//   S, P and dS are formed in one pass after both). (d'): the S and dP of
//   key tile t run together with the dQ product of tile t - 1, as the
//   forward overlaps its two products.
// * The walk is balanced: a (b') item is 128 keys (64 per consumer) of
//   one query head, not of a KV head, so the training shape has 16 x 32 =
//   512 items, whose causal weights (2 to 32 query tiles) are dealt to the
//   132 blocks heaviest first in a snake order (block i takes items i,
//   2n-1-i, 2n+i, ... for n blocks): 64 or 66 tile-units a block against a
//   mean of 65.9. The G heads' partials go out in float32 and (c') sums
//   them: 64 MiB written and read again, ~0.04 ms. (d') walks its 512
//   items (128 queries of one head, latest first) the same way. dQ stays a
//   kernel of its own, because fused into (b') it would need atomics.
// * The wide shapes (Shape below). Registers are what binds. At (192,
//   128) a (b') consumer would hold dK (96 a thread) and dV (64) beside
//   S^T, dP^T (32 + 32) and their bf16 fragments (16 + 16): 256 of the
//   240. So (b') takes each 64-query tile in two slices of 32 queries
//   (m64n32k16 for S^T and dP^T; the dV and dK products over 32
//   queries): 208. Shared memory there: K 2 x 24 KB and V 2 x 16 KB,
//   ring stages of Q 24 plus dO 16 KB, 3 of them. At (256, 256) dK and
//   dV alone would be 256 registers: the two consumers take the same 64
//   keys and split the columns, consumer c owning [128c, 128c + 128) of
//   dK and dV (and in (d') of dQ, over the same 64 queries). Each
//   computes S^T and dP^T over all 256 columns itself (the half of the
//   score products done twice, no exchange through shared memory):
//   224 registers, as at hd 128. One K and one V tile of 32 KB, ring
//   stages of 64 KB, 2 of them. This also doubles the items: gemma3's
//   training shape (B=1, H=4, S=2048) has 128 of them for 132 SMs.
//   ptxas: (b') spills 164 bytes a thread at (192, 128), 40 at (80, 80)
//   and 36 at (128, 128); (b') at (256, 256), (d') and (a'), (c') at
//   every shape none.
// * hd 80 (no multiple of 64): every tile is five boxes of 16 columns in
//   32-byte swizzle (box_cols in sm90_ptx.cuh), one layout over all 80
//   columns. The score products take 5 k-steps, one a box; dV, dK and dQ
//   are one m64n80k16 a k-step, whose MN-major descriptor steps from box
//   to box by its lbo. Nothing is padded: the float32 partials and dQ
//   are stored at the real width 80. A (b') consumer holds dK and dV (40
//   + 40 a thread) beside S^T, dP^T (32 + 32): 64-query slices, one
//   consumer a tile, as at hd 64 and 128. (a') gives a row 16 lanes, 10
//   of which read its 80 columns.
// * Tiles wholly outside the causal cone or the window are never loaded;
//   a consumer waits for and releases the tiles none of its rows sees.
//   Per-element masks run only on tiles that cross the diagonal or the
//   window's edge. Rows past Sq read zeros through TMA's out-of-bounds
//   fill and get P = 0 from the padded LSE; keys past Sk are zeros too
//   and masked in (d'), and their dK, dV rows are not stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_ptx.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;                // rows of a tile: a consumer's share
constexpr int NCW = 2;                // consumer warpgroups
constexpr int NT = 128 * (NCW + 1);   // and a producer warpgroup, the last
constexpr int PRODUCER_WARP = 4 * NCW;    // its first warp
// registers a thread of the producer gives up and a consumer takes
// (setmaxnreg): 128 x (2 x 240 + 24) = 64,512 of the SM's 65,536
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int MAX_STAGES = 4;
constexpr int PAD = 128;              // row padding of the statistics
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  int B, H, KV, Sq, Sk, G;
  int sq_pad;                   // rows of lse2 / delta per (b, h)
  int n_kv_work;                // (b') items
  int n_qt, n_q_work;           // (d') query tiles per (b, h); items
  float scale;
  float scale_log2;             // scale * log2(e)
  float softcap;                // <= 0: none
  float cap_in;                 // scale / softcap
  float cap_log2;               // softcap * log2(e)
  int causal;
  int window;                   // <= 0: none
  int q_offset;
  const float* lse2;            // (B, H, sq_pad): LSE log2(e), +inf past Sq
  const float* delta;           // (B, H, sq_pad): rowsum(dO o O), 0 past Sq
  float* dkp;                   // (B, H, Sk, DQK) float32 partials
  float* dvp;                   // (B, H, Sk, DV)
  bf16* dq;
  long long dq_sb, dq_ss, dq_sh;
};

// A tile's boxes of EB columns (sm90_ptx.cuh: box_cols): rows of RB
// bytes, KPB k16-steps a box, TILE bytes a 64-row box.
template <int EB>
struct Box {
  static constexpr int RB = 2 * EB;
  static constexpr int KPB = EB / 16;
  static constexpr uint32_t TILE = BM * RB;
  static constexpr uint32_t SBO = 8 * RB;             // the next 8 rows
  static constexpr uint64_t CODE = swizzle_code(EB);
};

// How a (DQK, DV) pair is cut (see the header): CS consumers share one
// 64-row tile and split the gradient's columns (2 at (256, 256), else
// 1: each consumer its own 64 rows), and (b') takes its query tiles in
// slices of QS queries (32 at (192, 128), else 64).
template <int DQK, int DV>
struct Shape {
  static constexpr int CS = DQK + DV > 384 ? 2 : 1;
  static constexpr int QS = CS == 1 && DQK + DV > 256 ? 32 : 64;
  static constexpr int ROWS = NCW * BM / CS;   // keys / queries an item
  static constexpr int TILES = NCW / CS;       // its 64-row tiles
  static constexpr int EB = box_cols(DQK, DV);
  using X = Box<EB>;
  static_assert(DQK % (EB * CS) == 0 && DV % (EB * CS) == 0,
                "every consumer's columns in whole boxes");
  static constexpr int KBOX = DQK / EB, VBOX = DV / EB;
  static constexpr uint32_t TILE_QK = KBOX * X::TILE;   // 64 rows x DQK
  static constexpr uint32_t TILE_V = VBOX * X::TILE;    // 64 rows x DV
  // columns of dK or dQ, and of dV, one consumer owns
  static constexpr int CQK = DQK / CS, CV = DV / CS;
};

// (b'): the item's K tiles, its V tiles, then the ring of (Q, dO) slots,
// the slots' statistics (lse2 and delta, 64 floats each) and the barriers.
template <int DQK, int DV>
struct KVLayout {
  using S = Shape<DQK, DV>;
  static constexpr uint32_t V_OFF = S::TILES * S::TILE_QK;
  static constexpr uint32_t RING_OFF = V_OFF + S::TILES * S::TILE_V;
  static constexpr uint32_t STAGE = S::TILE_QK + S::TILE_V;   // Q, dO
  static constexpr uint32_t STAT = 2 * BM * 4;
  static constexpr int FIT = (227 * 1024 - RING_OFF - 4096) / (STAGE + STAT);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr uint32_t STAT_OFF = RING_OFF + STAGES * STAGE;
  static constexpr uint32_t BAR_OFF = STAT_OFF + STAGES * STAT;
  // kv full / empty, then full [STAGES], empty [STAGES]; 1024 to align
  static constexpr size_t SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;
};

// (d'): the item's Q tiles, its dO tiles, the ring of (K, V) slots, the
// items' statistics (lse2 and delta, room for 128 rows each) and the
// barriers.
template <int DQK, int DV>
struct QLayout {
  using S = Shape<DQK, DV>;
  static constexpr uint32_t DO_OFF = S::TILES * S::TILE_QK;
  static constexpr uint32_t RING_OFF = DO_OFF + S::TILES * S::TILE_V;
  static constexpr uint32_t STAGE = S::TILE_QK + S::TILE_V;   // K, V
  static constexpr uint32_t STAT = 2 * NCW * BM * 4;
  static constexpr int FIT =
      (227 * 1024 - RING_OFF - STAT - 4096) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr uint32_t STAT_OFF = RING_OFF + STAGES * STAGE;
  static constexpr uint32_t BAR_OFF = STAT_OFF + STAT;
  // q full / empty, then full [STAGES], empty [STAGES]; 1024 to align
  static constexpr size_t SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Item `w` of the n-th round of a block: a snake over the items sorted
// heaviest first, so that each block's rounds even out.
__device__ __forceinline__ int item_of(int round) {
  return round * gridDim.x +
         ((round & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// A position in a ring: slot and the parity of its current round.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int STAGES>
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// (b') item: ROWS keys of one (batch, head), early key tiles (the heaviest
// under a causal mask) first, and the 64-query tiles that see them.
struct KVItem {
  int b, h, k0, qt0, n_tiles;
};

// Queries that may see keys [k_lo, k_hi] (k_hi >= k_lo): [begin, end).
__device__ __forceinline__ void query_range(const Params& p, int k_lo,
                                            int k_hi, int& begin, int& end) {
  begin = p.causal ? max(0, k_lo - p.q_offset) : 0;
  end = p.Sq;
  if (p.window > 0) end = min(end, k_hi + p.window - p.q_offset);
}

template <int DQK, int DV>
__device__ __forceinline__ KVItem kv_item(const Params& p, int w) {
  constexpr int ROWS = Shape<DQK, DV>::ROWS;
  KVItem it;
  const int bh = p.B * p.H;
  it.k0 = (w / bh) * ROWS;
  it.b = (w % bh) / p.H;
  it.h = w % p.H;
  int begin, end;
  query_range(p, it.k0, min(it.k0 + ROWS, p.Sk) - 1, begin, end);
  it.qt0 = begin - begin % BM;
  it.n_tiles = end > it.qt0 ? (end - it.qt0 + BM - 1) / BM : 0;
  return it;
}

// (d') item: ROWS queries of one (batch, head), last query tiles first,
// and the 64-key tiles they see.
struct QItem {
  int b, h, q0, kt0, n_tiles;
};

// Keys that rows [r0, r1) may see (r1 > r0): [begin, end).
__device__ __forceinline__ void key_range(const Params& p, int r0, int r1,
                                          int& begin, int& end) {
  end = p.Sk;
  if (p.causal) end = min(end, p.q_offset + r1);
  begin = 0;
  if (p.window > 0) begin = max(0, p.q_offset + r0 - p.window + 1);
}

template <int DQK, int DV>
__device__ __forceinline__ QItem q_item(const Params& p, int w) {
  constexpr int ROWS = Shape<DQK, DV>::ROWS;
  QItem it;
  const int bh = p.B * p.H;
  it.q0 = (p.n_qt - 1 - w / bh) * ROWS;
  it.b = (w % bh) / p.H;
  it.h = w % p.H;
  int begin, end;
  key_range(p, it.q0, min(it.q0 + ROWS, p.Sq), begin, end);
  it.kt0 = begin - begin % BM;
  it.n_tiles = end > it.kt0 ? (end - it.kt0 + BM - 1) / BM : 0;
  return it;
}

// [t_lo, t_hi): the tiles, among an item's n tiles from `first`, that
// the range [begin, end) reaches.
__device__ __forceinline__ void own_tiles(int first, int n, int begin,
                                          int end, int& t_lo, int& t_hi) {
  t_lo = 0;
  t_hi = 0;
  if (end > begin) {
    t_lo = max(0, (begin - first) / BM);
    t_hi = min(n, (end - first + BM - 1) / BM);
  }
}

__device__ __forceinline__ bool visible(const Params& p, int q, int k) {
  const int qpos = p.q_offset + q;
  bool ok = k < p.Sk;
  if (p.causal) ok = ok && k <= qpos;
  if (p.window > 0) ok = ok && k > qpos - p.window;
  return ok;
}

// A 64 x N product (N 64 or 32) of two [row][d] tiles over D columns in
// boxes of EB, both K-major: D / 16 k-steps of 32 bytes, 4 per 128-byte
// box or 1 per 32-byte box. C = A B^T; b may start at any multiple of 8
// rows of its tile.
template <int D, int N, int EB>
__device__ __forceinline__ void issue_ss(float (&c)[N / 2], uint32_t a,
                                         uint32_t b) {
  using X = Box<EB>;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint32_t off = (k / X::KPB) * X::TILE + (k % X::KPB) * 32;
    if constexpr (N == 64)
      wgmma_ss_m64n64k16(c, make_desc(a + off, 16, X::SBO, X::CODE),
                         make_desc(b + off, 16, X::SBO, X::CODE), k > 0);
    else
      wgmma_ss_m64n32k16(c, make_desc(a + off, 16, X::SBO, X::CODE),
                         make_desc(b + off, 16, X::SBO, X::CODE), k > 0);
  }
}

// C[64 x N] += A[64 x 16 KS] T, A from registers (KS k-steps of 16 rows
// of T), T N columns of a [row][d] tile in boxes of EB read MN-major: 16
// rows of the box per k-step, the next box (64 or 16 columns) lbo
// further. At N 192 two products, n128 into c[0, 64) and n64 into c[64,
// 96): the accumulator fragment of columns [128, 192) starts at register
// 64.
template <int N, int KS, int EB>
__device__ __forceinline__ void issue_rs(float (&c)[N / 2],
                                         const uint32_t (&a)[KS][4],
                                         uint32_t t) {
  using X = Box<EB>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t desc =
        make_desc(t + kk * 16 * X::RB, X::TILE, X::SBO, X::CODE);
    if constexpr (N == 64) {
      wgmma_rs_m64n64k16(c, a[kk], desc);
    } else if constexpr (N == 80) {
      wgmma_rs_m64n80k16(c, a[kk], desc);
    } else if constexpr (N == 128) {
      wgmma_rs_m64n128k16(c, a[kk], desc);
    } else {
      static_assert(N == 192, "issue_rs: N is 64, 80, 128 or 192");
      float(&c0)[64] = *reinterpret_cast<float(*)[64]>(&c[0]);
      float(&c1)[32] = *reinterpret_cast<float(*)[32]>(&c[64]);
      wgmma_rs_m64n128k16(c0, a[kk], desc);
      wgmma_rs_m64n64k16(c1, a[kk],
                         make_desc(t + 2 * X::TILE + kk * 16 * X::RB,
                                   X::TILE, X::SBO, X::CODE));
    }
  }
}

// The float32 accumulator fragment of a 64 x N tile as bf16 A fragments,
// one per 16 columns.
template <int N>
__device__ __forceinline__ void to_a(const float (&x)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// P and dS (the softcap's derivative included, the scale not) of one
// 64 x N tile in place: s holds the scores' dot products, dp the dP
// values. Element i of this thread sits at row ra + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 tq + (i % 2) of the tile. `lse2`, `delta` give the
// statistics of a query: by column (KEYS_ROWS, kernel (b')) or by row.
template <int N, bool KEYS_ROWS, bool MASK>
__device__ __forceinline__ void probs(const Params& p, float (&s)[N / 2],
                                      float (&dp)[N / 2], const float* lse2,
                                      const float* delta, int row0, int col0,
                                      int ra, int tq) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = ra + 8 * ((i / 2) % 2);
    const int c = 8 * (i / 4) + 2 * tq + (i % 2);
    const int qi = KEYS_ROWS ? c : r;
    const float l2 = lse2[qi], dl = delta[qi];
    float y, dcap = 1.f;
    if (p.softcap > 0.f) {
      const float t = tanhf(s[i] * p.cap_in);
      y = fmaf(t, p.cap_log2, -l2);
      dcap = 1.f - t * t;
    } else {
      y = fmaf(s[i], p.scale_log2, -l2);
    }
    float pr = fast_exp2(y);
    if (MASK) {
      const int q = KEYS_ROWS ? col0 + c : row0 + r;
      const int k = KEYS_ROWS ? row0 + r : col0 + c;
      if (!visible(p, q, k)) pr = 0.f;
    }
    s[i] = pr;
    dp[i] = pr * (dp[i] - dl) * dcap;
  }
}

// (b') without a softcap, in two steps, so that dV's product runs while
// dS is formed: P^T in place of S^T (keys are rows, queries columns) ...
template <int N, bool MASK>
__device__ __forceinline__ void probs_t(const Params& p, float (&s)[N / 2],
                                        const float* lse2, int k0, int q0,
                                        int ra, int tq) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = ra + 8 * ((i / 2) % 2);
    const int c = 8 * (i / 4) + 2 * tq + (i % 2);
    float pr = fast_exp2(fmaf(s[i], p.scale_log2, -lse2[c]));
    if (MASK && !visible(p, q0 + c, k0 + r)) pr = 0.f;
    s[i] = pr;
  }
}

// ... then dS^T = P^T o (dP^T - D) in place of dP^T.
template <int N>
__device__ __forceinline__ void dscores_t(const float (&s)[N / 2],
                                          float (&dp)[N / 2],
                                          const float* delta, int tq) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    dp[i] = s[i] * (dp[i] - delta[8 * (i / 4) + 2 * tq + (i % 2)]);
}

// ---------------------------------------------------------------- (a')
// Lanes a row: D / 8 (16 bytes a lane; D is v's width) rounded up to a
// power of two, so that a row's lanes sit in one warp and sum by
// shuffles; the lanes past D / 8 (6 of 16 at D 80) read nothing.
__host__ __device__ constexpr int delta_lanes(int d) {
  int n = 1;
  while (n < d / 8) n *= 2;
  return n;
}

template <int D>
__global__ void __launch_bounds__(256)
    bwd_delta_sm90(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ lse2,
                   float* __restrict__ delta, int B, int H, int Sq,
                   int sq_pad, long long o_sb, long long o_ss, long long o_sh,
                   long long do_sb, long long do_ss, long long do_sh) {
  constexpr int LPR = delta_lanes(D);
  const long long row =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / LPR;
  const int j = threadIdx.x % LPR;
  const long long rows = static_cast<long long>(B) * H * sq_pad;
  const int q = static_cast<int>(row % sq_pad);
  const int bh = static_cast<int>(row / sq_pad);
  const int b = bh / H, h = bh % H;
  float dot = 0.f;
  if (row < rows && q < Sq && 8 * j < D) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * o_sb + q * o_ss + h * o_sh + 8 * j);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * do_sb + q * do_ss + h * do_sh + 8 * j);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(o2[e]);
      const float2 c = __bfloat1622float2(g2[e]);
      dot = fmaf(a.x, c.x, dot);
      dot = fmaf(a.y, c.y, dot);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (row < rows && j == 0) {
    delta[row] = q < Sq ? dot : 0.f;
    lse2[row] = q < Sq ? lse[static_cast<long long>(bh) * Sq + q] * LOG2E
                       : __int_as_float(0x7f800000);
  }
}

// ---------------------------------------------------------------- (b')
template <int DQK, int DV>
__global__ void __launch_bounds__(NT, 1)
    bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using L = KVLayout<DQK, DV>;
  using S = Shape<DQK, DV>;
  using X = typename S::X;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + L::STAT_OFF);
  const uint32_t kv_full = base + L::BAR_OFF;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8;                   // [STAGES]
  const uint32_t empty = full + 8 * L::STAGES;          // [STAGES]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4 * NCW);      // one arrival per consumer warp
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NCW);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {
    // ---- producer: one thread issues every copy ---------------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == PRODUCER_WARP && lane == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      prefetch_tensormap(&tm_do);
      Ring ring;
      for (int n = 0;; ++n) {
        const int w = item_of(n);
        if (w >= p.n_kv_work) break;
        const KVItem it = kv_item<DQK, DV>(p, w);
        const int kvh = it.h / p.G;
        // the second consumer's keys, unless they all lie past Sk
        const int nk = S::TILES == 2 && it.k0 + BM < p.Sk ? 2 : 1;
        mbar_wait(kv_empty, (n & 1) ^ 1);
        mbar_arrive_expect_tx(kv_full, nk * (S::TILE_QK + S::TILE_V));
        for (int c = 0; c < nk; ++c) {
          for (int x = 0; x < S::KBOX; ++x)
            tma_load_4d(base + c * S::TILE_QK + x * X::TILE, &tm_k, kv_full,
                        x * S::EB, it.k0 + c * BM, kvh, it.b);
          for (int x = 0; x < S::VBOX; ++x)
            tma_load_4d(base + L::V_OFF + c * S::TILE_V + x * X::TILE,
                        &tm_v, kv_full, x * S::EB, it.k0 + c * BM, kvh, it.b);
        }
        const long long srow =
            (static_cast<long long>(it.b) * p.H + it.h) * p.sq_pad;
        for (int t = 0; t < it.n_tiles; ++t) {
          const int q0 = it.qt0 + t * BM;
          mbar_wait(empty + 8 * ring.stage, ring.phase ^ 1);
          const uint32_t bar = full + 8 * ring.stage;
          mbar_arrive_expect_tx(bar, L::STAGE + L::STAT);
          const uint32_t sQ = base + L::RING_OFF + ring.stage * L::STAGE;
          for (int x = 0; x < S::KBOX; ++x)
            tma_load_4d(sQ + x * X::TILE, &tm_q, bar, x * S::EB, q0, it.h,
                        it.b);
          for (int x = 0; x < S::VBOX; ++x)
            tma_load_4d(sQ + S::TILE_QK + x * X::TILE, &tm_do, bar,
                        x * S::EB, q0, it.h, it.b);
          const uint32_t st = base + L::STAT_OFF + ring.stage * L::STAT;
          bulk_load(st, p.lse2 + srow + q0, BM * 4, bar);
          bulk_load(st + BM * 4, p.delta + srow + q0, BM * 4, bar);
          ring.next<L::STAGES>();
        }
      }
    }
    return;
  }

  // ---- consumers: 64 keys each (the same 64 under a column split) ----------
  setmaxnreg_inc<CONSUMER_REGS>();
  constexpr int QS = S::QS;
  const int wg = warp / 4;
  const int tid = threadIdx.x - 128 * wg;
  const int g = lane / 4, tq = lane % 4;
  const int ra = (tid / 32) * 16 + g;   // this thread's rows: ra, ra + 8
  const int own = S::CS == 1 ? wg : 0;  // which of the item's 64-row tiles
  const uint32_t sK = base + own * S::TILE_QK;
  const uint32_t sV = base + L::V_OFF + own * S::TILE_V;
  // this consumer's columns of dK and dV: their first box, first column
  const int kbox = S::CS == 1 ? 0 : wg * (S::CQK / S::EB);
  const int vbox = S::CS == 1 ? 0 : wg * (S::CV / S::EB);
  Ring ring;
  for (int n = 0;; ++n) {
    const int w = item_of(n);
    if (w >= p.n_kv_work) break;
    const KVItem it = kv_item<DQK, DV>(p, w);
    const int kc0 = it.k0 + own * BM;   // this consumer's first key
    int t_lo = 0, t_hi = 0;
    if (kc0 < p.Sk) {
      int begin, end;
      query_range(p, kc0, min(kc0 + BM, p.Sk) - 1, begin, end);
      own_tiles(it.qt0, it.n_tiles, begin, end, t_lo, t_hi);
    }
    float dk[S::CQK / 2], dv[S::CV / 2];
#pragma unroll
    for (int i = 0; i < S::CQK / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < S::CV / 2; ++i) dv[i] = 0.f;
    mbar_wait(kv_full, n & 1);
    for (int t = 0; t < it.n_tiles; ++t) {
      mbar_wait(full + 8 * ring.stage, ring.phase);
      if (t >= t_lo && t < t_hi) {
        const int q0 = it.qt0 + t * BM;
        const uint32_t sQ = base + L::RING_OFF + ring.stage * L::STAGE;
        const uint32_t sG = sQ + S::TILE_QK;
        const float* st = stats + ring.stage * (L::STAT / 4);
        // a tile crosses the diagonal or the window's edge for some pair
        const bool mask =
            (p.causal && kc0 + BM - 1 > p.q_offset + q0) ||
            (p.window > 0 && kc0 <= p.q_offset + q0 + BM - 1 - p.window);
        // the tile's queries in slices of QS (one slice but at (192, 128))
#pragma unroll
        for (int h = 0; h < BM / QS; ++h) {
          const uint32_t qoff = h * QS * X::RB;  // the slice's first row
          const int qh = q0 + h * QS;
          const float* sl = st + h * QS;        // its lse2; delta at + BM
          const uint32_t sQh = sQ + qoff, sGh = sG + qoff;
          float s[QS / 2], dp[QS / 2];
          uint32_t pa[QS / 16][4], da[QS / 16][4];
          wgmma_fence();
          issue_ss<DQK, QS, S::EB>(s, sK, sQh);   // S^T = K Q^T
          wgmma_commit();
          issue_ss<DV, QS, S::EB>(dp, sV, sGh);   // dP^T = V dO^T
          wgmma_commit();
          if (p.softcap > 0.f) {
            // the softcap's derivative needs tanh of S: P and dS in one
            // pass
            wgmma_wait<0>();
            fence_regs(s);
            fence_regs(dp);
            if (mask)
              probs<QS, true, true>(p, s, dp, sl, sl + BM, kc0, qh, ra, tq);
            else
              probs<QS, true, false>(p, s, dp, sl, sl + BM, kc0, qh, ra, tq);
            to_a<QS>(s, pa);
            to_a<QS>(dp, da);
            fence_regs(dv);
            fence_regs(dk);
            fence_regs(pa);
            fence_regs(da);
            wgmma_fence();
            issue_rs<S::CV, QS / 16, S::EB>(dv, pa, sGh + vbox * X::TILE);
            issue_rs<S::CQK, QS / 16, S::EB>(dk, da, sQh + kbox * X::TILE);
            wgmma_commit();                     // dV += P^T dO, dK += dS^T Q
          } else {
            // P^T while dP^T runs; then dS^T while dV's product runs
            wgmma_wait<1>();
            fence_regs(s);
            if (mask)
              probs_t<QS, true>(p, s, sl, kc0, qh, ra, tq);
            else
              probs_t<QS, false>(p, s, sl, kc0, qh, ra, tq);
            to_a<QS>(s, pa);
            fence_regs(dv);
            fence_regs(pa);
            wgmma_fence();
            issue_rs<S::CV, QS / 16, S::EB>(dv, pa, sGh + vbox * X::TILE);
            wgmma_commit();                     // dV += P^T dO
            wgmma_wait<1>();
            fence_regs(dp);
            dscores_t<QS>(s, dp, sl + BM, tq);
            to_a<QS>(dp, da);
            fence_regs(dk);
            fence_regs(da);
            wgmma_fence();
            issue_rs<S::CQK, QS / 16, S::EB>(dk, da, sQh + kbox * X::TILE);
            wgmma_commit();                     // dK += dS^T Q
          }
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pa);
          fence_regs(da);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ring.stage);
      ring.next<L::STAGES>();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty);
    // this head's partials, float32, rows past Sk not stored
    const long long prow = (static_cast<long long>(it.b) * p.H + it.h) * p.Sk;
#pragma unroll
    for (int i = 0; i < S::CQK / 2; i += 2) {
      const int k = kc0 + ra + 8 * ((i / 2) % 2);
      const int c = kbox * S::EB + 8 * (i / 4) + 2 * tq;
      if (k < p.Sk)
        *reinterpret_cast<float2*>(p.dkp + (prow + k) * DQK + c) =
            make_float2(dk[i], dk[i + 1]);
    }
#pragma unroll
    for (int i = 0; i < S::CV / 2; i += 2) {
      const int k = kc0 + ra + 8 * ((i / 2) % 2);
      const int c = vbox * S::EB + 8 * (i / 4) + 2 * tq;
      if (k < p.Sk)
        *reinterpret_cast<float2*>(p.dvp + (prow + k) * DV + c) =
            make_float2(dv[i], dv[i + 1]);
    }
  }
}

// ---------------------------------------------------------------- (c')
// dK = scale x sum over the G heads of a KV head, dV the same unscaled,
// four columns a thread (of dK's DQK, dV's DV), the heads in order.
template <int DQK, int DV>
__global__ void __launch_bounds__(256)
    bwd_reduce_sm90(const float* __restrict__ dkp,
                    const float* __restrict__ dvp, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int B, int H, int KV, int Sk,
                    long long dk_sb, long long dk_ss, long long dk_sh,
                    long long dv_sb, long long dv_ss, long long dv_sh,
                    float scale) {
  constexpr int W = (DQK > DV ? DQK : DV) / 4;   // threads per (key, head)
  const long long i =
      static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long n = static_cast<long long>(B) * Sk * KV * W;
  if (i >= n) return;
  const int c = static_cast<int>(i % W) * 4;
  const int kvh = static_cast<int>((i / W) % KV);
  const long long bs = i / W / KV;
  const int s = static_cast<int>(bs % Sk), b = static_cast<int>(bs / Sk);
  const int G = H / KV;
  float4 ak = make_float4(0.f, 0.f, 0.f, 0.f), av = ak;
  for (int gi = 0; gi < G; ++gi) {
    const long long row =
        (static_cast<long long>(b) * H + kvh * G + gi) * Sk + s;
    if (c < DQK) {
      const float4 x = *reinterpret_cast<const float4*>(dkp + row * DQK + c);
      ak.x += x.x; ak.y += x.y; ak.z += x.z; ak.w += x.w;
    }
    if (c < DV) {
      const float4 y = *reinterpret_cast<const float4*>(dvp + row * DV + c);
      av.x += y.x; av.y += y.y; av.z += y.z; av.w += y.w;
    }
  }
  if (c < DQK) {
    uint2 ok;
    ok.x = pack_bf16(ak.x * scale, ak.y * scale);
    ok.y = pack_bf16(ak.z * scale, ak.w * scale);
    *reinterpret_cast<uint2*>(dk + b * dk_sb + s * dk_ss + kvh * dk_sh + c) =
        ok;
  }
  if (c < DV) {
    uint2 ov;
    ov.x = pack_bf16(av.x, av.y);
    ov.y = pack_bf16(av.z, av.w);
    *reinterpret_cast<uint2*>(dv + b * dv_sb + s * dv_ss + kvh * dv_sh + c) =
        ov;
  }
}

// ---------------------------------------------------------------- (d')
template <int DQK, int DV>
__global__ void __launch_bounds__(NT, 1)
    bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using L = QLayout<DQK, DV>;
  using S = Shape<DQK, DV>;
  using X = typename S::X;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + L::STAT_OFF);
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full = q_empty + 8;                    // [STAGES]
  const uint32_t empty = full + 8 * L::STAGES;          // [STAGES]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * NCW);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NCW);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == PRODUCER_WARP && lane == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      prefetch_tensormap(&tm_do);
      Ring ring;
      for (int n = 0;; ++n) {
        const int w = item_of(n);
        if (w >= p.n_q_work) break;
        const QItem it = q_item<DQK, DV>(p, w);
        const int kvh = it.h / p.G;
        const int nq = S::TILES == 2 && it.q0 + BM < p.Sq ? 2 : 1;
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_arrive_expect_tx(q_full,
                              nq * (S::TILE_QK + S::TILE_V) + 2 * S::ROWS * 4);
        for (int c = 0; c < nq; ++c) {
          for (int x = 0; x < S::KBOX; ++x)
            tma_load_4d(base + c * S::TILE_QK + x * X::TILE, &tm_q, q_full,
                        x * S::EB, it.q0 + c * BM, it.h, it.b);
          for (int x = 0; x < S::VBOX; ++x)
            tma_load_4d(base + L::DO_OFF + c * S::TILE_V + x * X::TILE,
                        &tm_do, q_full, x * S::EB, it.q0 + c * BM, it.h,
                        it.b);
        }
        const long long srow =
            (static_cast<long long>(it.b) * p.H + it.h) * p.sq_pad + it.q0;
        const uint32_t st = base + L::STAT_OFF;
        bulk_load(st, p.lse2 + srow, S::ROWS * 4, q_full);
        bulk_load(st + NCW * BM * 4, p.delta + srow, S::ROWS * 4, q_full);
        for (int t = 0; t < it.n_tiles; ++t) {
          const int kt = it.kt0 + t * BM;
          mbar_wait(empty + 8 * ring.stage, ring.phase ^ 1);
          const uint32_t bar = full + 8 * ring.stage;
          mbar_arrive_expect_tx(bar, L::STAGE);
          const uint32_t sK = base + L::RING_OFF + ring.stage * L::STAGE;
          for (int x = 0; x < S::KBOX; ++x)
            tma_load_4d(sK + x * X::TILE, &tm_k, bar, x * S::EB, kt, kvh,
                        it.b);
          for (int x = 0; x < S::VBOX; ++x)
            tma_load_4d(sK + S::TILE_QK + x * X::TILE, &tm_v, bar,
                        x * S::EB, kt, kvh, it.b);
          ring.next<L::STAGES>();
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each (the same 64 under a column split) ---
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int tid = threadIdx.x - 128 * wg;
  const int g = lane / 4, tq = lane % 4;
  const int ra = (tid / 32) * 16 + g;
  const int own = S::CS == 1 ? wg : 0;  // which of the item's 64-row tiles
  const uint32_t sQ = base + own * S::TILE_QK;
  const uint32_t sG = base + L::DO_OFF + own * S::TILE_V;
  const float* st_lse = stats + own * BM;
  const float* st_delta = stats + NCW * BM + own * BM;
  // this consumer's columns of dQ: their first box
  const int qbox = S::CS == 1 ? 0 : wg * (S::CQK / S::EB);
  Ring ring;
  for (int n = 0;; ++n) {
    const int w = item_of(n);
    if (w >= p.n_q_work) break;
    const QItem it = q_item<DQK, DV>(p, w);
    const int w0 = it.q0 + own * BM;    // this consumer's first row
    int t_lo = 0, t_hi = 0;
    if (w0 < p.Sq) {
      int begin, end;
      key_range(p, w0, min(w0 + BM, p.Sq), begin, end);
      own_tiles(it.kt0, it.n_tiles, begin, end, t_lo, t_hi);
    }
    float dq[S::CQK / 2];
#pragma unroll
    for (int i = 0; i < S::CQK / 2; ++i) dq[i] = 0.f;
    // keys past Sk read as zeros, which add nothing to dQ, but their
    // P = exp2(-lse2) could overflow: masked too
    auto dscores = [&](float (&s)[32], float (&dp)[32], int kt) {
      if (kt + BM > p.Sk || (p.causal && kt + BM - 1 > p.q_offset + w0) ||
          (p.window > 0 && kt <= p.q_offset + w0 + BM - 1 - p.window))
        probs<64, false, true>(p, s, dp, st_lse, st_delta, w0, kt, ra, tq);
      else
        probs<64, false, false>(p, s, dp, st_lse, st_delta, w0, kt, ra, tq);
    };
    auto release = [&](const Ring& r) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * r.stage);
    };
    auto skip = [&]() {
      mbar_wait(full + 8 * ring.stage, ring.phase);
      release(ring);
      ring.next<L::STAGES>();
    };
    mbar_wait(q_full, n & 1);
    for (int t = 0; t < t_lo; ++t) skip();
    if (t_hi > t_lo) {
      // Tile t_lo: S, dP, dS. Then for each next tile: its S and dP and
      // the dQ product of the tile before run on the tensor cores while
      // this warpgroup's dS of the new tile waits only for S and dP.
      float s[32], dp[32];
      uint32_t da[4][4];
      Ring prev = ring;
      mbar_wait(full + 8 * ring.stage, ring.phase);
      uint32_t sK = base + L::RING_OFF + ring.stage * L::STAGE;
      wgmma_fence();
      issue_ss<DQK, 64, S::EB>(s, sQ, sK);                // S = Q K^T
      issue_ss<DV, 64, S::EB>(dp, sG, sK + S::TILE_QK);   // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dscores(s, dp, it.kt0 + t_lo * BM);
      to_a<64>(dp, da);
      ring.next<L::STAGES>();
      for (int t = t_lo + 1; t < t_hi; ++t) {
        mbar_wait(full + 8 * ring.stage, ring.phase);
        sK = base + L::RING_OFF + ring.stage * L::STAGE;
        fence_regs(dq);
        fence_regs(da);
        wgmma_fence();
        issue_ss<DQK, 64, S::EB>(s, sQ, sK);
        issue_ss<DV, 64, S::EB>(dp, sG, sK + S::TILE_QK);
        wgmma_commit();
        issue_rs<S::CQK, 4, S::EB>(dq, da, base + L::RING_OFF +
                                               prev.stage * L::STAGE +
                                               qbox * X::TILE);
        wgmma_commit();                   // dQ += dS K of the tile before
        wgmma_wait<1>();                  // S and dP done, dQ may run on
        fence_regs(s);
        fence_regs(dp);
        dscores(s, dp, it.kt0 + t * BM);
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(da);
        release(prev);
        to_a<64>(dp, da);
        prev = ring;
        ring.next<L::STAGES>();
      }
      fence_regs(dq);
      fence_regs(da);
      wgmma_fence();
      issue_rs<S::CQK, 4, S::EB>(dq, da, base + L::RING_OFF +
                                             prev.stage * L::STAGE +
                                             qbox * X::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      release(prev);
    }
    for (int t = max(t_hi, t_lo); t < it.n_tiles; ++t) skip();
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);
    bf16* out = p.dq + it.b * p.dq_sb + it.h * p.dq_sh;
#pragma unroll
    for (int i = 0; i < S::CQK / 2; i += 2) {
      const int r = w0 + ra + 8 * ((i / 2) % 2);
      const int c = qbox * S::EB + 8 * (i / 4) + 2 * tq;
      if (r < p.Sq)
        *reinterpret_cast<uint32_t*>(out + r * p.dq_ss + c) =
            pack_bf16(dq[i] * p.scale, dq[i + 1] * p.scale);
    }
  }
}

template <typename Kernel>
cudaError_t launch_persistent(Kernel kernel, size_t smem, int n_work,
                              const CUtensorMap& tq, const CUtensorMap& tk,
                              const CUtensorMap& tv, const CUtensorMap& tdo,
                              const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  kernel<<<sms < n_work ? sms : n_work, NT, smem, stream>>>(tq, tk, tv, tdo,
                                                           p);
  return cudaGetLastError();
}

// The shape's item counts go into p here: items are Shape::ROWS keys in
// (b') and ROWS queries in (d').
template <int DQK, int DV>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& tdo,
                   Params p, const bf16* o, const bf16* dout,
                   const float* lse, float* lse2, float* delta,
                   long long o_sb, long long o_ss, long long o_sh,
                   long long do_sb, long long do_ss, long long do_sh,
                   bf16* dk, bf16* dv, long long dk_sb, long long dk_ss,
                   long long dk_sh, long long dv_sb, long long dv_ss,
                   long long dv_sh, cudaStream_t stream) {
  static_assert(KVLayout<DQK, DV>::SMEM <= 227 * 1024 &&
                    QLayout<DQK, DV>::SMEM <= 227 * 1024,
                "shared memory over 227 KB");
  static_assert(KVLayout<DQK, DV>::STAGES >= 2 &&
                    QLayout<DQK, DV>::STAGES >= 2,
                "fewer than two ring slots");
  constexpr int ROWS = Shape<DQK, DV>::ROWS;
  p.n_kv_work = p.B * p.H * ((p.Sk + ROWS - 1) / ROWS);
  p.n_qt = (p.Sq + ROWS - 1) / ROWS;
  p.n_q_work = p.B * p.H * p.n_qt;
  const long long rows = static_cast<long long>(p.B) * p.H * p.sq_pad;
  const long long delta_blocks = (rows * delta_lanes(DV) + 255) / 256;
  bwd_delta_sm90<DV><<<static_cast<unsigned>(delta_blocks), 256, 0, stream>>>(
      o, dout, lse, lse2, delta, p.B, p.H, p.Sq, p.sq_pad, o_sb, o_ss, o_sh,
      do_sb, do_ss, do_sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.n_kv_work > 0) {
    err = launch_persistent(bwd_dkdv_sm90<DQK, DV>, KVLayout<DQK, DV>::SMEM,
                            p.n_kv_work, tq, tk, tv, tdo, p, stream);
    if (err != cudaSuccess) return err;
    const long long n = static_cast<long long>(p.B) * p.Sk * p.KV *
                        ((DQK > DV ? DQK : DV) / 4);
    bwd_reduce_sm90<DQK, DV><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                               stream>>>(p.dkp, p.dvp, dk, dv, p.B, p.H, p.KV,
                                         p.Sk, dk_sb, dk_ss, dk_sh, dv_sb,
                                         dv_ss, dv_sh, p.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_persistent(bwd_dq_sm90<DQK, DV>, QLayout<DQK, DV>::SMEM,
                           p.n_q_work, tq, tk, tv, tdo, p, stream);
}

}  // namespace

// bf16 q, dq: (B, Sq, H, D); o, dout: (B, Sq, H, DV); k, dk: (B, Sk, KV,
// D); v, dv: (B, Sk, KV, DV); (D, DV) one of (64, 64), (80, 80), (128,
// 128), (192, 128), (256, 256); lse: the forward's float32 (B, H, Sq),
// contiguous.
// Scratch: lse2 and delta float32 (B, H, sq_pad), sq_pad a multiple of 128
// that is >= Sq; dkp float32 (B, H, Sk, D), dvp (B, H, Sk, DV). Strides in
// elements, the head dim
// contiguous; every base 16-byte aligned and every other stride a multiple
// of 8 elements (TMA's rules; the wrapper checks). Returns 0, a cudaError_t
// of the launches (> 0), or -CUresult when a tensor map cannot be encoded.
extern "C" int repro_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* lse2, float* delta, float* dkp, float* dvp, int B, int H, int KV,
    int Sq, int Sk, int D, int DV, int sq_pad, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh, long long dv_sb,
    long long dv_ss, long long dv_sh, float scale, int causal, int window,
    int q_offset, float softcap, void* stream) {
  const bool shape_ok = (D == 64 && DV == 64) || (D == 80 && DV == 80) ||
                        (D == 128 && DV == 128) || (D == 192 && DV == 128) ||
                        (D == 256 && DV == 256);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk < 0 ||
      !shape_ok || sq_pad < Sq || sq_pad % PAD != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  // Sk = 0: a one-row map that no tile reads
  const int sk = Sk > 0 ? Sk : 1;
  const int c = box_cols(D, DV);
  CUresult r = make_map(&tq, q, B, Sq, H, D, q_sb, q_ss, q_sh, BM, c);
  if (r == CUDA_SUCCESS)
    r = make_map(&tk, k, B, sk, KV, D, k_sb, k_ss, k_sh, BM, c);
  if (r == CUDA_SUCCESS)
    r = make_map(&tv, v, B, sk, KV, DV, v_sb, v_ss, v_sh, BM, c);
  if (r == CUDA_SUCCESS)
    r = make_map(&tdo, dout, B, Sq, H, DV, do_sb, do_ss, do_sh, BM, c);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  Params p{};
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.G = H / KV;
  p.sq_pad = sq_pad;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.softcap = softcap;
  p.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  p.cap_log2 = softcap * LOG2E;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.lse2 = lse2;
  p.delta = delta;
  p.dkp = dkp;
  p.dvp = dvp;
  p.dq = static_cast<bf16*>(dq);
  p.dq_sb = dq_sb;
  p.dq_ss = dq_ss;
  p.dq_sh = dq_sh;
  const bf16* ob = static_cast<const bf16*>(o);
  const bf16* gb = static_cast<const bf16*>(dout);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel_launch) {
    return static_cast<int>(kernel_launch(
        tq, tk, tv, tdo, p, ob, gb, lse, lse2, delta, o_sb, o_ss, o_sh, do_sb,
        do_ss, do_sh, dkb, dvb, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, s));
  };
  if (D == 64) return run(launch<64, 64>);
  if (D == 80) return run(launch<80, 80>);
  if (D == 128) return run(launch<128, 128>);
  if (D == 192) return run(launch<192, 128>);
  return run(launch<256, 256>);
}
