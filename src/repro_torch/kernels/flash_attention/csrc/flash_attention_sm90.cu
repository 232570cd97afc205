// Flash attention forward for NVIDIA Hopper (sm_90a), bf16, designed for
// the card: wgmma tensor cores, a TMA-fed K/V ring with mbarriers, one
// producer and two consumer warpgroups, persistent blocks. It is
// templated on the q/k head dim DQK and the v width DV and instantiated
// at (64, 64), (128, 128), (192, 128) (MLA: 128 nope + 64 rope, v read
// at its own 128), (256, 256) and (80, 80) (hubert-xlarge;
// repro_flash_attention_sm90_fwd refuses other pairs). float32 inputs and
// the other shapes run the first design, flash_attention.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py:94 (`flash_attention_kernel`, body `_flash_kernel`). The
// function is the same as flash_attention.cu's: GQA (head h reads KV head
// h / (H / KV)), scale 1/sqrt(hd), causal mask kpos <= qpos, window mask
// kpos > qpos - window, `q_offset` (absolute position of query row 0, also
// with Sq != Sk), `softcap` (s = tanh(s / c) * c before the mask), ragged
// Sq and Sk, q/k/v read through strides, and 0 for a row whose every key
// is masked. Running max, denominator and accumulator are float32.
//
// Bound on the H100. At the granite-8b prefill shape (B=8, S=1024, H=32,
// KV=8, hd=128, causal) the visible (query, key) pairs need 68.79 GFLOP:
// 0.0696 ms at 989 TFLOP/s of bf16 tensor-core rate, against 0.05 ms for
// the 160 MiB of q/k/v/o at 3.35 TB/s, so the kernel is bound by its
// operations. Splitting P (below) adds half again to the tensor-core
// work: the floor becomes about 0.104 ms. What each choice does about it:
//
// * Both products on tensor cores with wgmma (m64n64k16 for S = Q K^T
//   over DQK, m64n{DV}k16 for O += P V; at DV 256 two n128 halves),
//   float32 accumulators in registers: the only way to the bf16 rate.
// * A work item is 128 query rows of one (batch, head). A block has three
//   warpgroups: a producer, whose one thread issues every TMA copy and
//   gives its registers to the consumers (setmaxnreg 40 / 232; 24 / 240
//   at DV 256, where a consumer holds O at 64 x 256, 128 registers,
//   beside S and the P split's fragments, 32 + 32), and two consumers of
//   64 rows each, which never compute an address of a load.
// * Blocks are persistent, one per SM, and walk the items heaviest first
//   (causal: the last q-tiles), round robin. The next item's Q and first
//   K/V tiles load while this item computes, and its O store overlaps the
//   next item, so no block start or end leaves the tensor cores idle.
// * TMA loads Q into one of two buffers and streams 64-key K/V tiles
//   through a ring of up to 4 shared-memory slots with full and empty
//   mbarriers, in 128-byte swizzle (conflict-free for wgmma; an inner box
//   of 64 bf16, so hd 128 is two boxes). hd 80 is no multiple of 64: its
//   tiles are five boxes of 16 columns in 32-byte swizzle (box_cols in
//   sm90_ptx.cuh), so the layout is one and the same over all 80
//   columns: S is 5 k-steps, one a box, and PV one m64n80k16 a k-step,
//   whose MN-major descriptor steps from box to box by its lbo. No
//   column is padded: the tensor work is the shape's own. TMA's
//   out-of-bounds zero fill takes the ragged edges, and a K/V view of a
//   larger cache is read
//   through its strides. Shared memory per shape: (192, 128) two Q
//   buffers of 48 KB and 3 slots of 24 + 16 KB; (256, 256) does not fit
//   two Q buffers beside two slots of 32 + 32 KB, so it keeps one Q
//   buffer of 64 KB: the next item's Q loads after this item's O store.
// * Each consumer issues S of tile t and O += P V of tile t - 1 together;
//   its softmax of S_t runs while the tensor cores do that PV. At (256,
//   256) ptxas spills 132 bytes a consumer thread (O 128 registers, S 32,
//   P's two fragments 32, the softmax's state); the `serial` copy of
//   ablate.py, which issues the two products one after the other,
//   measured 1.7-3.0% slower at gemma3-1b's four shapes on the H100, so
//   the overlap stays at every width.
// * Softmax on the S accumulator in registers: scale * log2(e) folded
//   into one multiply-add before ex2; a row lives in one quad, so its max
//   takes two shuffles and its sum is reduced once at the end. Masks are
//   applied per element only on tiles that cross the causal diagonal,
//   the window's edge or Sk; tiles wholly outside the cone or the window
//   are never loaded, and a consumer skips tiles none of its rows sees.
// * P feeds the second product from registers: for 16-bit A the float32
//   accumulator fragment of S is the register fragment of A, no shuffles.
//   P is split as P = P_hi + P_lo, P_hi = bf16(P), P_lo = bf16(P - P_hi),
//   and both parts are multiplied into the same accumulator. The TPU
//   kernel takes p @ v in float32; P rounded once to bf16 would add about
//   2^-9 relative error to each p, far outside the 2^-7 |o| + 1e-5 gate
//   against the float32 plain version where |o| is near 0. The split
//   keeps P to about 2^-17 at 1.5x the tensor-core work.
// * The epilogue writes O / max(l, 1e-30) as bf16 into the item's own
//   (consumed) Q buffer in the swizzled layout and TMA stores it; rows
//   past Sq are clipped by the store. It also writes each row's
//   log-sum-exp, float32 (B, H, Sq), for the backward
//   (flash_attention_bwd_sm90.cu): ln of the row's sum of exp over its
//   scaled (soft-capped) visible scores, (m + log2 l) ln 2 in the kernel's
//   log2 units, and +inf for a row that saw no key (l = 0; its m is the
//   -inf it started with), so that the backward's P of that row is 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_ptx.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128;          // query rows per work item
constexpr int BK = 64;           // keys per K/V tile
constexpr int WG_ROWS = 64;      // query rows per consumer warpgroup
constexpr int NT = 384;          // producer + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  int B, H, KV, Sq, Sk;
  int n_qtiles, n_work;          // q-tiles per (b, h); items in all
  float scale;
  float scale_log2;              // scale * log2(e)
  float softcap;                 // <= 0: none
  int causal;
  int window;                    // <= 0: none
  int q_offset;
  float* lse;                    // (B, H, Sq) float32, natural log
};

template <int DQK, int DV>
struct Layout {
  // boxes of EB columns, RB bytes a row (sm90_ptx.cuh: box_cols)
  static constexpr int EB = box_cols(DQK, DV);
  static constexpr int RB = 2 * EB;
  static constexpr int KPB = EB / 16;                        // k16 a box
  static constexpr uint32_t SBO = 8 * RB;                    // 8 rows
  static constexpr uint64_t CODE = swizzle_code(EB);
  static_assert(DQK % EB == 0 && DV % EB == 0, "widths in whole boxes");
  static constexpr int NBOX = DQK / EB;                      // Q and K boxes
  static constexpr int VBOX = DV / EB;                       // V and O boxes
  static constexpr uint32_t Q_BOX = BQ * RB;                 // bytes
  static constexpr uint32_t KV_BOX = BK * RB;
  static constexpr uint32_t Q_BYTES = NBOX * Q_BOX;
  static constexpr uint32_t K_BYTES = NBOX * KV_BOX;         // K tile
  static constexpr uint32_t V_BYTES = VBOX * KV_BOX;         // V tile
  // two Q buffers where two K/V slots fit beside them (the next item's Q
  // loads while this one's runs), else one; each also stages its item's
  // O. Then the K/V ring in what is left of 227 KB, at most MAX_STAGES
  // slots (fewer measured slower at hd 128)
  static constexpr int MAX_STAGES = 4;
  static constexpr int NQ =
      2 * Q_BYTES + 2 * (K_BYTES + V_BYTES) + 2048 <= 227 * 1024 ? 2 : 1;
  static constexpr int FIT = (227 * 1024 - NQ * Q_BYTES - 2048) /
                             (K_BYTES + V_BYTES);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr uint32_t K_OFF = NQ * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * V_BYTES;
  // kv full/empty [STAGES], q full/empty [2]; 1024 bytes to align the base
  static constexpr size_t SMEM = BAR_OFF + 8 * (2 * STAGES + 4) + 1024;
  // registers a producer thread gives up and a consumer takes
  // (setmaxnreg): 128 x (producer + 2 consumers) <= 64,512 of the SM's
  static constexpr int PRODUCER_REGS = DV > 128 ? 24 : 40;
  static constexpr int CONSUMER_REGS = DV > 128 ? 240 : 232;
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

// Keys [k_begin, k_end) that rows [r0, r1) may see (r1 > r0).
__device__ __forceinline__ void key_range(const Params& p, int r0, int r1,
                                          int& k_begin, int& k_end) {
  k_end = p.Sk;
  if (p.causal) k_end = min(k_end, p.q_offset + r1);
  k_begin = 0;
  if (p.window > 0) k_begin = max(0, p.q_offset + r0 - p.window + 1);
}

// One work item: 128 query rows of one (batch, head), heaviest first (the
// reversed q-tile is the slowest index, the head the fastest, so items
// that run together share K/V heads in L2), and its K/V tiles.
struct Item {
  int b, h, q0, kt0, n_tiles;
};

__device__ __forceinline__ Item item(const Params& p, int w) {
  Item it;
  const int bh = p.B * p.H;
  it.q0 = (p.n_qtiles - 1 - w / bh) * BQ;
  it.b = (w % bh) / p.H;
  it.h = w % p.H;
  int k_begin, k_end;
  key_range(p, it.q0, min(it.q0 + BQ, p.Sq), k_begin, k_end);
  it.kt0 = k_begin - k_begin % BK;
  it.n_tiles = k_end > it.kt0 ? (k_end - it.kt0 + BK - 1) / BK : 0;
  return it;
}

// A position in the K/V ring: slot and the parity of its current round.
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

// Online softmax of one 64 x 64 score tile s (this thread's 32 values,
// rows a and a + 8) in place: s becomes p = exp2(t - m) with t the score
// in log2 units; m (running max) and l (this thread's share of the
// row sums) are updated, and corr set to each row's exp2(m_old - m).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const Params& p, int kt,
                                             const int (&qpos)[2], int tq,
                                             float mult, float cap_in,
                                             float cap_out) {
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = tanhf(s[i] * cap_in) * cap_out;
  }
  if (MASK) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kpos = kt + 8 * (i / 4) + 2 * tq + (i % 2);
      const int qp = qpos[(i / 2) % 2];
      bool ok = kpos < p.Sk;
      if (p.causal) ok = ok && kpos <= qp;
      if (p.window > 0) ok = ok && kpos > qp - p.window;
      if (!ok) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * mult);
    // a row with no visible key so far keeps p = 0 and corr = 0
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = fast_exp2(m[r] - m_use[r]);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    s[i] = fast_exp2(fmaf(s[i], mult, -m_use[r]));
    l[r] += s[i];
  }
}

// P = P_hi + P_lo as register A fragments, one per 16 keys: the float32
// accumulator fragment of S is the register fragment of A for 16-bit A.
__device__ __forceinline__ void split_p(const float (&s)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
      const uint32_t h = pack_bf16(x0, x1);
      const float2 hf =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h));
      hi[kk][j] = h;
      lo[kk][j] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
}

// S = Q K^T for this warpgroup's 64 rows: DQK / 16 k-steps of 32 bytes,
// 4 per 128-byte box or 1 per 32-byte box (K-major A and B).
template <int DQK, int DV>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t sQw,
                                         uint32_t sK) {
  using L = Layout<DQK, DV>;
#pragma unroll
  for (int k = 0; k < DQK / 16; ++k) {
    const uint32_t off = (k % L::KPB) * 32;
    const int x = k / L::KPB;
    wgmma_ss_m64n64k16(
        s, make_desc(sQw + x * L::Q_BOX + off, 16, L::SBO, L::CODE),
        make_desc(sK + x * L::KV_BOX + off, 16, L::SBO, L::CODE), k > 0);
  }
}

// O += P_hi V + P_lo V: V is MN-major (its columns contiguous), 16 keys =
// 16 rows of the box per k-step, the next box (64 or 16 columns) lbo
// further. At DV 256 the product is two n128 halves: the accumulator
// fragment of columns [0, 128) is o[0, 64), of [128, 256) o[64, 128).
template <int DQK, int DV>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         uint32_t sV) {
  using L = Layout<DQK, DV>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv =
        make_desc(sV + kk * 16 * L::RB, L::KV_BOX, L::SBO, L::CODE);
    if constexpr (DV == 64) {
      wgmma_rs_m64n64k16(o, hi[kk], dv);
      wgmma_rs_m64n64k16(o, lo[kk], dv);
    } else if constexpr (DV == 128) {
      wgmma_rs_m64n128k16(o, hi[kk], dv);
      wgmma_rs_m64n128k16(o, lo[kk], dv);
    } else if constexpr (DV == 80) {
      wgmma_rs_m64n80k16(o, hi[kk], dv);
      wgmma_rs_m64n80k16(o, lo[kk], dv);
    } else {
      static_assert(DV == 256, "issue_pv: DV is 64, 80, 128 or 256");
      float(&o0)[64] = *reinterpret_cast<float(*)[64]>(&o[0]);
      float(&o1)[64] = *reinterpret_cast<float(*)[64]>(&o[64]);
      const uint64_t dv1 = make_desc(sV + 2 * L::KV_BOX + kk * 16 * L::RB,
                                     L::KV_BOX, L::SBO, L::CODE);
      wgmma_rs_m64n128k16(o0, hi[kk], dv);
      wgmma_rs_m64n128k16(o1, hi[kk], dv1);
      wgmma_rs_m64n128k16(o0, lo[kk], dv);
      wgmma_rs_m64n128k16(o1, lo[kk], dv1);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using L = Layout<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::BAR_OFF;
  const uint32_t kv_empty = kv_full + 8 * L::STAGES;
  const uint32_t q_full = kv_empty + 8 * L::STAGES;    // [2]
  const uint32_t q_empty = q_full + 16;                // [2]
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 8);   // one arrival per consumer warp
    }
    for (int x = 0; x < L::NQ; ++x) {
      mbar_init(q_full + 8 * x, 1);
      mbar_init(q_empty + 8 * x, 2);    // each consumer wg, O stored
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every TMA copy ----------
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      Ring ring;
      for (int w = blockIdx.x, n = 0; w < p.n_work; w += gridDim.x, ++n) {
        const Item it = item(p, w);
        const int kvh = it.h / (p.H / p.KV);
        const uint32_t qb = n % L::NQ;
        mbar_wait(q_empty + 8 * qb, ((n / L::NQ) & 1) ^ 1);
        mbar_arrive_expect_tx(q_full + 8 * qb, L::Q_BYTES);
        for (int x = 0; x < L::NBOX; ++x)
          tma_load_4d(base + qb * L::Q_BYTES + x * L::Q_BOX, &tm_q,
                      q_full + 8 * qb, x * L::EB, it.q0, it.h, it.b);
        for (int t = 0; t < it.n_tiles; ++t) {
          const int kt = it.kt0 + t * BK;
          mbar_wait(kv_empty + 8 * ring.stage, ring.phase ^ 1);
          const uint32_t full = kv_full + 8 * ring.stage;
          mbar_arrive_expect_tx(full, L::K_BYTES + L::V_BYTES);
          const uint32_t sK = base + L::K_OFF + ring.stage * L::K_BYTES;
          const uint32_t sV = base + L::V_OFF + ring.stage * L::V_BYTES;
          for (int x = 0; x < L::NBOX; ++x)
            tma_load_4d(sK + x * L::KV_BOX, &tm_k, full, x * L::EB, kt, kvh,
                        it.b);
          for (int x = 0; x < L::VBOX; ++x)
            tma_load_4d(sV + x * L::KV_BOX, &tm_v, full, x * L::EB, kt, kvh,
                        it.b);
          ring.next<L::STAGES>();
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows of each item -------------------
  setmaxnreg_inc<L::CONSUMER_REGS>();
  const int wg = warp / 4 - 1;
  const int tid = threadIdx.x - 128 * (wg + 1);
  const int lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int ra = (tid / 32) * 16 + g;   // this thread's rows: ra, ra + 8
  const float mult = p.softcap > 0.f ? 1.f : p.scale_log2;
  const float cap_in = p.softcap > 0.f ? p.scale / p.softcap : 0.f;
  const float cap_out = p.softcap * LOG2E;

  Ring ring;
  for (int w = blockIdx.x, n = 0; w < p.n_work; w += gridDim.x, ++n) {
    const Item it = item(p, w);
    const uint32_t qb = n % L::NQ;
    const int w0 = it.q0 + wg * WG_ROWS;          // first row of this wg
    const int qpos[2] = {p.q_offset + w0 + ra, p.q_offset + w0 + ra + 8};
    // this wg's own tiles [t_lo, t_hi) among the item's; the others are
    // waited for and released untouched
    int t_lo = 0, t_hi = 0;
    if (w0 < p.Sq) {
      int k_begin, k_end;
      key_range(p, w0, min(w0 + WG_ROWS, p.Sq), k_begin, k_end);
      if (k_end > k_begin) {
        t_lo = max(0, (k_begin - it.kt0) / BK);
        t_hi = min(it.n_tiles, (k_end - it.kt0 + BK - 1) / BK);
      }
    }
    const uint32_t sQw = base + qb * L::Q_BYTES + wg * (WG_ROWS * L::RB);
    // a tile needs per-element masks where it crosses Sk, the causal
    // diagonal or the window's edge for some row of this wg
    auto need_mask = [&](int kt) {
      return kt + BK > p.Sk || (p.causal && kt + BK - 1 > qpos[0] - ra) ||
             (p.window > 0 && kt <= qpos[0] - ra + WG_ROWS - 1 - p.window);
    };
    auto skip = [&]() {
      mbar_wait(kv_full + 8 * ring.stage, ring.phase);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * ring.stage);
      ring.next<L::STAGES>();
    };

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
    float l[2] = {0.f, 0.f};               // this thread's share of the sum
    mbar_wait(q_full + 8 * qb, (n / L::NQ) & 1);
    for (int t = 0; t < t_lo; ++t) skip();
    if (t_hi > t_lo) {
      // Tile t_lo: S, softmax. Then for each next tile: S of that tile
      // and PV of the one before run on the tensor cores while this
      // warpgroup's softmax of the new S waits only for S.
      float s[32], corr[2];
      uint32_t p_hi[4][4], p_lo[4][4];
      Ring prev = ring;
      int kt = it.kt0 + t_lo * BK;
      mbar_wait(kv_full + 8 * ring.stage, ring.phase);
      wgmma_fence();
      issue_qk<DQK, DV>(s, sQw, base + L::K_OFF + ring.stage * L::K_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (need_mask(kt))
        softmax_tile<true>(s, m, l, corr, p, kt, qpos, tq, mult, cap_in,
                           cap_out);
      else
        softmax_tile<false>(s, m, l, corr, p, kt, qpos, tq, mult, cap_in,
                            cap_out);
      split_p(s, p_hi, p_lo);
      ring.next<L::STAGES>();
      for (int t = t_lo + 1; t < t_hi; ++t) {
        kt = it.kt0 + t * BK;
        mbar_wait(kv_full + 8 * ring.stage, ring.phase);
        fence_regs(o);
        fence_regs(p_hi);
        fence_regs(p_lo);
        wgmma_fence();
        issue_qk<DQK, DV>(s, sQw,
                          base + L::K_OFF + ring.stage * L::K_BYTES);
        wgmma_commit();
        issue_pv<DQK, DV>(o, p_hi, p_lo,
                          base + L::V_OFF + prev.stage * L::V_BYTES);
        wgmma_commit();
        wgmma_wait<1>();                    // S done, PV may run on
        fence_regs(s);
        if (need_mask(kt))
          softmax_tile<true>(s, m, l, corr, p, kt, qpos, tq, mult, cap_in,
                             cap_out);
        else
          softmax_tile<false>(s, m, l, corr, p, kt, qpos, tq, mult, cap_in,
                              cap_out);
        wgmma_wait<0>();                    // PV of the tile before
        fence_regs(o);
        fence_regs(p_hi);
        fence_regs(p_lo);
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty + 8 * prev.stage);
        prev = ring;
        ring.next<L::STAGES>();
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i / 2) % 2];
        split_p(s, p_hi, p_lo);
      }
      // PV of the last tile
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
      issue_pv<DQK, DV>(o, p_hi, p_lo,
                        base + L::V_OFF + prev.stage * L::V_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * prev.stage);
    }
    for (int t = max(t_hi, t_lo); t < it.n_tiles; ++t) skip();

    // ---- epilogue: the rows' LSE; O / l as bf16 into this wg's rows of
    // the Q buffer (DV / EB of its DQK / EB boxes), then one TMA store;
    // the buffer is released once the store has read it
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
      const int row = w0 + ra + 8 * r;
      if (tq == 0 && row < p.Sq)
        p.lse[(static_cast<long long>(it.b) * p.H + it.h) * p.Sq + row] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : INFINITY;
    }
    named_sync(1 + wg, 128);             // every Q read of this wg is done
    uint8_t* out = smem + qb * L::Q_BYTES + wg * (WG_ROWS * L::RB);
#pragma unroll
    for (int i = 0; i < DV / 2; i += 2) {
      const int r = ra + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + 2 * tq;  // column of o[i], o[i + 1]
      const int x = c / L::EB, cc = c % L::EB;
      const uint32_t off = x * L::Q_BOX + swizzled(L::RB, r, cc * 2);
      const float sc = inv[(i / 2) % 2];
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_bf16(o[i] * sc, o[i + 1] * sc);
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (tid == 0) {
      if (w0 < p.Sq) {
        for (int x = 0; x < L::VBOX; ++x)
          tma_store_4d(&tm_o, sQw + x * L::Q_BOX, x * L::EB, w0, it.h, it.b);
        tma_store_commit_and_wait();
      }
      mbar_arrive(q_empty + 8 * qb);
    }
  }
}

template <int DQK, int DV>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& to,
                   const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Layout<DQK, DV>::SMEM;
  static_assert(smem <= 227 * 1024, "shared memory over 227 KB");
  static_assert(Layout<DQK, DV>::STAGES >= 2, "fewer than two K/V slots");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // persistent: one block per SM walks the work items
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int grid = sms < p.n_work ? sms : p.n_work;
  flash_fwd_sm90<DQK, DV><<<grid, NT, smem, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

}  // namespace

// bf16 q (B,Sq,H,D), k (B,Sk,KV,D), v (B,Sk,KV,DV), o (B,Sq,H,DV), (D, DV)
// one of (64, 64), (80, 80), (128, 128), (192, 128), (256, 256); lse float32
// (B,H,Sq), contiguous; strides in elements, the head dim contiguous; every
// base 16-byte aligned and every other stride a multiple of 8 elements
// (TMA's rules; the wrapper checks).
// Returns 0, a cudaError_t of the launch (> 0), or -CUresult when a tensor
// map cannot be encoded (-CUDA_ERROR_NOT_FOUND: no driver entry point).
extern "C" int repro_flash_attention_sm90_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int H,
    int KV, int Sq, int Sk, int D, int DV, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int window,
    int q_offset, float softcap, void* stream) {
  const bool shape_ok = (D == 64 && DV == 64) || (D == 80 && DV == 80) ||
                        (D == 128 && DV == 128) || (D == 192 && DV == 128) ||
                        (D == 256 && DV == 256);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk < 0 ||
      !shape_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, to;
  // Sk = 0: a one-row map that no tile reads (causal or not, k_end = 0)
  const int sk = Sk > 0 ? Sk : 1;
  const int c = box_cols(D, DV);
  CUresult r = make_map(&tq, q, B, Sq, H, D, q_sb, q_ss, q_sh, BQ, c);
  if (r == CUDA_SUCCESS)
    r = make_map(&tk, k, B, sk, KV, D, k_sb, k_ss, k_sh, BK, c);
  if (r == CUDA_SUCCESS)
    r = make_map(&tv, v, B, sk, KV, DV, v_sb, v_ss, v_sh, BK, c);
  if (r == CUDA_SUCCESS)
    r = make_map(&to, o, B, Sq, H, DV, o_sb, o_ss, o_sh, WG_ROWS, c);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const int n_qtiles = (Sq + BQ - 1) / BQ;
  const Params p{B, H, KV, Sq, Sk, n_qtiles, B * H * n_qtiles, scale,
                 scale * LOG2E, softcap, causal, window, q_offset, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(launch<64, 64>(tq, tk, tv, to, p, s));
  if (D == 80) return static_cast<int>(launch<80, 80>(tq, tk, tv, to, p, s));
  if (D == 128)
    return static_cast<int>(launch<128, 128>(tq, tk, tv, to, p, s));
  if (D == 192)
    return static_cast<int>(launch<192, 128>(tq, tk, tv, to, p, s));
  return static_cast<int>(launch<256, 256>(tq, tk, tv, to, p, s));
}
