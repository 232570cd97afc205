// What the two flash-attention backward kernels share
// (flash_attention_bwd.cu, float32 FMAs; flash_attention_bwd_mma.cu, bf16
// tensor cores): their parameters, the masks, the scores and the tile
// ranges that a query or key tile sees. Each .cu includes it inside its
// own anonymous namespace.
#pragma once

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                    // (B, H, Sq) scratch
  float* delta;                  // (B, H, Sq) scratch
  int B, H, KV, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  float softcap;
  int causal;
  int window;                    // <= 0: no window
  int q_offset;
};

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  const int qpos = p.q_offset + qi;
  bool ok = qi < p.Sq && kj < p.Sk;
  if (p.causal) ok = ok && kj <= qpos;
  if (p.window > 0) ok = ok && kj > qpos - p.window;
  return ok;
}

// Scaled (and soft-capped) score; `t` returns tanh for the softcap's
// derivative.
__device__ __forceinline__ float score(const Params& p, float dot, float* t) {
  float x = dot * p.scale;
  if (p.softcap > 0.f) {
    *t = tanhf(x / p.softcap);
    x = *t * p.softcap;
  }
  return x;
}

// Keys any query row in [q0, q0 + BM) can see: [begin, end), begin rounded
// down to a multiple of bk.
__device__ __forceinline__ void key_range(const Params& p, int q0, int bm,
                                          int bk, int* begin, int* end) {
  const int q_last = min(q0 + bm, p.Sq) - 1;
  int e = p.Sk;
  if (p.causal) e = min(e, p.q_offset + q_last + 1);
  int b = 0;
  if (p.window > 0) b = max(0, p.q_offset + q0 - p.window + 1);
  *begin = b - b % bk;
  *end = e;
}

// Query rows that see any key in [k0, k0 + bk): [begin, end), begin rounded
// down to a multiple of bm.
__device__ __forceinline__ void query_range(const Params& p, int k0, int bk,
                                            int bm, int* begin, int* end) {
  const int k_last = min(k0 + bk, p.Sk) - 1;
  int b = 0;
  if (p.causal) b = max(0, k0 - p.q_offset);
  int e = p.Sq;
  if (p.window > 0) e = min(e, k_last + p.window - p.q_offset);
  *begin = b - b % bm;
  *end = e;
}
