// Flash attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention/
// kernel.py (`_flash_kernel`, launched by `flash_attention_kernel`) and the
// layout/padding work of its wrapper ops.py. It computes the same function:
// online-softmax attention with GQA (head h reads KV head h / (H / KV)),
// scale 1/sqrt(hd), causal mask kpos <= qpos, sliding-window mask
// kpos > qpos - window, float32 running max / denominator / accumulator,
// and 0 for a row whose every key is masked. Two scalars the reference's
// dispatch drops are taken here: `q_offset` (absolute position of query
// row 0) and `softcap` (s = tanh(s / c) * c before the mask); with both 0 it
// equals the reference.
//
// Translation. The TPU kernel runs a grid (B, H, Sq/bq, Sk/bk) whose
// innermost K axis is sequential and carries m/l/acc in VMEM scratch.
// Blocks on the GPU run in no order, so here one thread block owns one
// (64-query tile, head, batch) and loops over 64-key K/V tiles staged in
// shared memory, keeping m, l and acc per row in registers. K/V tiles
// outside the causal cone or the window are never visited; the masks are
// applied per element, and the ragged S edges are masked here (no padding
// copies). The model layout (B, S, H, hd) is read through strides: no
// transposes, and hd is not padded to 128 lanes (that was a TPU matter).
//
// Bound on the H100. At the serving prefill shape (B=8, S=1024, H=32,
// KV=8, hd=128, bf16, causal) the work is 4 * B * H * hd * S(S+1)/2 =
// 69 GFLOP against 160 MiB of q/k/v/o traffic: about 0.07 ms at 989
// TFLOP/s of bf16 tensor-core rate and 0.05 ms at 3.35 TB/s, so it is
// compute bound. This first design uses no tensor cores: both products run as
// float32 FMAs from shared memory (each thread holds a 4 x 4 score tile
// and a 4 x hd/16 output tile), so it is limited by the 67 TFLOP/s
// non-tensor float32 rate and by shared-memory bandwidth. mma/wgmma and TMA
// are the next step.
//
// It also writes each row's log-sum-exp, float32 (B, H, Sq), for the
// backward: m + ln l over the scaled (soft-capped) visible scores, and +inf
// for a row that sees no key (l = 0), so that the backward's P of that row
// is 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per K/V tile
constexpr int NT = 256;         // threads: 16 row groups x 16 column lanes
constexpr int RPT = BQ / 16;    // rows per thread
constexpr int CPT = BK / 16;    // score columns per thread
constexpr int PSTR = BK + 2;    // padded row stride of the P tile
constexpr float NEG = -1e30f;   // finite "minus infinity" for the running max

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  float softcap;
  int causal;
  int window;                   // <= 0: no window
  int q_offset;
  float* lse;                   // (B, H, Sq) float32
};

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

template <int D> __host__ __device__ constexpr int q_stride() { return D + 2; }
template <int D> __host__ __device__ constexpr int k_stride() { return D + 1; }

template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * q_stride<D>() + size_t(BK) * k_stride<D>() +
          size_t(BK) * D + size_t(BQ) * PSTR);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int DPT = D / 16;           // output columns per thread
  constexpr int QSTR = q_stride<D>();   // padding breaks bank conflicts
  constexpr int KSTR = k_stride<D>();
  extern __shared__ float smem[];
  float* sQ = smem;                     // BQ x QSTR
  float* sK = sQ + BQ * QSTR;           // BK x KSTR
  float* sV = sK + BK * KSTR;           // BK x D
  float* sP = sV + BK * D;              // BQ x PSTR

  const int tid = threadIdx.x;
  const int lane = tid & 15;            // column lane within a row group
  const int row0 = (tid >> 4) * RPT;    // first of this thread's rows
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    sQ[r * QSTR + c] =
        qi < p.Sq ? to_f32(Q[(long long)qi * p.q_ss + c]) : 0.f;
  }

  // Keys any row of this tile can see: [k_begin, k_end).
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, p.q_offset + q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, p.q_offset + q0 - p.window + 1);
  k_begin -= k_begin % BK;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile's sK/sV/sP are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int kj = kt + r;
      float kx = 0.f, vx = 0.f;
      if (kj < p.Sk) {
        kx = to_f32(K[(long long)kj * p.k_ss + c]);
        vx = to_f32(V[(long long)kj * p.v_ss + c]);
      }
      sK[r * KSTR + c] = kx;
      sV[i] = vx;
    }
    __syncthreads();

    // s[i][j]: row row0 + i, key kt + lane + 16 j
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(row0 + i) * QSTR + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(lane + 16 * j) * KSTR + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + row0 + i;
      const int qpos = p.q_offset + qi;
      bool ok[CPT];
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = kt + lane + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        bool valid = qi < p.Sq && kpos < p.Sk;
        if (p.causal) valid = valid && kpos <= qpos;
        if (p.window > 0) valid = valid && kpos > qpos - p.window;
        ok[j] = valid;
        s[i][j] = valid ? x : NEG;
        mt = fmaxf(mt, s[i][j]);
      }
      // the 16 lanes of a row group are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(row0 + i) * PSTR + lane + 16 * j] = pj;
        rs += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // the P tile is complete

    // acc[i][j] += sum_kk P[row0 + i][kk] * V[kk][lane + 16 j]
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(row0 + i) * PSTR + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vx = sV[kk * D + lane + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vx, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lane == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + qi] =
          l[i] > 0.f ? m[i] + logf(l[i]) : __int_as_float(0x7f800000);
    T* out = O + (long long)qi * p.o_ss;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      out[lane + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
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

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// must be contiguous; lse is a contiguous float32 (B, H, Sq). Returns the
// cudaError_t of the launch.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B,
    int H, int KV, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int window,
    int q_offset, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    B,    H,     KV,      Sq,
                 Sk,   q_sb, q_ss, q_sh, k_sb, k_ss,  k_sh,    v_sb,
                 v_ss, v_sh, o_sb, o_ss, o_sh, scale, softcap, causal,
                 window, q_offset, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(D, p, s));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(D, p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
