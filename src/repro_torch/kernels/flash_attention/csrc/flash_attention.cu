// Flash-attention forward for Hopper (sm_90a): causal / sliding-window / GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, pallas_call at :113) and the layout transposes of
// its wrapper src/repro/kernels/flash_attention/ops.py:18-26.
//
//   o[b, i, h, :] = softmax_j(q[b, i, h] . k[b, j, h / (Hq/Hk)] / sqrt(D)) v[b, j, h / (Hq/Hk)]
//
// over the keys j that the masks leave live: query position i + (Skv - Sq),
// causal j <= position, window j > position - window.  Masked scores are
// -1e30, not -inf, exactly as the TPU kernel writes them (kernel.py:63-68).
//
// What bounds it on the card: operations.  At the serve shape of qwen1.5-0.5b
// (B = 4, Hq = 16, S = 2048, D = 64, causal) attention moves ~34 MB of q, k,
// v and o but does ~34 GFLOP: 10 us of HBM traffic against ~35 us on the bf16
// tensor cores and ~0.5 ms at the f32 FFMA rate this kernel uses.  The design:
//   * The TPU kernel carries m, l and the (TQ, D) accumulator in VMEM scratch
//     across a *sequential* KV axis of its grid.  Blocks on Hopper run in
//     parallel and in no order, so here one block owns one (batch, q-head,
//     64-row q tile), loops over its KV tiles itself with the online-softmax
//     statistics and the accumulator in registers, and writes its output
//     tile once.  2,048 blocks at the serve shape fill 132 SMs several times.
//   * Only the KV tiles that can hold a live key for the block's rows are
//     visited (the block-skip of kernel.py:44-52): under a causal mask the
//     work is about half the square, and blocks start heaviest-first.
//   * GQA reads KV head h / (Hq/Hk) in place, and q, k, v, o are read and
//     written in the model's (B, S, H, D) layout through strides: no
//     transposed or repeated copies.  Ragged Sq, Skv and D are masked here.
//   * f32 inputs accumulate with f32 FFMA (the parity tolerance is 2e-5,
//     which a single TF32 pass would miss); bf16 inputs widen on load.  q is
//     pre-scaled by 1/sqrt(D) in f32 and rounded back to its dtype before the
//     product, as kernel.py:109-110 does.  Output in q's dtype.
// A shared-memory tiled FFMA kernel; mma/wgmma, TMA and warp specialisation
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: each thread owns 4 rows x (4 keys | D/16 columns)
constexpr int kTQ = 64;        // query rows per block
constexpr int kTK = 64;        // keys per KV tile
constexpr int kLP = kTK + 1;   // padded row of the probability tile
constexpr float kMask = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// Reductions over the 16 threads of one row: lanes 0-15 and 16-31 of a warp.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DM>
constexpr int smem_bytes() {
  return (3 * kTQ * (DM + 1) + kTQ * kLP) * static_cast<int>(sizeof(float));
}

// Tensor x[b, s, h, d] at x + b*sb + s*ss + h*sh + d (d unit-stride).
// Grid: (q tiles, Hq, B).  window <= 0: no window.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Skv, int Hq, int Hk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int window) {
  constexpr int LD = DM + 1;  // padded rows: column reads hit 16 distinct banks
  constexpr int CJ = DM / 16; // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // [kTQ][LD]  pre-scaled q
  float* ks = qs + kTQ * LD;   // [kTK][LD]
  float* vs = ks + kTK * LD;   // [kTK][LD]
  float* ps = vs + kTK * LD;   // [kTQ][kLP] probabilities of the current tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the last tiles see the most keys: start them first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * kTQ;
  const int q_offset = Skv - Sq;  // suffix convention: the queries are the last Sq positions

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int e = tid; e < kTQ * DM; e += kThreads) {
    const int r = e / DM, c = e % DM;
    float x = 0.f;
    if (q0 + r < Sq && c < D) x = round_to(load_f(qb + (q0 + r) * q_ss + c) * scale, qb);
    qs[r * LD + c] = x;
  }

  // KV tiles that can hold a live key for rows [q0, q0 + kTQ)
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + kTQ, Sq) - 1 + q_offset;
  const int n_kt = (Skv + kTK - 1) / kTK;
  int kt_begin = 0, kt_end = n_kt;
  if (causal) kt_end = q_hi < 0 ? 0 : min(n_kt, q_hi / kTK + 1);
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / kTK;

  int qpos[4];
  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q0 + ty + 16 * i + q_offset;
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTK;
    __syncthreads();  // q is stored; the last tile's k, v and p are no longer read
    for (int e = tid; e < kTK * DM; e += kThreads) {
      const int r = e / DM, c = e % DM;
      const bool in = k0 + r < Skv && c < D;
      ks[r * LD + c] = in ? load_f(kb + (k0 + r) * k_ss + c) : 0.f;
      vs[r * LD + c] = in ? load_f(vb + (k0 + r) * v_ss + c) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DM; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // masks as the TPU kernel writes them; keys past Skv do not exist (-inf: p = 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool live = true;
        if (causal) live = live && kpos <= qpos[i];
        if (window > 0) live = live && kpos > qpos[i] - window;
        s[i][j] = kpos >= Skv ? -INFINITY : (live ? s[i][j] : kMask);
      }
    }

    // online softmax, row by row (a row with no live key yet has m = -1e30 and
    // p = 1 for its masked scores; the first live key wipes them through corr)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], row_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]))));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kLP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      float p[4], w[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kLP + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) w[j] = vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) store_f(ob + row * o_ss + col, acc[i][j] / denom);
    }
  }
}

template <typename T, int DM>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int Hq, int Hk, int D, const long long* st, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((Sq + kTQ - 1) / kTQ), (unsigned)Hq, (unsigned)B);
  flash_fwd_kernel<T, DM><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, Hq, Hk, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
               int Hq, int Hk, int D, const long long* st, float scale, int causal,
               int window, cudaStream_t s) {
  if (D <= 32) return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  if (D <= 128) return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  if (D <= 256) return launch<T, 256>(q, k, v, o, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dynamic shared memory of one block for head size D (0: D not supported).
extern "C" int repro_flash_attention_smem_bytes(int D) {
  if (D <= 0) return 0;
  if (D <= 32) return smem_bytes<32>();
  if (D <= 64) return smem_bytes<64>();
  if (D <= 128) return smem_bytes<128>();
  if (D <= 256) return smem_bytes<256>();
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  strides: (batch, seq, head) of q, k, v
// and o in elements, 12 values; the head dimension is unit-stride.  Launches
// on `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* o, int B, int Sq, int Skv, int Hq, int Hk, int D,
                                     const long long* strides, float scale, int causal,
                                     int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || Hq % Hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Sq, Skv, Hq, Hk, D, strides, scale, causal, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hk, D, strides, scale, causal,
                                     window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
