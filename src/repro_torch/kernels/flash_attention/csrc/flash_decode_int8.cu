// Int8 split-KV flash-decoding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/decode_kernel.py
// (flash_decode_int8, pallas_call at :93).
//
//   o[b, h, :] = softmax_j(qs[b, h] . k[b, h / G, j]) v[b, h / G, j],   G = Hq / Hk
//   qs = round_to_q_dtype(q * 1/sqrt(D)),  k = int8 * f32(k_scale),  v = int8 * f32(v_scale)
//
// over the positions j < kv_len (the others score -1e30, as the TPU kernel
// writes them); softmax with the 1e-37 floor on its sum; output f32.
//
// What bounds it on the card: memory.  At qwen1.5-0.5b's serve decode
// (B = 4, Hk = 16, S = 2,081, D = 64) it reads 17.05 MB of int8 K/V and
// 0.53 MB of bf16 scales for ~8.5 MFLOP: 5.3 us at 3.35 TB/s.  The design
// (flash-decoding, arXiv:2311.01282):
//   * The TPU kernel walks the whole cache sequentially for each (b, q-head)
//     with (m, l, acc) in VMEM scratch.  Here one block owns one (b, KV head,
//     split of the positions) and serves all G query heads of that KV head,
//     so each int8 tile is read from memory once per group, not G times.
//     The wrapper picks the split so that B * Hk * splits fills the SMs.
//   * A block walks its split in tiles of 64 positions: K and V rows are
//     loaded as 16-byte vectors (int8, dequantized in registers with the
//     position's scale), the tile's scores go to shared memory, one warp per
//     head updates the running max and sum, and each thread accumulates
//     its (head, column) outputs in f32 registers.  The block writes its
//     partial (m, l, acc[D]); a second small kernel combines the live splits.
//   * kv_len is a runtime argument (JAX makes it static and recompiles per
//     step): one build serves every decode position; splits that lie wholly
//     past kv_len return at once and the combine never reads them.
//   * The cache is read in place through strides: the model's (B, S, Hk, D)
//     int8 cache and (B, S, Hk) scales, viewed as (B, Hk, S, D) and (B, Hk, S).
// A simple kernel; keeping the scores in registers and pipelining the tile
// loads (cp.async / TMA) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 64;          // positions per tile
constexpr int kMaxPairs = 32;    // (head, column) outputs a thread owns: G * D <= 4096
constexpr float kMask = -1e30f;

struct Strides {  // element strides; the head dimension is unit-stride
  long long q_b, q_h;
  long long k_b, k_h, k_s, v_b, v_h, v_s;
  long long ks_b, ks_h, ks_s, vs_b, vs_h, vs_s;
};

__device__ __forceinline__ float load_f(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = (float)(signed char)((w[i] >> (8 * j)) & 0xffu);
}

// 16 int8 values of one row from column d0 on, zeros past D or for a row past the tile.
__device__ __forceinline__ uint4 load16(const int8_t* row, int d0, int D, bool valid, int vec) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (!valid || d0 >= D) return u;
  if (vec) return *reinterpret_cast<const uint4*>(row + d0);
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && d0 + i < D; ++i)
    w[i / 4] |= (unsigned)(uint8_t)row[d0 + i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a power of two >= ceil(D / 16), at most 16
__host__ __device__ inline int lanes_per_row(int D) {
  int l = 1;
  while (l * 16 < D) l *= 2;
  return l;
}

inline size_t smem_bytes(int G, int D) {
  const int dp = lanes_per_row(D) * 16;
  return (size_t)kTK * dp + sizeof(float) * ((size_t)G * dp + (size_t)G * kTK + kTK + 3 * G);
}

// Grid (splits, Hk, B).  part_ml (B, Hq, splits, 2), part_acc (B, Hq, splits, D).
template <int PAIRS>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const void* __restrict__ q, const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const void* __restrict__ ks, const void* __restrict__ vs, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int Hq, int Hk, int S, int D, int kv_len, int chunk,
    int splits, float scale, int q_bf16, int s_bf16, int vec, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = Hq / Hk;
  const int lpr = lanes_per_row(D), dp = lpr * 16;
  int8_t* vt = reinterpret_cast<int8_t*>(smem);                     // (kTK, dp) int8 V tile
  float* qs = reinterpret_cast<float*>(smem + (size_t)kTK * dp);    // (G, dp) scaled q
  float* sp = qs + G * dp;      // (G, kTK) scores, then p * v_scale
  float* vsc = sp + G * kTK;    // (kTK) v scales, 0 past the tile
  float* mst = vsc + kTK;       // (G) running max
  float* lst = mst + G;         // (G) running sum
  float* cst = lst + G;         // (G) this tile's correction of the old sums

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int j_begin = split * chunk;
  const int j_end = min(min(j_begin + chunk, S), kv_len);
  if (j_begin >= j_end) return;  // wholly past kv_len: the combine reads only live splits
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int e = tid; e < G * dp; e += kThreads) {
    const int g = e / dp, d = e % dp;
    float x = 0.f;
    if (d < D) {
      x = load_f(q, b * st.q_b + (long long)(hk * G + g) * st.q_h + d, q_bf16) * scale;
      if (q_bf16) x = __bfloat162float(__float2bfloat16(x));  // rounded back, as the TPU wrapper
    }
    qs[e] = x;
  }
  for (int g = tid; g < G; g += kThreads) {
    mst[g] = kMask;
    lst[g] = 0.f;
  }
  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.f;
  __syncthreads();

  const int8_t* kb = k + b * st.k_b + hk * st.k_h;
  const int8_t* vb = v + b * st.v_b + hk * st.v_h;
  const long long ks_off = b * st.ks_b + hk * st.ks_h, vs_off = b * st.vs_b + hk * st.vs_h;
  const int li = tid % lpr, d0 = li * 16;
  for (int j0 = j_begin; j0 < j_end; j0 += kTK) {
    const int n = min(kTK, j_end - j0);
    // 1. scores of the tile's rows: lpr lanes a row, 16 columns a lane
    for (int r = tid / lpr; r < kTK; r += kThreads / lpr) {
      const bool valid = r < n;
      const long long j = j0 + r;
      float kf[16];
      unpack16(load16(kb + j * st.k_s, d0, D, valid, vec), kf);
      *reinterpret_cast<uint4*>(vt + r * dp + d0) = load16(vb + j * st.v_s, d0, D, valid, vec);
      const float ksc = valid ? load_f(ks, ks_off + j * st.ks_s, s_bf16) : 0.f;
      for (int g = 0; g < G; ++g) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + g * dp + d0);
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = q4[i];
          part = fmaf(qv.x, kf[4 * i], part);
          part = fmaf(qv.y, kf[4 * i + 1], part);
          part = fmaf(qv.z, kf[4 * i + 2], part);
          part = fmaf(qv.w, kf[4 * i + 3], part);
        }
        for (int off = lpr / 2; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (li == 0) sp[g * kTK + r] = valid ? part * ksc : kMask;
      }
      if (li == 0) vsc[r] = valid ? load_f(vs, vs_off + j * st.vs_s, s_bf16) : 0.f;
    }
    __syncthreads();
    // 2. online softmax, one warp a head: 64 scores, two a lane
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = sp[g * kTK + lane], s1 = sp[g * kTK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = mst[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sp[g * kTK + lane] = p0 * vsc[lane];
      sp[g * kTK + lane + 32] = p1 * vsc[lane + 32];
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cst[g] = corr;
        lst[g] = lst[g] * corr + sum;
        mst[g] = m_new;
      }
    }
    __syncthreads();
    // 3. acc[(g, d)] = acc * corr[g] + sum_r p[g, r] * v_scale[r] * v_int8[r, d]
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        const float* pg = sp + g * kTK;
        float a = acc[i] * cst[g];
        for (int r = 0; r < n; ++r) a = fmaf(pg[r], (float)vt[r * dp + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const long long base = ((long long)b * Hq + (long long)hk * G) * splits + split;  // head g at + g*splits
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * D) part_acc[(base + (long long)(e / D) * splits) * D + e % D] = acc[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    part_ml[(base + (long long)g * splits) * 2] = mst[g];
    part_ml[(base + (long long)g * splits) * 2 + 1] = lst[g];
  }
}

// Grid (Hq, B): combine the live splits of one (b, head) into o (B, Hq, D) f32.
__global__ void decode_combine_kernel(const float* __restrict__ part_ml,
                                      const float* __restrict__ part_acc, float* __restrict__ out,
                                      int Hq, int D, int kv_len, int chunk, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int live = min(splits, (kv_len + chunk - 1) / chunk);
  const long long base = ((long long)b * Hq + h) * splits;
  float m = kMask;
  for (int s = 0; s < live; ++s) m = fmaxf(m, part_ml[(base + s) * 2]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < live; ++s) {
    const float w = expf(part_ml[(base + s) * 2] - m);
    l = fmaf(w, part_ml[(base + s) * 2 + 1], l);
    if (d < D) a = fmaf(w, part_acc[(base + s) * D + d], a);
  }
  if (d < D) out[((long long)b * Hq + h) * D + d] = a / fmaxf(l, 1e-37f);
}

template <int PAIRS>
int launch_split(dim3 grid, size_t smem, cudaStream_t s, const void* q, const int8_t* k,
                 const int8_t* v, const void* ks, const void* vs, float* ml, float* acc, int Hq,
                 int Hk, int S, int D, int kv_len, int chunk, int splits, float scale, int q_bf16,
                 int s_bf16, int vec, const Strides& st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<PAIRS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_split_kernel<PAIRS><<<grid, kThreads, smem, s>>>(q, k, v, ks, vs, ml, acc, Hq, Hk, S, D,
                                                          kv_len, chunk, splits, scale, q_bf16,
                                                          s_bf16, vec, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_decode_int8_smem_bytes(int G, int D) { return (int)smem_bytes(G, D); }

// q (B, Hq, D) f32/bf16; k, v int8 (B, Hk, S, D); k_scale, v_scale (B, Hk, S) f32/bf16,
// all through `strides` (14 element strides, see Strides); out (B, Hq, D) f32 contiguous;
// part_ml (B, Hq, splits, 2) and part_acc (B, Hq, splits, D) f32 scratch.  Positions
// [split * chunk, (split + 1) * chunk) form a split.  Launches on `stream` and returns
// cudaGetLastError() of the launches (0 on success).
extern "C" int repro_flash_decode_int8(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale, void* part_ml,
                                       void* part_acc, void* out, int B, int Hq, int Hk, int S,
                                       int D, int kv_len, int chunk, int splits, float scale,
                                       int q_bf16, int s_bf16, int vec, const long long* strides,
                                       void* stream) {
  if (Hk <= 0 || Hq % Hk || D <= 0 || D > 256 || (Hq / Hk) * D > kThreads * kMaxPairs ||
      kv_len < 1 || kv_len > S || chunk % kTK || (long long)chunk * splits < S)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  long long* f = &st.q_b;
  for (int i = 0; i < 14; ++i) f[i] = strides[i];
  const int G = Hq / Hk;
  const int pairs = (G * D + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)splits, (unsigned)Hk, (unsigned)B);
  const size_t smem = smem_bytes(G, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
#define REPRO_SPLIT(P)                                                                          \
  launch_split<P>(grid, smem, s, q, kp, vp, k_scale, v_scale, ml, acc, Hq, Hk, S, D, kv_len, \
                  chunk, splits, scale, q_bf16, s_bf16, vec, st)
  int err;
  if (pairs <= 1) err = REPRO_SPLIT(1);
  else if (pairs <= 2) err = REPRO_SPLIT(2);
  else if (pairs <= 4) err = REPRO_SPLIT(4);
  else if (pairs <= 8) err = REPRO_SPLIT(8);
  else if (pairs <= 16) err = REPRO_SPLIT(16);
  else err = REPRO_SPLIT(32);
#undef REPRO_SPLIT
  if (err != 0) return err;
  decode_combine_kernel<<<dim3((unsigned)Hq, (unsigned)B), (unsigned)((D + 31) / 32 * 32), 0, s>>>(
      ml, acc, static_cast<float*>(out), Hq, D, kv_len, chunk, splits);
  return static_cast<int>(cudaGetLastError());
}
