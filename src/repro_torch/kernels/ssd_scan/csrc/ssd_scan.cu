// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_pallas, pallas_call at :82) and the padding and layout transposes of
// its wrapper src/repro/kernels/ssd_scan/ops.py:22-35.
//
// For each (batch b, head h) with group g = h / (H/G), over time t:
//   S_t = exp(a_h dt_t) S_{t-1} + (dt_t x_t) B_t^T        (P x N state, f32, S_0 = 0)
//   y_t = S_t C_t
// computed chunk by chunk as the state-space duality does it: within a
// chunk of Q rows, with cs the inclusive cumsum of a_h dt,
//   y   = (C B^T o seg)(x dt) + exp(cs) o (C S^T),   seg[t][s] = exp(cs_t - cs_s), s <= t
//   S  <- exp(cs_Q) S + (x dt o exp(cs_Q - cs))^T B.
//
// What bounds it on the card: bytes.  At the serve shape of mamba2-1.3b
// (B = 4, L = 2048, H = 64, P = 64, G = 1, N = 128, bf16 x, B, C) the scan
// moves ~149 MB (x in, y out, the f32 state out) against ~17 GFLOP of
// recurrence, so 0.044 ms of HBM traffic against 0.017 ms on the bf16 tensor
// cores; at the f32 FFMA rate this kernel uses the operations take ~0.26 ms.
// The design:
//   * The TPU kernel holds a whole chunk of the model's ssm_chunk = 256 rows
//     in VMEM and carries the state across a *sequential* grid axis.  A
//     256-row chunk needs ~540 KB here, over the 227 KB a block may have;
//     the chunk length does not change the function, so one block per
//     (b, h) walks L in chunks of kQ = 32 rows with the state in shared
//     memory: ~79 KB a block at P = 64, N = 128, two blocks an SM, and the
//     serve shape's 256 blocks all resident at once.
//   * kQ = 32 is one warp: warp 0 takes the chunk's prefix and suffix sums
//     of a dt with shuffles.  The exponents cs_t - cs_s and cs_Q - cs_t are
//     summed directly over their own rows, never taken as differences of
//     two cumsums: those cancel (at |a dt| ~ 7 a row the cumsum reaches
//     ~200 in 32 rows and the difference keeps ~5 digits), and the step
//     recurrence is matched to f32 rounding.  s > t is never exponentiated
//     (the reference's "mask the ARGUMENT before exp").
//   * Head h reads group h / (H/G) of B and C in place (at G = 1 all heads of
//     a batch row read the same B and C, from L2); x, dt, B, C and y are read
//     and written in the model's (B, L, H, P) layout through strides: no
//     transposed or repeated copies.
//   * A ragged tail is masked as the reference pads it: dt = 0 and zero x, B,
//     C past L, so the decay is 1, nothing enters the state, and the final
//     state is exact.
//   * f32 FFMA throughout (the parity tolerance is 2e-5, which TF32 would
//     miss); bf16 inputs widen on load, y is written in x's dtype.
// That C B^T is the same for every head of a group (all 64 heads at G = 1)
// is left for a redesign, as are mma/wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kQ = 32;         // rows of an internal chunk: one warp

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Shared memory of one block for head-size bucket PM and state-size bucket NM.
template <int PM, int NM>
struct Layout {
  static constexpr int LN = NM + 1;  // padded rows of C, B and the state
  static constexpr int LP = PM + 1;  // padded rows of x dt
  static constexpr int LQ = kQ + 1;  // padded rows of the scores
  static constexpr int floats = 2 * kQ * LN + kQ * LP + kQ * LQ + PM * LN + 4 * kQ;
  static constexpr int bytes = floats * static_cast<int>(sizeof(float));
};

// Grid: (H, B).  Strides in elements; the last dimension of x, B, C, y is
// unit-stride.  state: (B, H, P, N) contiguous f32.
template <typename T, int PM, int NM>
__global__ void __launch_bounds__(kThreads, 2) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
    float* __restrict__ state, int L, int H, int P, int G, int N,
    long long x_sb, long long x_sl, long long x_sh, long long dt_sb, long long dt_sl,
    long long dt_sh, long long b_sb, long long b_sl, long long b_sg, long long c_sb,
    long long c_sl, long long c_sg, long long y_sb, long long y_sl, long long y_sh) {
  using Lay = Layout<PM, NM>;
  constexpr int LN = Lay::LN, LP = Lay::LP, LQ = Lay::LQ;
  constexpr int IP = PM / 16, JN = NM / 16;
  extern __shared__ float smem[];
  float* c_s = smem;               // [kQ][LN]  C of the chunk
  float* b_s = c_s + kQ * LN;      // [kQ][LN]  B of the chunk
  float* x_s = b_s + kQ * LN;      // [kQ][LP]  x dt
  float* sc_s = x_s + kQ * LP;     // [kQ][LQ]  C B^T o seg
  float* st_s = sc_s + kQ * LQ;    // [PM][LN]  the state entering the chunk
  float* dt_s = st_s + PM * LN;    // [kQ]      dt
  float* adt_s = dt_s + kQ;        // [kQ]      a dt
  float* ecs_s = adt_s + kQ;       // [kQ]      exp(a dt summed over rows 0..t)
  float* ew_s = ecs_s + kQ;        // [kQ]      exp(a dt summed over rows t+1..kQ-1)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float ah = a[h];
  const T* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* bb = bm + b * b_sb + g * b_sg;
  const T* cb = cm + b * c_sb + g * c_sg;
  T* yb = y + b * y_sb + h * y_sh;

  for (int e = tid; e < PM * LN; e += kThreads) st_s[e] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kQ) {
    __syncthreads();  // the last chunk's reads of every buffer are done
    if (tid < kQ) {   // warp 0: dt, a dt (zero past L), its prefix and suffix sums
      const float d = t0 + tid < L ? dtb[(long long)(t0 + tid) * dt_sl] : 0.f;
      const float ad = ah * d;
      float pre = ad, suf = ad;
#pragma unroll
      for (int off = 1; off < kQ; off *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, pre, off);
        const float w = __shfl_down_sync(0xffffffffu, suf, off);
        if (tid >= off) pre += u;
        if (tid + off < kQ) suf += w;
      }
      const float after = __shfl_down_sync(0xffffffffu, suf, 1);  // rows t+1..kQ-1
      dt_s[tid] = d;
      adt_s[tid] = ad;
      ecs_s[tid] = expf(pre);
      ew_s[tid] = tid + 1 < kQ ? expf(after) : 1.f;
    }
    for (int e = tid; e < kQ * NM; e += kThreads) {
      const int r = e / NM, c = e % NM;
      const bool in = t0 + r < L && c < N;
      c_s[r * LN + c] = in ? load_f(cb + (long long)(t0 + r) * c_sl + c) : 0.f;
      b_s[r * LN + c] = in ? load_f(bb + (long long)(t0 + r) * b_sl + c) : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < kQ * PM; e += kThreads) {
      const int r = e / PM, c = e % PM;
      x_s[r * LP + c] =
          t0 + r < L && c < P ? load_f(xb + (long long)(t0 + r) * x_sl + c) * dt_s[r] : 0.f;
    }
    {  // scores: rows ty + 16 i, columns tx + 16 j
      float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
      for (int n = 0; n < NM; ++n) {
        const float c0 = c_s[ty * LN + n], c1 = c_s[(ty + 16) * LN + n];
        const float b0 = b_s[tx * LN + n], b1 = b_s[(tx + 16) * LN + n];
        sc[0][0] = fmaf(c0, b0, sc[0][0]);
        sc[0][1] = fmaf(c0, b1, sc[0][1]);
        sc[1][0] = fmaf(c1, b0, sc[1][0]);
        sc[1][1] = fmaf(c1, b1, sc[1][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          float e = 0.f;  // a dt summed over rows s+1..t
          for (int r = s + 1; r <= t; ++r) e += adt_s[r];
          sc_s[t * LQ + s] = s <= t ? sc[i][j] * expf(e) : 0.f;
        }
    }
    __syncthreads();

    {  // y: rows ty + 16 i, head columns tx + 16 j
      float acc[2][IP], inter[2][IP];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < IP; ++j) acc[i][j] = inter[i][j] = 0.f;
#pragma unroll 8
      for (int s = 0; s < kQ; ++s) {
        const float s0 = sc_s[ty * LQ + s], s1 = sc_s[(ty + 16) * LQ + s];
#pragma unroll
        for (int j = 0; j < IP; ++j) {
          const float xv = x_s[s * LP + tx + 16 * j];
          acc[0][j] = fmaf(s0, xv, acc[0][j]);
          acc[1][j] = fmaf(s1, xv, acc[1][j]);
        }
      }
#pragma unroll 8
      for (int n = 0; n < NM; ++n) {
        const float c0 = c_s[ty * LN + n], c1 = c_s[(ty + 16) * LN + n];
#pragma unroll
        for (int j = 0; j < IP; ++j) {
          const float sv = st_s[(tx + 16 * j) * LN + n];
          inter[0][j] = fmaf(c0, sv, inter[0][j]);
          inter[1][j] = fmaf(c1, sv, inter[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = ty + 16 * i;
        if (t0 + t >= L) continue;
#pragma unroll
        for (int j = 0; j < IP; ++j) {
          const int col = tx + 16 * j;
          if (col < P)
            store_f(yb + (long long)(t0 + t) * y_sl + col, acc[i][j] + ecs_s[t] * inter[i][j]);
        }
      }
    }
    __syncthreads();  // every read of the state entering this chunk is done

    {  // the state: rows ty + 16 i, state columns tx + 16 j
      float acc[IP][JN];
#pragma unroll
      for (int i = 0; i < IP; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int t = 0; t < kQ; ++t) {
        const float w = ew_s[t];
        float xv[IP], bv[JN];
#pragma unroll
        for (int i = 0; i < IP; ++i) xv[i] = x_s[t * LP + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < JN; ++j) bv[j] = b_s[t * LN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < IP; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float decay = ecs_s[kQ - 1];
#pragma unroll
      for (int i = 0; i < IP; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          float* sp = st_s + (ty + 16 * i) * LN + tx + 16 * j;
          *sp = decay * *sp + acc[i][j];
        }
    }
  }

  __syncthreads();
  float* sb = state + ((long long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) sb[e] = st_s[(e / N) * LN + e % N];
}

template <typename T, int PM, int NM>
int launch(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
           void* y, float* state, int B, int L, int H, int P, int G, int N,
           const long long* st, cudaStream_t stream) {
  constexpr int bytes = Layout<PM, NM>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, PM, NM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)H, (unsigned)B);
  ssd_kernel<T, PM, NM><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), state, L, H, P, G, N, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
             void* y, float* state, int B, int L, int H, int P, int G, int N,
             const long long* st, cudaStream_t s) {
  if (P <= 16 && N <= 32) return launch<T, 16, 32>(x, dt, a, bm, cm, y, state, B, L, H, P, G, N, st, s);
  if (P <= 16 && N <= 128) return launch<T, 16, 128>(x, dt, a, bm, cm, y, state, B, L, H, P, G, N, st, s);
  if (P <= 64 && N <= 32) return launch<T, 64, 32>(x, dt, a, bm, cm, y, state, B, L, H, P, G, N, st, s);
  if (P <= 64 && N <= 128) return launch<T, 64, 128>(x, dt, a, bm, cm, y, state, B, L, H, P, G, N, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dynamic shared memory of one block for head size P and state size N (0: not supported).
extern "C" int repro_ssd_scan_smem_bytes(int P, int N) {
  if (P <= 0 || N <= 0) return 0;
  if (P <= 16 && N <= 32) return Layout<16, 32>::bytes;
  if (P <= 16 && N <= 128) return Layout<16, 128>::bytes;
  if (P <= 64 && N <= 32) return Layout<64, 32>::bytes;
  if (P <= 64 && N <= 128) return Layout<64, 128>::bytes;
  return 0;
}

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt and a are float32.
// strides: (batch, length, head-or-group) of x, dt, B, C and y in elements,
// 15 values.  Launches on `stream` and returns the CUDA error of the launch
// (0 on success).
extern "C" int repro_ssd_scan(int dtype, const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y, void* state, int B,
                              int L, int H, int P, int G, int N, const long long* strides,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* stf = static_cast<float*>(state);
  if (dtype == 0)
    return dispatch<float>(x, dtf, af, bm, cm, y, stf, B, L, H, P, G, N, strides, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dtf, af, bm, cm, y, stf, B, L, H, P, G, N, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
