// Grouped matmul for Hopper (sm_90a): gmm and its weight-gradient tgmm.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul/kernel.py
// (gmm_pallas, pallas_call at :69) and the weight gradient of its custom VJP
// (src/repro/kernels/grouped_matmul/ops.py:45-52, there lax.ragged_dot).
//
//   gmm : y[m, :]  = x[m, :] @ w[g(m)]       rows sorted by group g
//   tgmm: dw[g]    = x[rows of g]^T @ dy[rows of g]
//
// offsets = [0, cumsum(group_sizes)] is read from device memory, so group
// sizes stay runtime data (one build serves every row split) and the host
// never waits for the card.  Empty groups are legal: their rows do not exist
// (gmm) or their dw[g] is written as exact zeros (tgmm).
//
// What bounds it on the card: memory.  At the FEMNIST client sizes of a
// ragged wave (32 clients, ~1,280 rows, K = 784, N = 128) the stacked
// per-client weights are ~12.8 MB against ~4 MB of activations and ~0.26
// GFLOP, i.e. ~5 us of HBM traffic at 3.35 TB/s against ~4 us of f32 FFMA at
// 67 TFLOP/s.  The design therefore reads each input tile once per block and
// writes each output element exactly once:
//   * The TPU kernel zeroes `out` at g == 0 and accumulates `+=` over a
//     sequential group axis of its grid.  Blocks on Hopper run in parallel and
//     in no order, so here a block owns one (TM, TN) output tile, finds the
//     groups that intersect its rows by binary search over `offsets`, and
//     loops over them with the other rows masked to zero: no atomics, no
//     second pass, no zero-fill launch.
//   * The ragged edges (K = 784, N = 62 are multiples of no tile) are masked
//     inside the kernel instead of padding copies as the TPU wrapper does.
//   * f32 inputs accumulate with f32 FFMA (the parity tolerance is 2e-5,
//     which a single TF32 pass would miss); bf16 inputs are widened on load
//     and accumulate in f32 too.  Outputs are written in the input dtype.
// A shared-memory tiled FFMA kernel; wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;      // output tile edge (TM = TN for gmm, TK = TN for tgmm)
constexpr int kDepth = 16;     // reduction depth staged per shared-memory tile
constexpr int kPad = 4;        // shared-memory row padding

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// y (M, N) = x (M, K) @ w[g(m)]; w[g, k, n] at w + g*w_sg + k*w_sk + n*w_sn, so a
// transposed view (dx = dy @ w^T) is read in place.
template <typename T>
__global__ void __launch_bounds__(kThreads) gmm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ offsets,
    T* __restrict__ y, int M, int K, int N, int G, long long w_sg, long long w_sk,
    long long w_sn) {
  __shared__ float xs[kDepth][kTile + kPad];  // xs[k][m]
  __shared__ float ws[kDepth][kTile + kPad];  // ws[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4] = {};

  // first group whose rows end after m0 (offsets is nondecreasing)
  int lo = 0, hi = G;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (offsets[mid + 1] <= m0) lo = mid + 1; else hi = mid;
  }
  for (int g = lo; g < G; ++g) {
    const int start = max(offsets[g], 0);
    const int end = min(offsets[g + 1], M);
    if (start >= m0 + kTile) break;
    if (end <= start) continue;  // empty group: no rows to compute
    const T* wg = w + g * w_sg;
    for (int k0 = 0; k0 < K; k0 += kDepth) {
      for (int e = tid; e < kTile * kDepth; e += kThreads) {
        const int r = e / kDepth, c = e % kDepth;
        const int row = m0 + r, col = k0 + c;
        xs[c][r] = (row >= start && row < end && col < K)
                       ? load_f(x + (long long)row * K + col) : 0.f;
      }
      for (int e = tid; e < kTile * kDepth; e += kThreads) {
        int kk, nn;  // neighbouring threads on neighbouring addresses
        if (w_sn == 1) { kk = e / kTile; nn = e % kTile; } else { nn = e / kDepth; kk = e % kDepth; }
        const int kr = k0 + kk, nc = n0 + nn;
        ws[kk][nn] = (kr < K && nc < N) ? load_f(wg + kr * w_sk + nc * w_sn) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  // every in-range element exactly once; rows outside all groups stay 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) store_f(y + (long long)row * N + col, acc[i][j]);
    }
  }
}

// dw (G, K, N): block (blockIdx.x, blockIdx.y, g) owns one (kTile, kTile) tile
// of dw[g] and loops over the rows of group g.
template <typename T>
__global__ void __launch_bounds__(kThreads) tgmm_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const int* __restrict__ offsets,
    T* __restrict__ dw, int M, int K, int N) {
  __shared__ float xs[kDepth][kTile + kPad];  // xs[r][k]
  __shared__ float ds[kDepth][kTile + kPad];  // ds[r][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile, g = blockIdx.z;
  const int start = max(offsets[g], 0);
  const int end = min(offsets[g + 1], M);
  float acc[4][4] = {};

  for (int r0 = start; r0 < end; r0 += kDepth) {
    for (int e = tid; e < kTile * kDepth; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const int row = r0 + r;
      xs[r][c] = (row < end && k0 + c < K) ? load_f(x + (long long)row * K + k0 + c) : 0.f;
      ds[r][c] = (row < end && n0 + c < N) ? load_f(dy + (long long)row * N + n0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kDepth; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ds[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // an empty group skips the loop and writes exact zeros
  T* out = dw + (long long)g * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) store_f(out + (long long)kr * N + col, acc[i][j]);
    }
  }
}

inline unsigned blocks(int n) { return (unsigned)((n + kTile - 1) / kTile); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each entry launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int repro_gmm(int dtype, const void* x, const void* w, const void* offsets,
                         void* y, int M, int K, int N, int G, long long w_sg,
                         long long w_sk, long long w_sn, void* stream) {
  const dim3 grid(blocks(N), blocks(M));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* offs = static_cast<const int*>(offsets);
  if (dtype == 0) {
    gmm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), offs,
        static_cast<float*>(y), M, K, N, G, w_sg, w_sk, w_sn);
  } else if (dtype == 1) {
    gmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), offs,
        static_cast<__nv_bfloat16*>(y), M, K, N, G, w_sg, w_sk, w_sn);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_tgmm(int dtype, const void* x, const void* dy, const void* offsets,
                          void* dw, int M, int K, int N, int G, void* stream) {
  const dim3 grid(blocks(N), blocks(K), (unsigned)G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* offs = static_cast<const int*>(offsets);
  if (dtype == 0) {
    tgmm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), offs,
        static_cast<float*>(dw), M, K, N);
  } else if (dtype == 1) {
    tgmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), offs,
        static_cast<__nv_bfloat16*>(dw), M, K, N);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
