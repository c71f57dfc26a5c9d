// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (rglru_pallas, pallas_call at :58) and its wrapper
// src/repro/kernels/rglru_scan/ops.py:15.
//
//   h_t = exp(log_a_t) h_{t-1} + b_t,   h_0 = 0,   y_t = h_t
// for every (batch, lane) of (B, L, W) inputs; y in b's dtype, h_L in f32.
//
// What bounds it on the card: bytes, and the length of the dependent chain.
// At the serve shape of recurrentgemma-9b (B = 4, L = 2048, W = 4096, f32
// log_a and b) the scan moves ~403 MB (two inputs read, y written): 0.12 ms
// at 3.35 TB/s, against 2 flops a step.  The TPU kernel runs the recurrence
// sequentially over time with the width as a vector and carries h across a
// *sequential* chunk axis of its grid.  Ported literally that is one thread
// a lane: 16,384 threads, each a dependent chain of 2,048 steps, too few to
// keep the card's memory busy.  The design, a two-pass chunked scan inside
// one block:
//   * A block owns 32 lanes (one coalesced 128-byte row of W) of one batch
//     row and splits L into kSplits = 8 segments, one warp each: 512 blocks
//     of 256 threads at the serve shape, every one resident at once.
//   * Pass 1: each thread runs its segment from h = 0, keeping the segment's
//     end state and the product of its decays.
//   * The segments' (product, end state) pairs meet in shared memory; each
//     thread folds those before its own into the state entering it.
//   * Pass 2: each thread reruns its segment from that state, writing y.
// The inputs are read twice (~670 MB moved, 0.2 ms at the memory rate);
// keeping a segment on chip between the passes is later work.  f32
// throughout; bf16 b widens on load and y is rounded to it on store.  Any
// L is taken (the TPU kernel needs L to be a multiple of its chunk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;   // lanes of W a block covers
constexpr int kSplits = 8;   // segments of L a block splits, one warp each
constexpr int kThreads = kLanes * kSplits;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Grid: (lane tiles of W, B).  Strides in elements; W is unit-stride.
// h_final: (B, W) contiguous f32.
template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_kernel(
    const float* __restrict__ log_a, const T* __restrict__ bx, T* __restrict__ y,
    float* __restrict__ h_final, int L, int W, long long la_sb, long long la_sl,
    long long b_sb, long long b_sl, long long y_sb, long long y_sl) {
  __shared__ float seg_a[kSplits][kLanes];  // product of a segment's decays
  __shared__ float seg_h[kSplits][kLanes];  // a segment's end state from h = 0
  const int lane = threadIdx.x % kLanes, k = threadIdx.x / kLanes;
  const int w = blockIdx.x * kLanes + lane, b = blockIdx.y;
  const bool on = w < W;
  const int len = (L + kSplits - 1) / kSplits;
  const int t_begin = min(L, k * len), t_end = min(L, t_begin + len);
  const float* la = log_a + b * la_sb + w;
  const T* bp = bx + b * b_sb + w;

  float prod = 1.f, hl = 0.f;
  if (on) {
#pragma unroll 8
    for (int t = t_begin; t < t_end; ++t) {
      const float at = expf(la[(long long)t * la_sl]);
      hl = fmaf(at, hl, load_f(bp + (long long)t * b_sl));
      prod *= at;
    }
  }
  seg_a[k][lane] = prod;
  seg_h[k][lane] = hl;
  __syncthreads();

  float h = 0.f;  // the state entering segment k
  for (int j = 0; j < k; ++j) h = fmaf(seg_a[j][lane], h, seg_h[j][lane]);
  if (!on) return;
  T* yp = y + b * y_sb + w;
#pragma unroll 8
  for (int t = t_begin; t < t_end; ++t) {
    h = fmaf(expf(la[(long long)t * la_sl]), h, load_f(bp + (long long)t * b_sl));
    store_f(yp + (long long)t * y_sl, h);
  }
  if (k == kSplits - 1) h_final[(long long)b * W + w] = h;
}

template <typename T>
int launch(const float* log_a, const void* bx, void* y, float* h_final, int B, int L, int W,
           const long long* st, cudaStream_t stream) {
  const dim3 grid((unsigned)((W + kLanes - 1) / kLanes), (unsigned)B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      log_a, static_cast<const T*>(bx), static_cast<T*>(y), h_final, L, W, st[0], st[1],
      st[2], st[3], st[4], st[5]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of b and y: 0 = float32, 1 = bfloat16; log_a is float32.  strides:
// (batch, length) of log_a, b and y in elements, 6 values.  Launches on
// `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int repro_rglru_scan(int dtype, const void* log_a, const void* bx, void* y,
                                void* h_final, int B, int L, int W, const long long* strides,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  float* hf = static_cast<float*>(h_final);
  if (dtype == 0) return launch<float>(la, bx, y, hf, B, L, W, strides, s);
  if (dtype == 1) return launch<__nv_bfloat16>(la, bx, y, hf, B, L, W, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
