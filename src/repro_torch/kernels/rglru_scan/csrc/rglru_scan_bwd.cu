// RG-LRU linear recurrence, the backward, for Hopper (sm_90a): d log_a and
// db of the forward in rglru_scan.cu from the cotangents of y and h_L.
//
// Replaces the backward of the TPU kernel's custom VJP
// (src/repro/kernels/rglru_scan/ops.py:23-26, _bwd: the vjp of
// ref.rglru_associative); the Pallas kernel (kernel.py:44, pallas_call at
// :58) is a forward only.
//
// With a_t = exp(log_a_t), h_t = a_t h_{t-1} + b_t from h_{-1} = 0, the
// cotangents dy (B, L, W) and dh_L (B, W; absent means 0):
//
//   g_t      = dy_t + [t = L-1] dh_L
//   dh_t     = g_t + a_{t+1} dh_{t+1},   dh_L = 0 past the end
//   db_t     = dh_t                       (in b's dtype)
//   dlog_a_t = dh_t a_t h_{t-1}           (f32)
//
// The reverse scan is the forward's (product, value) monoid walked last to
// first: a segment [t0, t1) run from a zero carry leaves a_{t0} dh_{t0}, and
// a carry c entering it from the right leaves that plus (prod of the
// segment's own decays) c.  So the product a segment passes left is the
// forward's seg_a.
//
// h_{t-1} is needed in forward order while dh runs in reverse.  The
// reference saves (log_a, b) and recomputes h; so does this kernel, in f32,
// into an f32 workspace (B, L, W) that the wrapper allocates.  Taking the
// forward's y instead would hold h exactly only where b is f32, would keep y
// alive until the backward, and would tie the gradient's bits to which
// forward ran; recomputing gives one path for f32 and bf16 b alike.
//
// The design is the forward's: a block owns 32 lanes (one coalesced
// 128-byte row of W) of one batch row and splits L into kSplits = 8
// segments, one warp each.  Four passes over a segment:
//   1. forward from h = 0: the segment's decay product and end state; the
//      pairs meet in shared memory and each thread folds those before its
//      own into h_in, the state entering its segment;
//   2. forward from h_in, writing h to the workspace;
//   3. reverse from a zero carry: the carry the segment passes left; the
//      carries meet in shared memory and each thread folds those after its
//      own (last first, with the segments' decay products) into the carry
//      entering its segment from the right;
//   4. reverse from that carry: dh, then db and dlog_a with h_{t-1} read
//      back from the workspace (h_in at the segment's first step).
// f32 throughout; bf16 b and dy widen on load and db is rounded on store.
// No atomics: every element is written by one thread in a fixed order, so
// the result has the same bits run to run.  Any L is taken (L = 1 too).
//
// What bounds it on the card: bytes.  At recurrentgemma-9b's training shape
// (B = 8, L = 128, W = 4096, f32) the backward must read log_a, b and dy and
// write dlog_a and db: 83.9 MB, 0.0250 ms at 3.35 TB/s, against ~6 flops
// an element.  This kernel reads log_a four times, b twice, dy twice, and
// writes and reads the workspace once: ~2.4x those bytes (201 MB at f32),
// and the four dependent chains a segment.  rglru_scan_bwd_onchip.cu keeps
// a segment on chip between the passes for L up to its capacity (4096);
// this kernel is the path above it, where it takes any L.

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
// dh_final: (B, W) contiguous f32 or null; h_ws, dlog_a and db: (B, L, W)
// contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_bwd_kernel(
    const float* __restrict__ log_a, const T* __restrict__ bx, const T* __restrict__ dy,
    const float* __restrict__ dh_final, float* __restrict__ h_ws, float* __restrict__ dlog_a,
    T* __restrict__ db, int L, int W, long long la_sb, long long la_sl, long long b_sb,
    long long b_sl, long long dy_sb, long long dy_sl) {
  __shared__ float seg_a[kSplits][kLanes];  // product of a segment's decays
  __shared__ float seg_v[kSplits][kLanes];  // pass 1: end state from h = 0; pass 3: carry out from 0
  const int lane = threadIdx.x % kLanes, k = threadIdx.x / kLanes;
  const int w = blockIdx.x * kLanes + lane, b = blockIdx.y;
  const bool on = w < W;
  const int len = (L + kSplits - 1) / kSplits;
  const int t_begin = min(L, k * len), t_end = min(L, t_begin + len);
  const float* la = log_a + b * la_sb + w;
  const T* bp = bx + b * b_sb + w;
  const T* gp = dy + b * dy_sb + w;
  const long long out = (long long)b * L * W + w;   // (b, 0, w) of the contiguous outputs
  float* hp = h_ws + out;

  // 1. forward from h = 0
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
  seg_v[k][lane] = hl;
  __syncthreads();
  float h_in = 0.f;  // the state entering segment k: h_{t_begin - 1}
  for (int j = 0; j < k; ++j) h_in = fmaf(seg_a[j][lane], h_in, seg_v[j][lane]);
  __syncthreads();   // seg_v is written again in pass 3

  // 2. forward from h_in, h into the workspace
  if (on) {
    float h = h_in;
#pragma unroll 8
    for (int t = t_begin; t < t_end; ++t) {
      h = fmaf(expf(la[(long long)t * la_sl]), h, load_f(bp + (long long)t * b_sl));
      hp[(long long)t * W] = h;
    }
  }

  // 3. reverse from a zero carry
  const float g_last = (on && dh_final != nullptr) ? dh_final[(long long)b * W + w] : 0.f;
  float c = 0.f;
  if (on) {
#pragma unroll 8
    for (int t = t_end - 1; t >= t_begin; --t) {
      const float dh = load_f(gp + (long long)t * dy_sl) + (t == L - 1 ? g_last : 0.f) + c;
      c = expf(la[(long long)t * la_sl]) * dh;
    }
  }
  seg_v[k][lane] = c;
  __syncthreads();
  float c_in = 0.f;  // the carry entering segment k from the right: a_{t_end} dh_{t_end}
  for (int j = kSplits - 1; j > k; --j) c_in = fmaf(seg_a[j][lane], c_in, seg_v[j][lane]);
  if (!on) return;

  // 4. reverse from c_in: the gradients
  c = c_in;
#pragma unroll 8
  for (int t = t_end - 1; t >= t_begin; --t) {
    const float at = expf(la[(long long)t * la_sl]);
    const float dh = load_f(gp + (long long)t * dy_sl) + (t == L - 1 ? g_last : 0.f) + c;
    const float h_prev = t == t_begin ? h_in : hp[(long long)(t - 1) * W];
    dlog_a[out + (long long)t * W] = dh * at * h_prev;
    store_f(db + out + (long long)t * W, dh);
    c = at * dh;
  }
}

template <typename T>
int launch(const float* log_a, const void* bx, const void* dy, const float* dh_final,
           float* h_ws, float* dlog_a, void* db, int B, int L, int W, const long long* st,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((W + kLanes - 1) / kLanes), (unsigned)B);
  rglru_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      log_a, static_cast<const T*>(bx), static_cast<const T*>(dy), dh_final, h_ws, dlog_a,
      static_cast<T*>(db), L, W, st[0], st[1], st[2], st[3], st[4], st[5]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of b, dy and db: 0 = float32, 1 = bfloat16; log_a, dh_final, the
// workspace and dlog_a are float32.  dh_final may be null (a zero
// cotangent).  strides: (batch, length) of log_a, b and dy in elements, 6
// values.  Launches on `stream` and returns the CUDA error of the launch (0
// on success).
extern "C" int repro_rglru_scan_bwd(int dtype, const void* log_a, const void* bx, const void* dy,
                                    const void* dh_final, void* h_ws, void* dlog_a, void* db,
                                    int B, int L, int W, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* dhf = static_cast<const float*>(dh_final);
  float* ws = static_cast<float*>(h_ws);
  float* dla = static_cast<float*>(dlog_a);
  if (dtype == 0) return launch<float>(la, bx, dy, dhf, ws, dla, db, B, L, W, strides, s);
  if (dtype == 1) return launch<__nv_bfloat16>(la, bx, dy, dhf, ws, dla, db, B, L, W, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
