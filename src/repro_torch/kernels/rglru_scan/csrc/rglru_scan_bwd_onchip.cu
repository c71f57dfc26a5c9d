// RG-LRU linear recurrence, the backward on chip, for Hopper (sm_90a): d log_a
// and db of the forward in rglru_scan.cu from the cotangents of y and h_L,
// with every input read from device memory once and no workspace.
//
// Replaces the backward of the TPU kernel's custom VJP
// (src/repro/kernels/rglru_scan/ops.py:23-26, _bwd: the vjp of
// ref.rglru_associative); the Pallas kernel (kernel.py:44, pallas_call at
// :58) is a forward only.  It computes what rglru_scan_bwd.cu computes:
//
//   g_t      = dy_t + [t = L-1] dh_L
//   dh_t     = g_t + a_{t+1} dh_{t+1},   dh_L = 0 past the end
//   db_t     = dh_t                       (in b's dtype)
//   dlog_a_t = dh_t a_t h_{t-1}           (f32)
//
// with the same segment algebra: a segment [t0, t1) run forward from h = 0
// leaves its decay product and end state, run in reverse from a zero carry
// the carry a_{t0} dh_{t0} it passes left; the pairs fold in order into the
// state entering each segment from the left and the carry entering it from
// the right.
//
// What bounds it on the card: bytes.  At recurrentgemma-9b's training shape
// (B = 8, L = 128, W = 4096, f32) the backward must read log_a, b and dy
// and write dlog_a and db: 83.9 MB, 0.0250 ms at 3.35 TB/s, against ~6
// flops an element.  The four-pass kernel (rglru_scan_bwd.cu) moves ~2.4x
// that: it reads log_a four times and b and dy twice, and writes and reads
// an f32 workspace of h.  Here a thread loads its segment once into
// registers and everything else happens on chip:
//   * A block owns 32 lanes (one coalesced 128-byte row of W) and `warps`
//     segments of L, one warp each, a segment at most S steps held in
//     registers as a (decay), x (b, then h) and g (the cotangent, dh_L
//     folded in).  Steps past a segment's end hold the identity (a = 1, b
//     = g = 0), so the sweeps are straight-line code over S (every register
//     array is indexed by a constant: nothing spills to local memory) and
//     only the loads and stores are predicated.
//   * Where L needs more than one block, `cluster` blocks of one lane tile
//     form a thread-block cluster (at most 8, the portable size) and
//     exchange their summaries through distributed shared memory.  So the
//     on-chip path holds L <= 32 x 16 x 8 = 4096 (kCapacity); the wrapper
//     sends longer L to the four-pass kernel.
//   * One pass over the registers runs each segment forward from h = 0 and
//     in reverse from a zero carry; the (decay product, end state, carry)
//     triples meet in shared memory.  In a cluster warp 0 folds the block's
//     triples into the block's own, a cluster barrier publishes them, and
//     warp 0 folds its peers' (the blocks before it for the state, those
//     after it, last first, for the carry) into what enters the block.
//     Each thread then folds the segments before and after its own.
//   * A forward pass from the entering state overwrites b with h, and a
//     reverse pass from the entering carry writes db and dlog_a.
//   * A second cluster barrier, split into an arrive after warp 0's reads
//     and a wait before the exit, keeps every block's shared memory alive
//     until its peers have read it.
// Two builds of the kernel, and the launch shape (len, warps, cluster)
// from the wrapper (ops.onchip_schedule): up to L = 1024 the short kernel,
// S = 16 steps, 8 warps a block (at most 85 registers: three blocks an
// SM), in clusters of ceil(L / 128); above it the long kernel, S = 32, 8
// warps in clusters of ceil(L / 256) up to L = 2048, then 9 to 16 warps in
// clusters of 8 (at most 128 registers).  recurrentgemma's training L =
// 128 is one block of the short kernel, its serve L = 2048 a cluster of 8
// of the long one.  Loads and stores are streaming (ld.global.cs,
// st.global.cs); a = exp2(log2(e) log_a) on the SFU.  f32 throughout; bf16
// b and dy widen on load and db is rounded on store.  No atomics, and
// every fold runs in a fixed order, so the result has the same bits run to
// run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;                                   // lanes of W a block covers
constexpr int kShortSteps = 16;                              // steps a thread of the short kernel
constexpr int kSteps = 32;                                   // the most steps a thread holds
constexpr int kWarps = 8;                                    // segments a block up to L = 2048
constexpr int kMaxWarps = 16;                                // segments a block, one warp each
constexpr int kMaxCluster = 8;                               // blocks a cluster (portable)
constexpr int kCapacity = kSteps * kMaxWarps * kMaxCluster;  // the longest L on chip
constexpr int kMaxStride = 0x7fffffff / kSteps;              // a length stride, or W
constexpr float kLog2e = 1.4426950408889634f;

// streaming loads and stores: every element is read or written once
__device__ __forceinline__ float load_f(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcs(p));
}
__device__ __forceinline__ void store_f(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  __stcs(p, __float2bfloat16(v));
}

// the first NW segments' triples of one lane, all the loads in flight before the folds
template <int NW>
__device__ __forceinline__ void load_segments(const float (*seg_a)[kLanes],
                                              const float (*seg_h)[kLanes],
                                              const float (*seg_c)[kLanes], int lane, float* sa,
                                              float* sh, float* sc) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    sa[j] = seg_a[j][lane];
    sh[j] = seg_h[j][lane];
    sc[j] = seg_c[j][lane];
  }
}

// the short kernel (S = 16) runs blocks of 8 warps, three an SM; the long one
// (S = 32) blocks of up to 16, at up to 128 registers a thread
template <int S>
__host__ __device__ constexpr int max_threads() {
  return kLanes * (S == kShortSteps ? kWarps : kMaxWarps);
}
template <int S>
__host__ __device__ constexpr int min_blocks() { return S == kShortSteps ? 3 : 1; }

// Grid: (lane tiles of W x cluster, B) in clusters of (cluster, 1, 1); block
// (warps x 32).  Segment s = rank x warps + warp covers [s len, (s + 1) len),
// len <= S.  Strides in elements; W is unit-stride; a step's offset inside a
// segment is a 32-bit int (S times a length stride or W fits one: the entry
// checks), which keeps the addresses of a segment's loads in few registers.
// dh_final: (B, W) contiguous f32 or null; dlog_a and db: (B, L, W)
// contiguous.
template <typename T, int S>
__global__ void __launch_bounds__(max_threads<S>(), min_blocks<S>()) rglru_bwd_onchip_kernel(
    const float* __restrict__ log_a, const T* __restrict__ bx, const T* __restrict__ dy,
    const float* __restrict__ dh_final, float* __restrict__ dlog_a, T* __restrict__ db, int L,
    int W, int len, int cluster, long long la_sb, int la_sl, long long b_sb, int b_sl,
    long long dy_sb, int dy_sl) {
  __shared__ float seg_a[kMaxWarps][kLanes];  // a segment's decay product
  __shared__ float seg_h[kMaxWarps][kLanes];  // its end state from h = 0
  __shared__ float seg_c[kMaxWarps][kLanes];  // the carry it passes left from a zero carry
  __shared__ float blk[3][kLanes];            // the block's own triple, read by its peers
  __shared__ float enter[2][kLanes];          // the state and carry entering the block
  constexpr int kBlockWarps = max_threads<S>() / kLanes;   // the most segments a block
  const int lane = threadIdx.x % kLanes, k = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const int rank = blockIdx.x % cluster;  // the block's rank in its cluster
  const int w = (blockIdx.x / cluster) * kLanes + lane, b = blockIdx.y;
  const bool on = w < W;
  const int t0 = (rank * warps + k) * len;    // the segment's first step
  const int n = on ? min(len, L - t0) : 0;    // its steps of L (none past L)
  const float* la = log_a + b * la_sb + (long long)t0 * la_sl + w;
  const T* bp = bx + b * b_sb + (long long)t0 * b_sl + w;
  const T* gp = dy + b * dy_sb + (long long)t0 * dy_sl + w;
  const float g_last = (on && dh_final != nullptr) ? dh_final[(long long)b * W + w] : 0.f;

  float a[S], x[S], g[S];   // x: b, then h
#pragma unroll
  for (int i = 0; i < S; ++i) {  // every load in flight before the first use
    const bool live = i < n;
    a[i] = live ? load_f(la + i * la_sl) : 0.f;   // exp(0) = 1: the identity past the end
    x[i] = live ? load_f(bp + i * b_sl) : 0.f;
    g[i] = live ? load_f(gp + i * dy_sl) + (t0 + i == L - 1 ? g_last : 0.f) : 0.f;
  }

  // the segment from h = 0 and from a zero carry
  float prod = 1.f, hl = 0.f, cl = 0.f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    a[i] = exp2f(a[i] * kLog2e);
    hl = fmaf(a[i], hl, x[i]);
    prod *= a[i];
  }
#pragma unroll
  for (int i = S - 1; i >= 0; --i) cl = a[i] * (g[i] + cl);
  seg_a[k][lane] = prod;
  seg_h[k][lane] = hl;
  seg_c[k][lane] = cl;
  __syncthreads();

  float h_in = 0.f, c_in = 0.f;  // entering the block
  float sa[kBlockWarps], sh[kBlockWarps], sc[kBlockWarps];  // the block's segments
  if (cluster > 1) {
    cg::cluster_group group = cg::this_cluster();
    if (k == 0) {
      load_segments<kBlockWarps>(seg_a, seg_h, seg_c, lane, sa, sh, sc);
      float pa = 1.f, ph = 0.f, pc = 0.f;
#pragma unroll
      for (int j = 0; j < kBlockWarps; ++j) {
        if (j < warps) {
          ph = fmaf(sa[j], ph, sh[j]);
          pa *= sa[j];
        }
      }
#pragma unroll
      for (int j = kBlockWarps - 1; j >= 0; --j)
        if (j < warps) pc = fmaf(sa[j], pc, sc[j]);
      blk[0][lane] = pa;
      blk[1][lane] = ph;
      blk[2][lane] = pc;
    }
    group.sync();  // every block's triple visible to its peers
    if (k == 0) {
      float ra[kMaxCluster], rh[kMaxCluster], rc[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {  // every peer's loads in flight at once
        ra[r] = 1.f;
        rh[r] = rc[r] = 0.f;
        if (r < cluster && r != rank) {
          const float* p = group.map_shared_rank(&blk[0][0], r);
          ra[r] = p[lane];
          rh[r] = p[kLanes + lane];
          rc[r] = p[2 * kLanes + lane];
        }
      }
      float h = 0.f, c = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < rank) h = fmaf(ra[r], h, rh[r]);
#pragma unroll
      for (int r = kMaxCluster - 1; r >= 0; --r)
        if (r > rank && r < cluster) c = fmaf(ra[r], c, rc[r]);
      enter[0][lane] = h;
      enter[1][lane] = c;
    }
    // done reading the peers: the matching wait comes before the exit
    asm volatile("barrier.cluster.arrive;" ::: "memory");
    __syncthreads();
    h_in = enter[0][lane];
    c_in = enter[1][lane];
  }
  load_segments<kBlockWarps>(seg_a, seg_h, seg_c, lane, sa, sh, sc);
#pragma unroll
  for (int j = 0; j < kBlockWarps; ++j)
    if (j < k) h_in = fmaf(sa[j], h_in, sh[j]);
#pragma unroll
  for (int j = kBlockWarps - 1; j >= 0; --j)
    if (j > k && j < warps) c_in = fmaf(sa[j], c_in, sc[j]);

  // h from the entering state, over b
  float h = h_in;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    h = fmaf(a[i], h, x[i]);
    x[i] = h;
  }
  // the gradients from the entering carry
  const long long out = ((long long)b * L + t0) * W + w;   // (b, t0, w) of the outputs
  float* dla = dlog_a + out;
  T* dbp = db + out;
  float c = c_in;
#pragma unroll
  for (int i = S - 1; i >= 0; --i) {
    const float dh = g[i] + c;
    if (i < n) {
      store_f(dla + i * W, dh * a[i] * (i == 0 ? h_in : x[i - 1]));
      store_f(dbp + i * W, dh);
    }
    c = a[i] * dh;
  }
  if (cluster > 1) asm volatile("barrier.cluster.wait;" ::: "memory");
}

template <typename T, int S>
int launch(const float* log_a, const void* bx, const void* dy, const float* dh_final,
           float* dlog_a, void* db, int B, int L, int W, int len, int warps, int cluster,
           const long long* st, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((W + kLanes - 1) / kLanes) * cluster), (unsigned)B);
  cfg.blockDim = dim3((unsigned)(warps * kLanes));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, rglru_bwd_onchip_kernel<T, S>, log_a, static_cast<const T*>(bx),
      static_cast<const T*>(dy), dh_final, dlog_a, static_cast<T*>(db), L, W, len, cluster,
      st[0], (int)st[1], st[2], (int)st[3], st[4], (int)st[5]);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_steps(const float* log_a, const void* bx, const void* dy, const float* dh_final,
                 float* dlog_a, void* db, int B, int L, int W, int len, int warps, int cluster,
                 const long long* st, cudaStream_t stream) {
  if (len <= kShortSteps && warps <= kWarps)
    return launch<T, kShortSteps>(log_a, bx, dy, dh_final, dlog_a, db, B, L, W, len, warps,
                                  cluster, st, stream);
  return launch<T, kSteps>(log_a, bx, dy, dh_final, dlog_a, db, B, L, W, len, warps, cluster, st,
                           stream);
}

}  // namespace

// the longest L the on-chip kernel takes
extern "C" int repro_rglru_scan_bwd_onchip_capacity() { return kCapacity; }

// dtype of b, dy and db: 0 = float32, 1 = bfloat16; log_a, dh_final and
// dlog_a are float32.  dh_final may be null (a zero cotangent).  strides:
// (batch, length) of log_a, b and dy in elements, 6 values; each length
// stride and W at most kMaxStride (else cudaErrorInvalidValue).  (len, warps,
// cluster): steps a segment (1 to 32), segments a block (1 to 16), blocks a
// cluster (1 to 8), covering L; len <= 16 with warps <= 8 runs the short
// kernel.  Launches once on `stream` and returns the CUDA error of the
// launch (0 on success).
extern "C" int repro_rglru_scan_bwd_onchip(int dtype, const void* log_a, const void* bx,
                                           const void* dy, const void* dh_final, void* dlog_a,
                                           void* db, int B, int L, int W, int len, int warps,
                                           int cluster, const long long* strides, void* stream) {
  if (B < 1 || L < 1 || W < 1 || len < 1 || len > kSteps || warps < 1 || warps > kMaxWarps ||
      cluster < 1 || cluster > kMaxCluster || (long long)len * warps * cluster < L ||
      W > kMaxStride)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 1; i < 6; i += 2)
    if (strides[i] > kMaxStride || strides[i] < -kMaxStride)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* dhf = static_cast<const float*>(dh_final);
  float* dla = static_cast<float*>(dlog_a);
  if (dtype == 0)
    return launch_steps<float>(la, bx, dy, dhf, dla, db, B, L, W, len, warps, cluster, strides,
                               s);
  if (dtype == 1)
    return launch_steps<__nv_bfloat16>(la, bx, dy, dhf, dla, db, B, L, W, len, warps, cluster,
                                       strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
