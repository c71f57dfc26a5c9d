// Grouped matmul for Hopper (sm_90a): gmm and its weight-gradient tgmm.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul/kernel.py
// (gmm_pallas, pallas_call at :69) and the weight gradient of its custom VJP
// (src/repro/kernels/grouped_matmul/ops.py:45-52, there lax.ragged_dot).
//
//   gmm : y[m, :]  = x[m, :] @ w[g(m)]       rows sorted by group g
//   tgmm: dw[g]    = x[rows of g]^T @ dy[rows of g]
//
// Group sizes are runtime data on the card: the wrapper turns them into
// `bounds` (G + 2 row bounds, [0, end of group 0, ..., end of group G-1, M];
// part G is the rows past the groups, written as zeros) and, for the tiled
// paths, `prefix` (G + 2 running counts of the parts' row tiles), with torch
// ops on the card.  The host never reads them, so one build serves every row
// split.  Empty groups are legal: they own no tile (gmm) or their dw[g] is
// written as exact zeros (tgmm).
//
// The TPU kernel walks a dense grid of aligned row tiles in order and masks
// the rows of each group it meets.  On 132 SMs that leaves most SMs idle at
// small M and makes a tile that straddles g groups go over K g times.  Here
// every block owns one (part, row tile within the part, column tile): the
// grid is the host's upper bound (ceil(M / TM) + G) x ceil(N / TN), a block
// finds its part by binary search over `prefix` and exits past the last
// tile.  Each block reads one expert's weights and one group's rows, and each
// output element is written once (the tail part's blocks write the zeros).
// What bounds each regime, and the path the wrapper picks for it from M, K,
// N, G and the dtype:
//   * few rows a group (an MoE decode step: 32 rows over ~30 live experts,
//     M <= 4 G): bytes, the live experts' weights (126 MB at olmoe's width).
//     gmm_stream_kernel: one block per (group, 64-column slab) streams its
//     K x 64 slab once through a 4-stage cp.async ring of 16-byte copies,
//     with the group's few rows staged beside it; empty groups exit at once.
//   * many rows a group in bf16 (an MoE prefill): operations (275 GFLOP a
//     product at olmoe's prefill).  gmm_wgmma_kernel: 128 x 256 tiles on the
//     tensor cores, two warpgroups each issuing wgmma m64n256k16 from shared
//     memory (the forward's N-major weights through the transposed-B mode),
//     f32 accumulators in registers, a 4-stage cp.async ring of 64-deep K
//     slices in 128-byte-swizzled shared memory (192 KB, dynamic) that keeps
//     two slices loading while one wgmma group runs.  The wide tile cuts
//     what every block reads from L2 for its operations by a quarter
//     against a 128 x 128 tile.
//   * f32 (the FL waves and their backward; the parity tolerance is 2e-5,
//     which TF32 would miss), and bf16 shapes whose rows are not 16-byte
//     multiples: gmm_ffma_kernel, FFMA from a double-buffered shared-memory
//     ring (4-byte cp.async for f32), 32 x 32 tiles, so a FEMNIST wave's
//     784 -> 128 layer puts ~190 blocks in flight (bytes bound it there),
//     or, where the grid has blocks to spare (operations bound it), 128 x
//     128 tiles of 8 x 8 outputs a thread read from shared memory as float4.
//   * tgmm, dw[g] = x_g^T dy_g over `bounds`, one block a (N tile, K tile,
//     g), no split over rows and no atomics, so dw is deterministic.  dw is
//     most of the bytes.  A FEMNIST wave (f32, <= 64 rows a group; at 784 ->
//     128 dw is 12.85 of 17.8 MB) is bound by bytes; olmoe's prefill (bf16,
//     ~1,000 rows an expert, 274.9 GFLOP a product) by operations.
//     tgmm_ffma_kernel (f32, whose 2e-5 parity TF32 would miss, and bf16
//     rows that are no 16-byte multiple): FFMA from a 4-stage
//     cp.async ring of the widest copies the rows allow (16 bytes; 8 for
//     128 -> 62's 248-byte f32 rows), each thread a run of neighbouring
//     columns stored 16 bytes at once; the tile (64 x 64, 32 x 64, 32 x 32)
//     is the largest whose grid puts eight blocks on every SM, so blocks of
//     ragged groups (16 to 64 rows: 4x apart in work) even out, and
//     128 -> 128 and 128 -> 62 fill the card too.  tgmm_wgmma_kernel
//     (bf16, 16-byte rows): 128 x 256 tiles on the tensor cores (4,096 at
//     olmoe's prefill), 128 x 128 where N <= 128 (224 at FEMNIST's 784 ->
//     128, two blocks an SM), A = x_g^T and B = dy_g read as they lie
//     through wgmma's transposed modes, 64 rows a stage, dw out through
//     shared memory in whole rows.
//     wgmma rather than mma.sync m16n8k16: an FL group is one stage either
//     way and bytes bound it, while olmoe's needs the tensor cores' rate.
// w[g, k, n] is read at w + g*w_sg + k*w_sk + n*w_sn: the forward's (G, K,
// N) with w_sn == 1 and the backward's transposed view with w_sk == 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// two neighbouring elements as f32 (8-byte or 4-byte aligned)
__device__ __forceinline__ float2 load2_f(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !ok
// (src must still be a valid address then: nothing is read from it)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 8 : 0) : "memory");
}
// B bytes global -> shared: asynchronously for 16, 8 and 4; two bytes (bf16
// rows of odd length) have no cp.async, so they are copied in place
template <int B>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, bool ok) {
  if constexpr (B == 16) cp_async16(dst, src, ok);
  else if constexpr (B == 8) cp_async8(dst, src, ok);
  else if constexpr (B == 4) cp_async4(dst, src, ok);
  else *static_cast<uint16_t*>(dst) = ok ? *static_cast<const uint16_t*>(src) : 0;
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The part p of grid row `slot` (prefix[p] <= slot < prefix[p + 1]: a group,
// or p == G, the rows past the groups); false past the last tile.
__device__ __forceinline__ bool find_part(const int* __restrict__ prefix, int G, int slot, int& p) {
  if (slot >= prefix[G + 1]) return false;
  int lo = 0, hi = G;  // the largest p with prefix[p] <= slot skips empty parts
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (prefix[mid] <= slot) lo = mid; else hi = mid - 1;
  }
  p = lo;
  return true;
}

template <typename T>
__device__ void zero_fill(T* __restrict__ y, int r0, int r1, int N, int c0, int c1) {
  const int cols = c1 - c0;
  for (int e = threadIdx.x; e < (r1 - r0) * cols; e += blockDim.x)
    store_f(y + (long long)(r0 + e / cols) * N + c0 + e % cols, 0.f);
}

// ------------------------------------------------------------------ FFMA tiles

constexpr int kDepth = 16;  // reduction depth of one shared-memory stage
constexpr int kPad = 4;     // shared-memory row padding

// one element into shared memory as f32: f32 asynchronously, bf16 widened on load
__device__ __forceinline__ void stage_elem(float* dst, const float* src, bool ok) {
  cp_async4(dst, src, ok);
}
__device__ __forceinline__ void stage_elem(float* dst, const __nv_bfloat16* src, bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.f;
}

// Block (column tile, grid row) owns a TM x TN tile of one part; each thread
// RM x RN outputs, strided so that shared-memory reads broadcast: where RM
// and RN are multiples of 4, in runs of 4 neighbours read as one float4.
template <typename T, int TM, int TN, int RM, int RN>
__global__ void __launch_bounds__((TM / RM) * (TN / RN)) gmm_ffma_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ bounds,
    const int* __restrict__ prefix, T* __restrict__ y, int M, int K, int N, int G,
    long long w_sg, long long w_sk, long long w_sn) {
  constexpr int kThreads = (TM / RM) * (TN / RN);
  constexpr int kTX = TN / RN, kTY = TM / RM;
  constexpr bool kQuads = RM % 4 == 0 && RN % 4 == 0;
  __shared__ __align__(16) float xs[2][kDepth][TM + kPad];  // xs[buf][k][m]
  __shared__ __align__(16) float ws[2][kDepth][TN + kPad];  // ws[buf][k][n]
  // the tile row of the thread's i-th output row, the tile column of its j-th
  auto row_of = [](int ty, int i) { return kQuads ? (i / 4) * kTY * 4 + ty * 4 + i % 4 : ty + kTY * i; };
  auto col_of = [](int tx, int j) { return kQuads ? (j / 4) * kTX * 4 + tx * 4 + j % 4 : tx + kTX * j; };
  int p;
  if (!find_part(prefix, G, blockIdx.y, p)) return;
  const int row0 = bounds[p] + (blockIdx.y - prefix[p]) * TM;
  const int row1 = min(row0 + TM, bounds[p + 1]);
  const int n0 = blockIdx.x * TN;
  if (p == G) {
    zero_fill(y, row0, row1, N, n0, min(n0 + TN, N));
    return;
  }
  const T* wg = w + p * w_sg;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;

  auto load = [&](int buf, int k0) {
    for (int e = tid; e < TM * kDepth; e += kThreads) {
      const int r = e / kDepth, c = e % kDepth;  // neighbouring threads along k
      const int row = row0 + r, col = k0 + c;
      const bool ok = row < row1 && col < K;
      stage_elem(&xs[buf][c][r], ok ? x + (long long)row * K + col : x, ok);
    }
    for (int e = tid; e < TN * kDepth; e += kThreads) {
      int kk, nn;  // neighbouring threads on neighbouring addresses
      if (w_sn == 1) { kk = e / TN; nn = e % TN; } else { nn = e / kDepth; kk = e % kDepth; }
      const int kr = k0 + kk, nc = n0 + nn;
      const bool ok = kr < K && nc < N;
      stage_elem(&ws[buf][kk][nn], ok ? wg + kr * w_sk + nc * w_sn : wg, ok);
    }
    cp_async_commit();
  };

  float acc[RM][RN] = {};
  const int nk = (K + kDepth - 1) / kDepth;
  if (nk > 0) load(0, 0);
  for (int s = 0; s < nk; ++s) {
    const int buf = s & 1;
    if (s + 1 < nk) {
      load(buf ^ 1, (s + 1) * kDepth);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[RM], b[RN];
      if constexpr (kQuads) {
#pragma unroll
        for (int i = 0; i < RM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&xs[buf][kk][row_of(ty, i)]);
          a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < RN; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&ws[buf][kk][col_of(tx, j)]);
          b[j] = v.x, b[j + 1] = v.y, b[j + 2] = v.z, b[j + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = xs[buf][kk][row_of(ty, i)];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = ws[buf][kk][col_of(tx, j)];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + row_of(ty, i);
    if (row >= row1) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = n0 + col_of(tx, j);
      if (col < N) store_f(y + (long long)row * N + col, acc[i][j]);
    }
  }
}

// ------------------------------------------------------ bf16 warpgroup MMA

constexpr int kWgM = 128, kWgN = 256, kWgK = 64;  // block tile, K slice of a stage
constexpr int kWgStages = 4;
constexpr int kWgThreads = 256;                   // 2 warpgroups, 64 rows each
constexpr int kWgABytes = kWgM * kWgK * 2, kWgBBytes = kWgN * kWgK * 2;
constexpr int kWgStageBytes = kWgABytes + kWgBBytes;       // 48 KB
constexpr int kWgSmem = kWgStages * kWgStageBytes + 1024;  // + room to align to 1 KB

// d (64 x 256, f32, in the registers of a warpgroup) += A (64 x 16) B (16 x 256),
// both read from shared memory through their descriptors; TnspA: A is M-major,
// TnspB: B is N-major (the transposed modes)
template <int TnspA, int TnspB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TnspA), "n"(TnspB));
}

// the same with 128 columns: d (64 x 128) += A (64 x 16) B (16 x 128)
template <int TnspA, int TnspB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TnspA), "n"(TnspB));
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Shared memory of a stage, every 8-row atom of 1 KB swizzled by row % 8:
// A (x) as 128 rows of 64 k (128 bytes a row, K-major); B (w) in the
// forward's N-major layout as four 64-column panels of 64 k-rows (the
// descriptor's leading offset steps panels, its stride offset 8 k-rows),
// in the backward's K-major view as 256 n-rows of 64 k (like A).
template <bool KMajorB>
__global__ void __launch_bounds__(kWgThreads, 1) gmm_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ bounds, const int* __restrict__ prefix,
    __nv_bfloat16* __restrict__ y, int M, int K, int N, int G, long long w_sg,
    long long w_sk, long long w_sn) {
  extern __shared__ uint8_t smem_raw[];
  int p;
  if (!find_part(prefix, G, blockIdx.y, p)) return;
  const int row0 = bounds[p] + (blockIdx.y - prefix[p]) * kWgM;
  const int row1 = min(row0 + kWgM, bounds[p + 1]);
  const int n0 = blockIdx.x * kWgN;
  if (p == G) {
    zero_fill(y, row0, row1, N, n0, min(n0 + kWgN, N));
    return;
  }
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const __nv_bfloat16* wg = w + p * w_sg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wgi = warp >> 2;

  auto load = [&](int stage, int k0) {
    uint8_t* a_s = smem + stage * kWgStageBytes;
    uint8_t* b_s = a_s + kWgABytes;
#pragma unroll
    for (int i = 0; i < kWgABytes / 16 / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads, r = c >> 3, ch = c & 7;
      const int row = row0 + r, col = k0 + ch * 8;
      const bool ok = row < row1 && col < K;
      cp_async16(a_s + r * 128 + ((ch ^ (r & 7)) << 4), ok ? x + (long long)row * K + col : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kWgBBytes / 16 / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads;
      if (KMajorB) {
        const int r = c >> 3, ch = c & 7;  // r: column n of the tile
        const int nn = n0 + r, kk = k0 + ch * 8;
        const bool ok = nn < N && kk < K;
        cp_async16(b_s + r * 128 + ((ch ^ (r & 7)) << 4), ok ? wg + nn * w_sn + kk : wg, ok);
      } else {
        const int r = c >> 5, ch = c & 31;  // r: depth k of the stage; ch: 8 columns
        const int kk = k0 + r, nn = n0 + ch * 8;
        const bool ok = kk < K && nn < N;
        cp_async16(b_s + (ch >> 3) * (kWgK * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4),
                   ok ? wg + kk * w_sk + nn : wg, ok);
      }
    }
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const int nk = (K + kWgK - 1) / kWgK;
#pragma unroll
  for (int s = 0; s < kWgStages - 2; ++s) {
    if (s < nk) load(s, s * kWgK);
    cp_async_commit();
  }
  const uint32_t base = smem_addr(smem);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kWgStages - 3>();  // slice kt has landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... visible to wgmma
    __syncthreads();                 // every thread's; and wgmma of slice kt - 2 is done
    const int next = kt + kWgStages - 2;
    if (next < nk) load(next % kWgStages, next * kWgK);
    cp_async_commit();
    const uint32_t a_s = base + (kt % kWgStages) * kWgStageBytes + wgi * 64 * 128;
    const uint32_t b_s = base + (kt % kWgStages) * kWgStageBytes + kWgABytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kWgK / 16; ++kk) {
      const uint64_t da = smem_desc(a_s + kk * 32, 16, 1024);
      if (KMajorB)
        wgmma_m64n256k16<0, 0>(acc, da, smem_desc(b_s + kk * 32, 16, 1024));
      else
        wgmma_m64n256k16<0, 1>(acc, da, smem_desc(b_s + kk * 16 * 128, kWgK * 128, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // slice kt - 1 is done
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  cp_async_wait<0>();
  // accumulator layout: warp (warp & 3) of the warpgroup holds rows 16 (warp & 3) ..
  // + 15; register 4j + 2h + e is (row lane / 4 + 8h, column 8j + 2 (lane % 4) + e)
  const int r_base = row0 + wgi * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kWgN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane & 3);  // N % 8 == 0: the pair is in or out
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_base + 8 * h;
      if (row < row1)
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------ weight streaming

constexpr int kStRows = 8;      // a group's rows a pass (a decode group has 1-4)
constexpr int kStN = 64;        // columns a block
constexpr int kStStages = 4;
constexpr int kStThreads = 256; // 8 warps
constexpr int kStStageBytes = kStN * 128 + kStRows * 128;  // w slice + x slice: 9 KB

// Block (slab, p) computes y[rows of group p, slab] = x[rows] @ w[p][:, slab],
// kStRows rows a pass, streaming the K x 64 slab in slices of SK = 128 bytes
// of k a row (64 bf16, 32 f32).  N-major w: warp q takes k in its eighth of
// the slice and lane l columns 2l, 2l+1; the 8 warps' sums meet in shared
// memory.  K-major w: warp q takes columns 8q..8q+7 and lane l its k of the
// slice; the sums meet by warp shuffles.  Block (slab, G) writes the zeros.
template <typename T, bool KMajorB>
__global__ void __launch_bounds__(kStThreads) gmm_stream_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ bounds,
    T* __restrict__ y, int M, int K, int N, int G, long long w_sg, long long w_sk,
    long long w_sn) {
  constexpr int E = 16 / sizeof(T);   // elements in a 16-byte chunk
  constexpr int SK = 128 / sizeof(T); // k of a slice
  __shared__ __align__(16) uint8_t ring[kStStages * kStStageBytes];
  const int p = blockIdx.y, n0 = blockIdx.x * kStN;
  const int start = bounds[p], end = bounds[p + 1];
  if (end <= start) return;  // an empty group
  if (p == G) {
    zero_fill(y, start, end, N, n0, min(n0 + kStN, N));
    return;
  }
  const T* wg = w + p * w_sg;
  const int tid = threadIdx.x, lane = tid & 31, q = tid >> 5;
  const int nk = (K + SK - 1) / SK;

  for (int r0 = start; r0 < end; r0 += kStRows) {
    const int rows = min(kStRows, end - r0);
    auto load = [&](int stage, int k0) {
      T* w_s = reinterpret_cast<T*>(ring + stage * kStStageBytes);
      T* x_s = w_s + kStN * SK;
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // 512 chunks of w
        const int c = tid + i * kStThreads;
        if (KMajorB) {
          const int r = c >> 3, ch = c & 7;  // r: column of the slab
          const int nn = n0 + r, kk = k0 + ch * E;
          const bool ok = nn < N && kk < K;
          cp_async16(w_s + r * SK + ch * E, ok ? wg + nn * w_sn + kk : wg, ok);
        } else {
          constexpr int kChunks = kStN / E;  // chunks of a k-row
          const int r = c / kChunks, ch = c % kChunks;
          const int kk = k0 + r, nn = n0 + ch * E;
          const bool ok = kk < K && nn < N;
          cp_async16(w_s + r * kStN + ch * E, ok ? wg + kk * w_sk + nn : wg, ok);
        }
      }
      if (tid < kStRows * 8) {  // 64 chunks of x
        const int r = tid >> 3, ch = tid & 7;
        const int kk = k0 + ch * E;
        const bool ok = r < rows && kk < K;
        cp_async16(x_s + r * SK + ch * E, ok ? x + (long long)(r0 + r) * K + kk : x, ok);
      }
    };

    float acc[kStRows][KMajorB ? 8 : 2] = {};
#pragma unroll
    for (int s = 0; s < kStStages - 1; ++s) {
      if (s < nk) load(s, s * SK);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStStages - 2>();
      __syncthreads();
      const int next = kt + kStStages - 1;
      if (next < nk) load(next % kStStages, next * SK);
      cp_async_commit();
      const T* w_s = reinterpret_cast<const T*>(ring + (kt % kStStages) * kStStageBytes);
      const T* x_s = w_s + kStN * SK;
      if (KMajorB) {
        constexpr int KL = SK / 32;  // k a lane: 2 (bf16) or 1 (f32)
        float xv[kStRows][KL];
#pragma unroll
        for (int r = 0; r < kStRows; ++r) {
          if (r >= rows) break;
          if constexpr (KL == 2) {
            const float2 v = load2_f(x_s + r * SK + 2 * lane);
            xv[r][0] = v.x;
            xv[r][KL - 1] = v.y;
          } else {
            xv[r][0] = to_f(x_s[r * SK + lane]);
          }
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const T* wr = w_s + (q * 8 + c) * SK;
          float wv[KL];
          if constexpr (KL == 2) {
            const float2 v = load2_f(wr + 2 * lane);
            wv[0] = v.x;
            wv[KL - 1] = v.y;
          } else {
            wv[0] = to_f(wr[lane]);
          }
#pragma unroll
          for (int r = 0; r < kStRows; ++r) {
            if (r >= rows) break;
#pragma unroll
            for (int j = 0; j < KL; ++j) acc[r][c] = fmaf(xv[r][j], wv[j], acc[r][c]);
          }
        }
      } else {
        constexpr int KW = SK / 8;  // k a warp: 8 (bf16) or 4 (f32)
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          const int k = q * KW + j;
          const float2 wv = load2_f(w_s + k * kStN + 2 * lane);
#pragma unroll
          for (int r = 0; r < kStRows; ++r) {
            if (r >= rows) break;
            const float xv = to_f(x_s[r * SK + k]);
            acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
            acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: the N-major sums meet in it
    if (KMajorB) {
#pragma unroll
      for (int r = 0; r < kStRows; ++r) {
        if (r >= rows) break;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float v = acc[r][c];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          const int col = n0 + q * 8 + c;
          if (lane == c && col < N) store_f(y + (long long)(r0 + r) * N + col, v);
        }
      }
    } else {
      float* red = reinterpret_cast<float*>(ring);  // red[q][r][n]: 16 KB
#pragma unroll
      for (int r = 0; r < kStRows; ++r) {
        if (r >= rows) break;
        red[(q * kStRows + r) * kStN + 2 * lane] = acc[r][0];
        red[(q * kStRows + r) * kStN + 2 * lane + 1] = acc[r][1];
      }
      __syncthreads();
      for (int e = tid; e < rows * kStN; e += kStThreads) {
        const int r = e / kStN, c = e % kStN;
        float v = 0.f;
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) v += red[(qq * kStRows + r) * kStN + c];
        if (n0 + c < N) store_f(y + (long long)(r0 + r) * N + n0 + c, v);
      }
    }
    __syncthreads();  // the ring is loaded again by the next pass
  }
}

// -------------------------------------------------------------------- tgmm
//
// dw[g] = x[rows of g]^T @ dy[rows of g]: block (N tile, K tile, g) owns one
// tile of dw[g] and walks the group's rows [bounds[g], bounds[g + 1]); each
// element of dw is written once, by one block, with no split over rows and no
// atomics, and an empty group's tile is written as exact zeros.

constexpr int kTgDepth = 16;  // ffma: a group's rows a stage

// R neighbouring elements of shared memory as f32 (R a multiple of 4)
template <int R>
__device__ __forceinline__ void read_run(const float* p, float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
  }
}
template <int R>
__device__ __forceinline__ void read_run(const __nv_bfloat16* p, float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p + i);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[i] = lo.x, v[i + 1] = lo.y, v[i + 2] = hi.x, v[i + 3] = hi.y;
  }
}
// pins the accumulators in their registers, so that no other instruction
// defines them inside a wgmma pipeline stage (which would serialize it)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// four neighbouring results, 16-byte aligned (f32) or 8-byte (bf16), and two, half that
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}
__device__ __forceinline__ void store2(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v[0], v[1]);
}

// Path ffma: a TK x TN tile of dw[g], each thread RK rows (k) by RN
// neighbouring columns (n).  The group's rows come in stages of kTgDepth
// through an S-stage cp.async ring that keeps S - 1 stages loading (all of
// an FL group's <= 64 rows at S = 4), VB bytes a copy (16 where x's and dy's
// rows allow, else 8, 4 or 2: the wrapper picks the widest that divides both
// rows and both bases); rows past the group and k, n past the edges are
// zero-filled.  A thread reads its RK x-values and RN dy-values of a row as
// runs of 4 (the warp's x runs broadcast), and writes its RN columns with
// 16-byte stores where N % 4 == 0, else pairs or single elements.
template <typename T, int TK, int TN, int RK, int RN, int S, int VB>
__global__ void __launch_bounds__((TK / RK) * (TN / RN)) tgmm_ffma_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const int* __restrict__ bounds,
    T* __restrict__ dw, int K, int N) {
  constexpr int kThreads = (TK / RK) * (TN / RN), kTX = TN / RN;
  constexpr int E = VB / sizeof(T);  // elements a copy
  static_assert(E >= 1 && TK % E == 0 && TN % E == 0 && RK % 4 == 0 && RN % 4 == 0 && S >= 2,
                "tile");
  __shared__ __align__(16) T xs[S][kTgDepth][TK];  // xs[stage][r][k]
  __shared__ __align__(16) T ds[S][kTgDepth][TN];  // ds[stage][r][n]
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int n0 = blockIdx.x * TN, k0 = blockIdx.y * TK, g = blockIdx.z;
  const int start = bounds[g], end = max(bounds[g + 1], start);

  auto load = [&](int stage, int r0) {
    for (int c = tid; c < kTgDepth * (TK / E); c += kThreads) {
      const int r = c / (TK / E), col = (c % (TK / E)) * E;  // neighbouring threads along k
      const int row = r0 + r, kk = k0 + col;
      const bool ok = row < end && kk < K;                 // K % E == 0: in or out whole
      cp_async_n<VB>(&xs[stage][r][col], ok ? x + (long long)row * K + kk : x, ok);
    }
    for (int c = tid; c < kTgDepth * (TN / E); c += kThreads) {
      const int r = c / (TN / E), col = (c % (TN / E)) * E;
      const int row = r0 + r, nn = n0 + col;
      const bool ok = row < end && nn < N;
      cp_async_n<VB>(&ds[stage][r][col], ok ? dy + (long long)row * N + nn : dy, ok);
    }
  };

  float acc[RK][RN] = {};
  const int ns = (end - start + kTgDepth - 1) / kTgDepth;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ns) load(s, start + s * kTgDepth);
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<S - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();         // every thread's; and every thread is done with stage s - 1
    const int next = s + S - 1;
    if (next < ns) load(next % S, start + next * kTgDepth);
    cp_async_commit();
    const int stage = s % S;
#pragma unroll
    for (int r = 0; r < kTgDepth; ++r) {
      float a[RK], b[RN];
      read_run(&xs[stage][r][ty * RK], a);
      read_run(&ds[stage][r][tx * RN], b);
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  // an empty group skips the loop and writes exact zeros
  const int col = n0 + tx * RN, live = min(RN, N - col);
  if (live <= 0) return;
  T* out = dw + (long long)g * K * N + col;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kr = k0 + ty * RK + i;
    if (kr >= K) break;
    T* o = out + (long long)kr * N;
    if (N % 4 == 0) {  // col % 4 == 0: whole runs of four, aligned
#pragma unroll
      for (int j = 0; j < RN; j += 4)
        if (j < live) store4(o + j, &acc[i][j]);
    } else if (N % 2 == 0) {
#pragma unroll
      for (int j = 0; j < RN; j += 2)
        if (j < live) store2(o + j, &acc[i][j]);
    } else {
#pragma unroll
      for (int j = 0; j < RN; ++j)
        if (j < live) store_f(o + j, acc[i][j]);
    }
  }
}

// Path wgmma (bf16, K and N multiples of 8, 16-byte aligned rows): a 128 x
// BN tile of dw[g] on the tensor cores, two warpgroups of 64 rows.  The
// product's M is dw's k (x's columns), its N dw's n, its depth the group's
// rows: A = x_g^T enters M-major and B = dy_g N-major, through the
// transposed-A and -B modes, so x and dy are read as they lie.  A stage
// holds 64 of the group's rows: A as two 64-column panels of x (one a
// warpgroup), B as BN / 64 panels of dy, each panel 64 rows of 128 bytes
// with the 128-byte swizzle (16-byte chunk c of row r at r * 128 + ((c ^ r
// % 8) << 4)); the descriptor's leading offset steps panels, its stride
// offset 8 rows.  A cp.async ring of kStages stages keeps kStages - 2
// slices loading while one wgmma group runs; rows past the group are
// zero-filled.  BN = 256 (where N > 128: olmoe) takes 4 stages, 192 KB, one
// block an SM; BN = 128 (FEMNIST's N = 128) 3 stages, 96 KB, two blocks an
// SM.  The f32 accumulators are rounded to bf16 once and leave through the
// spent ring (swizzled the same way by chunk) in 16-byte stores of whole
// rows.
template <int BN>
struct TgWg {
  static constexpr int kM = 128, kDepth = 64;         // dw rows a block, group rows a stage
  static constexpr int kStages = BN == 256 ? 4 : 3;
  static constexpr int kPanel = kDepth * 128;         // 64 rows of 64 columns: 8 KB
  static constexpr int kABytes = 2 * kPanel, kBBytes = (BN / 64) * kPanel;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + room to align to 1 KB
  static_assert(kStages * kStageBytes >= kM * BN * 2, "dw's tile fits the ring");
};

template <int BN>
__global__ void __launch_bounds__(kWgThreads, BN == 256 ? 1 : 2) tgmm_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const int* __restrict__ bounds, __nv_bfloat16* __restrict__ dw, int K, int N) {
  using L = TgWg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * L::kM, g = blockIdx.z;
  const int start = bounds[g], end = max(bounds[g + 1], start);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wgi = warp >> 2;

  // 64 rows of 128 columns of x (k0 ..) and of BN columns of dy (n0 ..)
  auto load = [&](int stage, int r0) {
    uint8_t* a_s = smem + stage * L::kStageBytes;
    uint8_t* b_s = a_s + L::kABytes;
#pragma unroll
    for (int i = 0; i < L::kABytes / 16 / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads, r = c >> 4, ch = c & 15;
      const int row = r0 + r, kk = k0 + ch * 8;
      const bool ok = row < end && kk < K;
      cp_async16(a_s + (ch >> 3) * L::kPanel + r * 128 + (((ch & 7) ^ (r & 7)) << 4),
                 ok ? x + (long long)row * K + kk : x, ok);
    }
#pragma unroll
    for (int i = 0; i < L::kBBytes / 16 / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads, r = c / (BN / 8), ch = c % (BN / 8);
      const int row = r0 + r, nn = n0 + ch * 8;
      const bool ok = row < end && nn < N;
      cp_async16(b_s + (ch >> 3) * L::kPanel + r * 128 + (((ch & 7) ^ (r & 7)) << 4),
                 ok ? dy + (long long)row * N + nn : dy, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  const int ns = (end - start + L::kDepth - 1) / L::kDepth;
#pragma unroll
  for (int s = 0; s < L::kStages - 2; ++s) {
    if (s < ns) load(s, start + s * L::kDepth);
    cp_async_commit();
  }
  const uint32_t base = smem_addr(smem);
  for (int st = 0; st < ns; ++st) {
    cp_async_wait<L::kStages - 3>();  // slice st has landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... visible to wgmma
    __syncthreads();                  // every thread's; and wgmma of slice st - 2 is done
    const int next = st + L::kStages - 2;
    if (next < ns) load(next % L::kStages, start + next * L::kDepth);
    cp_async_commit();
    const uint32_t a_s = base + (st % L::kStages) * L::kStageBytes + wgi * L::kPanel;
    const uint32_t b_s = base + (st % L::kStages) * L::kStageBytes + L::kABytes;
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < L::kDepth / 16; ++kk) {
      const uint64_t da = smem_desc(a_s + kk * 16 * 128, L::kPanel, 1024);
      const uint64_t db = smem_desc(b_s + kk * 16 * 128, L::kPanel, 1024);
      if constexpr (BN == 256)
        wgmma_m64n256k16<1, 1>(acc, da, db);
      else
        wgmma_m64n128k16<1, 1>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // slice st - 1 is done
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup's wgmma is done: the ring is free
  // accumulator layout: warp (warp & 3) of the warpgroup holds rows 16 (warp & 3) ..
  // + 15; register 4j + 2h + e is (row lane / 4 + 8h, column 8j + 2 (lane % 4) + e)
  constexpr int kPitch = BN * 2;  // bytes of a staged row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wgi * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<uint32_t*>(smem + r * kPitch + ((j ^ (r & 7)) << 4) + 4 * (lane & 3)) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  __syncthreads();
  __nv_bfloat16* out = dw + (long long)g * K * N;
#pragma unroll
  for (int i = 0; i < L::kM * BN / 8 / kWgThreads; ++i) {
    const int c = tid + i * kWgThreads, r = c / (BN / 8), ch = c % (BN / 8);
    const int kr = k0 + r, nn = n0 + ch * 8;
    if (kr < K && nn < N)  // N % 8 == 0: a chunk is in or out whole
      *reinterpret_cast<uint4*>(out + (long long)kr * N + nn) =
          *reinterpret_cast<const uint4*>(smem + r * kPitch + ((ch ^ (r & 7)) << 4));
  }
}

inline unsigned cdiv(int n, int d) { return (unsigned)((n + d - 1) / d); }

// gmm's paths and the (rows, columns) of a block's tile in each; the
// wrapper's table in ops.py is checked against repro_gmm_tile at load.
enum Path { kStream = 0, kFfma = 1, kFfmaWide = 2, kWgmma = 3 };
constexpr int kTileRows[] = {kStRows, 32, 128, kWgM};
constexpr int kTileCols[] = {kStN, 32, 128, kWgN};

template <typename T>
int launch_gmm(int path, const T* x, const T* w, const int* bounds, const int* prefix, T* y,
               int M, int K, int N, int G, long long w_sg, long long w_sk, long long w_sn,
               cudaStream_t s) {
  const unsigned gx = cdiv(N, kTileCols[path]);
  const dim3 tiled(gx, cdiv(M, kTileRows[path]) + (unsigned)G);
  switch (path) {
    case kStream: {
      const dim3 grid(gx, (unsigned)G + 1);
      if (w_sk == 1)
        gmm_stream_kernel<T, true><<<grid, kStThreads, 0, s>>>(x, w, bounds, y, M, K, N, G, w_sg, w_sk, w_sn);
      else
        gmm_stream_kernel<T, false><<<grid, kStThreads, 0, s>>>(x, w, bounds, y, M, K, N, G, w_sg, w_sk, w_sn);
      break;
    }
    case kFfma:
      gmm_ffma_kernel<T, 32, 32, 2, 4><<<tiled, 128, 0, s>>>(
          x, w, bounds, prefix, y, M, K, N, G, w_sg, w_sk, w_sn);
      break;
    case kFfmaWide:
      gmm_ffma_kernel<T, 128, 128, 8, 8><<<tiled, 256, 0, s>>>(
          x, w, bounds, prefix, y, M, K, N, G, w_sg, w_sk, w_sn);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool KMajorB>
int launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, const int* bounds,
                 const int* prefix, __nv_bfloat16* y, int M, int K, int N, int G, long long w_sg,
                 long long w_sk, long long w_sn, cudaStream_t s) {
  const cudaError_t attr = cudaFuncSetAttribute(  // per device: set on every launch
      gmm_wgmma_kernel<KMajorB>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(cdiv(N, kWgN), cdiv(M, kWgM) + (unsigned)G);
  gmm_wgmma_kernel<KMajorB><<<grid, kWgThreads, kWgSmem, s>>>(
      x, w, bounds, prefix, y, M, K, N, G, w_sg, w_sk, w_sn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile of `path`: rows if which == 0, columns if which == 1; -1 for an
// unknown path.
extern "C" int repro_gmm_tile(int path, int which) {
  if (path < kStream || path > kWgmma) return -1;
  return which == 0 ? kTileRows[path] : kTileCols[path];
}

// dtype: 0 = float32, 1 = bfloat16.  Each entry launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).  gmm's `bounds`
// (G + 2 ints) and, for the tiled paths, `prefix` (G + 2 ints) are the
// wrapper's schedule; the stream and wgmma paths need K and N multiples of
// 8 and 16-byte aligned rows; wgmma takes bf16 only.
extern "C" int repro_gmm(int path, int dtype, const void* x, const void* w, const void* bounds,
                         const void* prefix, void* y, int M, int K, int N, int G,
                         long long w_sg, long long w_sk, long long w_sn, void* stream) {
  if (path < kStream || path > kWgmma) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(bounds);
  const int* pre = static_cast<const int*>(prefix);
  if (path == kWgmma) {
    if (dtype != 1 || (w_sk != 1 && w_sn != 1)) return static_cast<int>(cudaErrorInvalidValue);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    return w_sn == 1 ? launch_wgmma<false>(xb, wb, b, pre, yb, M, K, N, G, w_sg, w_sk, w_sn, s)
                     : launch_wgmma<true>(xb, wb, b, pre, yb, M, K, N, G, w_sg, w_sk, w_sn, s);
  }
  if (path == kStream && w_sk != 1 && w_sn != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_gmm<float>(path, static_cast<const float*>(x), static_cast<const float*>(w),
                             b, pre, static_cast<float*>(y), M, K, N, G, w_sg, w_sk, w_sn, s);
  if (dtype == 1)
    return launch_gmm<__nv_bfloat16>(
        path, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), b, pre,
        static_cast<__nv_bfloat16*>(y), M, K, N, G, w_sg, w_sk, w_sn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// tgmm's paths (0 = ffma, 1 = wgmma) and the (K rows, N columns) of a
// block's tile in each, by tile code; the wrapper's table in ops.py is
// checked against repro_tgmm_tile at load.
constexpr int kTgTiles = 3;
constexpr int kTgTileK[2][kTgTiles] = {{64, 32, 32}, {128, 128, 0}};
constexpr int kTgTileN[2][kTgTiles] = {{64, 64, 32}, {128, 256, 0}};

extern "C" int repro_tgmm_tile(int path, int tile, int which) {
  if (path < 0 || path > 1 || tile < 0 || tile >= kTgTiles || kTgTileK[path][tile] == 0) return -1;
  return which == 0 ? kTgTileK[path][tile] : kTgTileN[path][tile];
}

namespace {

template <typename T, int VB>
int launch_tgmm_ffma(int tile, const T* x, const T* dy, const int* bounds, T* dw, int K, int N,
                     int G, cudaStream_t s) {
  const dim3 grid(cdiv(N, kTgTileN[0][tile]), cdiv(K, kTgTileK[0][tile]), (unsigned)G);
  switch (tile) {
    case 0: tgmm_ffma_kernel<T, 64, 64, 8, 4, 4, VB><<<grid, 128, 0, s>>>(x, dy, bounds, dw, K, N); break;
    case 1: tgmm_ffma_kernel<T, 32, 64, 4, 4, 4, VB><<<grid, 128, 0, s>>>(x, dy, bounds, dw, K, N); break;
    case 2: tgmm_ffma_kernel<T, 32, 32, 4, 4, 4, VB><<<grid, 64, 0, s>>>(x, dy, bounds, dw, K, N); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tgmm_ffma_vb(int vbytes, int tile, const void* x, const void* dy, const int* bounds,
                        void* dw, int K, int N, int G, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dwt = static_cast<T*>(dw);
  switch (vbytes) {
    case 16: return launch_tgmm_ffma<T, 16>(tile, xt, dyt, bounds, dwt, K, N, G, s);
    case 8: return launch_tgmm_ffma<T, 8>(tile, xt, dyt, bounds, dwt, K, N, G, s);
    case 4: return launch_tgmm_ffma<T, 4>(tile, xt, dyt, bounds, dwt, K, N, G, s);
    case 2:
      if constexpr (sizeof(T) == 2) return launch_tgmm_ffma<T, 2>(tile, xt, dyt, bounds, dwt, K, N, G, s);
      [[fallthrough]];
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BN>
int launch_tgmm_wgmma(const void* x, const void* dy, const int* bounds, void* dw, int K, int N,
                      int G, cudaStream_t s) {
  const cudaError_t attr = cudaFuncSetAttribute(  // per device: set on every launch
      tgmm_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, TgWg<BN>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(cdiv(N, BN), cdiv(K, TgWg<BN>::kM), (unsigned)G);
  tgmm_wgmma_kernel<BN><<<grid, kWgThreads, TgWg<BN>::kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), bounds,
      static_cast<__nv_bfloat16*>(dw), K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dw (G, K, N) = x_g^T dy_g for the rows [bounds[g], bounds[g + 1]) of each
// group (`bounds`: gmm's G + 2 row bounds, clamped to [0, M]).  path 0
// (ffma) takes f32 and bf16, copying `vbytes` (16, 8, 4; 2 for bf16) a
// cp.async: K and N multiples of vbytes / element size and both bases so
// aligned; path 1 (wgmma) takes bf16 with K and N multiples of 8 and 16-byte
// aligned bases.  `tile` indexes the path's tiles (repro_tgmm_tile).
extern "C" int repro_tgmm(int path, int tile, int dtype, int vbytes, const void* x,
                          const void* dy, const void* bounds, void* dw, int K, int N, int G,
                          void* stream) {
  if (repro_tgmm_tile(path, tile, 0) < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(bounds);
  if (path == 1) {
    if (dtype != 1 || K % 8 != 0 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return tile == 1 ? launch_tgmm_wgmma<256>(x, dy, b, dw, K, N, G, s)
                     : launch_tgmm_wgmma<128>(x, dy, b, dw, K, N, G, s);
  }
  const int e = vbytes / (dtype == 0 ? 4 : 2);
  if (e < 1 || K % e != 0 || N % e != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0 ? launch_tgmm_ffma_vb<float>(vbytes, tile, x, dy, b, dw, K, N, G, s)
                    : launch_tgmm_ffma_vb<__nv_bfloat16>(vbytes, tile, x, dy, b, dw, K, N, G, s);
}
