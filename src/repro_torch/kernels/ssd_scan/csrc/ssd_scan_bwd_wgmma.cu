// Mamba-2 SSD chunked scan, the backward on Hopper's tensor cores (sm_90a),
// path bwd_wgmma: dx, ddt, da, dB and dC of the forward in ssd_scan.cu for
// bf16 whose rows 16-byte copies can read (P and N multiples of 8, P <= 64,
// 32 < N <= 128, the batch, length and head or group strides of x, B, C and
// dY multiples of 8 elements, 16-byte aligned pointers).  f32, and bf16 that
// is not aligned so, take bwd_ffma (ssd_scan_bwd.cu), whose f32 gradients
// hold 1e-4 of an f64 backward, which bf16 operands would miss.
//
// Replaces the backward of the TPU kernel's custom VJP
// (src/repro/kernels/ssd_scan/ops.py:44-49, _bwd: the vjp of
// ref.ssd_chunked at the wrapper's chunk); the Pallas kernel (kernel.py:63,
// pallas_call at :82) is a forward only.  The function is ssd_scan_bwd.cu's
// (its header writes the recurrences out): for each (batch b, head h), chunks
// of kQ = 64 rows walked last first, with dS the adjoint of the state leaving
// the chunk and S_in the state entering it,
//
//   dx_s = dt_s ((seg o G)^T dY + w o (B dS^T))_s       G = C B^T, seg[t][s] = exp(cs_t - cs_s)
//   dB_s = dt_s ((seg o D)^T C  + w o (x dS))_s         D = dY x^T, w_s = exp(cs_Q - cs_s)
//   dC_t = exp(cs_t) (dY S_in)_t + ((seg o D o dt_s) B)_t
//   dS  <- exp(cs_Q) dS + (dY o exp(cs))^T C
//   d(a dt)_r = exp(cs_Q) <dS, S_in> + the state term summed over s < r
//             + the read-out term summed over t >= r + the crossed pairs t >= r > s
//
// What bounds it on the card: bytes.  At mamba2-1.3b's training shape (B =
// 8, L = 128, H = 64, P = 64, G = 1, N = 128) the function reads x, dt, B,
// C and dY and writes dx, ddt, dB and dC: ~26.7 MB, 0.008 ms at 3.35 TB/s,
// against ~7.5 GFLOP of products, ~0.008 ms at the bf16 peak.  ssd_scan_bwd.cu
// ran every product on scalar FFMA in f32 (~10 TFLOP/s issued), one 129 KB
// block an SM.  Here:
//   * ssd_bwd_states_wgmma_kernel: one warpgroup a (b, h) walks L forward in
//     chunks of 64 rows with S an f32 accumulator in registers, updated by
//     the forward's own product (S = exp(cs_Q) S + (x o w)^T B, m64n128k16 x
//     4, x o w rounded to bf16 through the transposed-A mode, B through the
//     transposed-B mode).  It stores each chunk's S_in once, rounded to bf16
//     in the chunk pass's swizzled tile layout (16 KB a chunk, chunk 0's zero
//     state not stored): 8.4 MB at the training shape against the f32
//     (B, H, L/32, P, N) scratch's 67 MB.
//   * ssd_bwd_chunk_wgmma_kernel: one warpgroup a (b, h) walks the chunks
//     last first with dS an f32 accumulator in registers for the whole walk
//     (64 a thread), never rounded; only its bf16 copy in shared memory
//     feeds the products.  Per chunk, M = 64 throughout, every product on
//     wgmma with f32 accumulators, in this order so that the accumulators
//     live one or two at a time (at most 255 registers, two blocks an SM):
//       G^T = B C^T, D^T = x dY^T, D = dY x^T      m64n64k16, K-major operands
//       seg o G^T, seg o D^T (rows s) and seg o D o dt_s (rows t) in registers,
//       each rounded once to bf16: the register A operands below
//       dx:  w o (B dS^T), then += (seg o G)^T dY    dY N-major (transposed B)
//       dB:  w o (x dS),   then += (seg o D)^T C     dS and C N-major
//       dC:  exp(cs) o (dY S_in), then += (seg o D o dt) B
//       dS:  exp(cs_Q) dS + (dY o exp(cs))^T C      transposed A and B, as
//                                                   the forward's state update
//     The crossed term of d(a dt), sum over t >= r > s of W[t][s] = (seg o G
//     o D)[t][s] dt_s, is two passes of f32 sums over the 64 x 64 W tile in
//     shared memory (each row's suffix, then each column's prefix: O(Q^2)
//     over the warpgroup, where ssd_scan_bwd.cu's warp 0 ran O(Q^3)).  Every
//     term of d(a dt) is summed term by term, none a difference of two large
//     sums.  Each chunk's x, then B and S_in, then C, dY and dt of the next
//     chunk are copied in (cp.async, 16 bytes) as soon as this chunk's last
//     read of that tile is done, under the rest of its products; a second
//     block on the SM covers the rest.  Shared memory 101,904 bytes a block;
//     255 registers with 176 bytes spilled (-Xptxas -v): with two blocks an
//     SM, 8 warps, the block waits on latency (each wgmma group, the W
//     passes, the epilogues in turn), not on the tensor cores.
//     dB and dC leave as per-head bf16 partials (B, L, H, N): at G = 1 all 64
//     heads share one B and C, and the partials are the largest byte term
//     (f32 would be 134 MB of ~185 at the training shape; bf16 halves it).
//   * ssd_bwd_group_sum_wgmma_kernel: dB and dC summed over each group's
//     heads in head order in f32 (2 columns a thread, 16 heads' reads in
//     flight), written in bf16; da summed over b.
// Rounding: G and D are exact (bf16 products, f32 sums); the score
// fragments, dS's copy, S_in, x o w, dY o exp(cs) and the partials are each
// rounded once to bf16.  A plain model of exactly this arithmetic
// (tests/test_torch_ssd_schedule.py, bwd_wgmma_model) holds every gradient,
// da included, within 3.7e-3 of jax.vjp of the reference (relative norm, the
// limit 2e-2), where the f32 floor of bf16 outputs is 1.7e-3: no operand
// needs a bf16 hi + lo split.  No atomics anywhere: the same inputs give the
// same bits.  x, dt, B, C, dY and dx are read and written in the model's
// (B, L, H, P) layout through strides; a ragged tail and P, N short of 64 and
// 128 are zero-filled copies (dt = 0 past L: the decay is 1 and nothing
// enters), and nothing is written past L.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/wgmma.cuh"

namespace {

constexpr int kQ = 64;                   // rows of a chunk: wgmma's M
constexpr int kThreads = 128;            // one warpgroup
constexpr int kPM = 64;                  // P pads to 64
constexpr int kNM = 128;                 // N pads to 128
constexpr int kPanel = kQ * 128;         // one 64-column panel of a 64-row tile: 8 KB
constexpr int kTileX = kQ * kPM * 2;     // x, dY: one panel
constexpr int kTileB = kQ * kNM * 2;     // B, C, S_in, dS: two panels
constexpr int kWld = kQ + 1;             // row stride of the f32 W tile
constexpr int kSumThreads = 128;         // the group sum
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {   // t[b, l, h] at t + b*sb + l*sl + h*sh; the last dimension unit-stride
  long long sb, sl, sh;
};

__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// Byte offset of 16-byte chunk ch (8 columns) of row r in a swizzled tile of
// 64 rows: 64-column panels of 128-byte rows, as ssd_scan.cu lays its tiles
__device__ __forceinline__ int swz(int r, int ch) {
  return (ch >> 3) * kPanel + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// The two bf16 of a tile at row r, columns 8 j + c0 and + 1, in f32
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int r, int j, int c0) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + swz(r, j) + c0 * 2));
}

// Rows [t0, t0 + 64) of a bf16 (B, L, H, K) slice with row stride ld into a
// swizzled tile of CH 16-byte chunks a row; zero past L and K
template <int CH>
__device__ __forceinline__ void load_rows(uint8_t* dst, const __nv_bfloat16* src, long long ld,
                                          int t0, int L, int K) {
#pragma unroll
  for (int i = 0; i < kQ * CH / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads, r = c / CH, ch = c % CH;
    const bool ok = t0 + r < L && ch * 8 < K;
    cp_async16(dst + swz(r, ch), ok ? src + (long long)(t0 + r) * ld + ch * 8 : src, ok);
  }
}

__device__ __forceinline__ void load_dt(float* dst, const float* src, long long ld, int t0, int L) {
  if (threadIdx.x < kQ) {
    const bool ok = t0 + threadIdx.x < L;
    cp_async4(dst + threadIdx.x, ok ? src + (long long)(t0 + threadIdx.x) * ld : src, ok);
  }
}

// cs, the inclusive cumsum of a dt over the chunk in log2 units, into this
// warp's copy (lane l sums rows 2 l and 2 l + 1), as ssd_scan.cu's wgmma path
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a2, int lane, float* cs) {
  const float v0 = a2 * dts[2 * lane], v1 = a2 * dts[2 * lane + 1];
  float incl = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
  cs[2 * lane] = before + v0;
  cs[2 * lane + 1] = before + v0 + v1;
  __syncwarp();
}

// the sum over the 4 lanes of a quad (an accumulator row's columns), in every lane
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// ------------------------------------------------------------ (a) states

struct StatesLayout {
  static constexpr int STAGE = kTileX + kTileB + 1024;   // x, B, dt (256 B in 1 KB)
  static constexpr int XW = 2 * STAGE;                   // x o w
  static constexpr int OUT = XW + kTileX;                // S_in staged for its store
  static constexpr int CS = OUT + kTileB;                // cs of each warp: 4 x 64 f32
  static constexpr int bytes = CS + 4 * kQ * 4 + 1024;   // + room to align to 1 KB
};

// Grid (H, B).  sin_out: (B, H, chunks - 1) tiles of kTileB bytes, tile c - 1
// the bf16 state entering chunk c in the chunk pass's layout (rows p).
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_states_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const __nv_bfloat16* __restrict__ bm, uint8_t* __restrict__ sin_out, int L, int H, int P,
    int G, int N, Strides xs, Strides dts_, Strides bs) {
  using Lay = StatesLayout;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* xw_s = smem + Lay::XW;
  uint8_t* out_s = smem + Lay::OUT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* cs = reinterpret_cast<float*>(smem + Lay::CS) + warp * kQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a2 = a[h] * kLog2e;
  const __nv_bfloat16* xb = x + b * xs.sb + h * xs.sh;
  const float* dtb = dt + b * dts_.sb + h * dts_.sh;
  const __nv_bfloat16* bb = bm + b * bs.sb + g * bs.sh;
  const int nc = (L + kQ - 1) / kQ;
  uint8_t* outb = sin_out + ((long long)b * H + h) * (nc - 1) * kTileB;

  auto load_chunk = [&](int stage, int t0) {
    uint8_t* st = smem + stage * Lay::STAGE;
    load_rows<kPM / 8>(st, xb, xs.sl, t0, L, P);
    load_rows<kNM / 8>(st + kTileX, bb, bs.sl, t0, L, N);
    load_dt(reinterpret_cast<float*>(st + kTileX + kTileB), dtb, dts_.sl, t0, L);
  };

  float st_acc[kNM / 2];   // the state, f32, never rounded
  zero(st_acc);
  if (nc > 1) load_chunk(0, 0);   // the last chunk's update is never needed
  cp_async_commit();
  const uint32_t xw_addr = smem_addr(xw_s);
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  for (int ci = 0; ci + 1 < nc; ++ci) {   // the state leaving chunk ci enters chunk ci + 1
    const int stage = ci & 1;
    cp_async_wait_all();
    __syncthreads();      // chunk ci landed; nobody reads the other stage or the staged S_in
    if (ci + 2 < nc) load_chunk(stage ^ 1, (ci + 1) * kQ);
    cp_async_commit();
    uint8_t* st = smem + stage * Lay::STAGE;
    const float* dts = reinterpret_cast<const float*>(st + kTileX + kTileB);
    const uint32_t b_addr = smem_addr(st) + kTileX;

    chunk_cumsum(dts, a2, lane, cs);
    const float total = cs[kQ - 1];
#pragma unroll
    for (int i = 0; i < kQ * 8 / kThreads; ++i) {   // x o w, w_s = exp(cs_Q - cs_s) dt_s
      const int c = tid + i * kThreads, r = c >> 3;
      const int off = r * 128 + (((c & 7) ^ (r & 7)) << 4);
      const float w = exp2f(total - cs[r]) * dts[r];
      const uint4 v = *reinterpret_cast<const uint4*>(st + off);
      const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&v);
      uint4 o;
      uint32_t* po = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(pv[k]);
        po[k] = pack_bf16(f.x * w, f.y * w);
      }
      *reinterpret_cast<uint4*>(xw_s + off) = o;
    }
    const float decay = exp2f(total);
#pragma unroll
    for (int i = 0; i < kNM / 2; ++i) st_acc[i] *= decay;
    fence_proxy_async();
    __syncthreads();      // every warp's x o w written

    fence_regs(st_acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kQ / 16; ++t)
      wgmma_ss_tt<kNM>(st_acc, smem_desc(xw_addr + t * 16 * 128, kPanel, 1024),
                       smem_desc(b_addr + t * 16 * 128, kPanel, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st_acc);

    // S_in of chunk ci + 1 in bf16, staged in its tile layout, then stored whole
#pragma unroll
    for (int j = 0; j < kNM / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = r0 + 8 * hh;
        *reinterpret_cast<uint32_t*>(out_s + swz(p, j) + c0 * 2) =
            pack_bf16(st_acc[4 * j + 2 * hh], st_acc[4 * j + 2 * hh + 1]);
      }
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(outb + (long long)ci * kTileB);
    for (int i = tid; i < kTileB / 16; i += kThreads) dst[i] = reinterpret_cast<const uint4*>(out_s)[i];
  }
  cp_async_wait_all();
}

// ------------------------------------------------------------ (b) chunks

struct ChunkLayout {
  static constexpr int X = 0;                       // x                    [t][p]
  static constexpr int DY = X + kTileX;             // dY, then dY o exp(cs) [t][p]
  static constexpr int B = DY + kTileX;             // B                    [s][n]
  static constexpr int C = B + kTileB;              // C                    [t][n]
  static constexpr int SIN = C + kTileB;            // S_in (bf16)          [p][n]
  static constexpr int DS = SIN + kTileB;           // dS's bf16 copy       [p][n]
  static constexpr int W = DS + kTileB;             // W^T, f32             [s][t], row stride kWld
  static constexpr int DT = W + kQ * kWld * 4;      // dt                   [64]
  static constexpr int CS = DT + kQ * 4;            // cs of each warp      [4][64]
  static constexpr int VEC = CS + 4 * kQ * 4;       // state term, read-out term, x . dx / dt, crossed
  static constexpr int RED = VEC + 4 * kQ * 4;      // <dS, S_in> by warp   [4]
  static constexpr int bytes = RED + 16 + 1024;     // + room to align to 1 KB
};

// Grid (H, B).  sin_in: as ssd_bwd_states_wgmma_kernel writes it.  dstate:
// (B, H, P, N) f32 contiguous or null.  ddt: (B, L, H) f32; dbp, dcp: (B, L,
// H, N) bf16; da_part: (B, H) f32; all contiguous.
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_chunk_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
    const __nv_bfloat16* __restrict__ dy, const uint8_t* __restrict__ sin_in,
    const float* __restrict__ dstate, __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
    __nv_bfloat16* __restrict__ dbp, __nv_bfloat16* __restrict__ dcp,
    float* __restrict__ da_part, int L, int H, int P, int G, int N, Strides xs, Strides dts_,
    Strides bs, Strides cs_, Strides dys, Strides dxs) {
  using Lay = ChunkLayout;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t *x_s = smem + Lay::X, *dy_s = smem + Lay::DY, *b_s = smem + Lay::B;
  uint8_t *c_s = smem + Lay::C, *sin_s = smem + Lay::SIN, *ds_s = smem + Lay::DS;
  float* wt = reinterpret_cast<float*>(smem + Lay::W);
  float* dts = reinterpret_cast<float*>(smem + Lay::DT);
  float* st_term = reinterpret_cast<float*>(smem + Lay::VEC);   // dt_s x_s . (w_s dS B_s)
  float* ro_term = st_term + kQ;                                // C_t . (exp(cs_t) S_in^T dY_t)
  float* xdxr = ro_term + kQ;                                   // x_r . dx_r / dt_r
  float* crossed = xdxr + kQ;                                   // sum over t >= r > s of W
  float* red = reinterpret_cast<float*>(smem + Lay::RED);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* cs = reinterpret_cast<float*>(smem + Lay::CS) + warp * kQ;   // this warp's copy
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float ah = a[h], a2 = ah * kLog2e;
  const __nv_bfloat16* xb = x + b * xs.sb + h * xs.sh;
  const float* dtb = dt + b * dts_.sb + h * dts_.sh;
  const __nv_bfloat16* bb = bm + b * bs.sb + g * bs.sh;
  const __nv_bfloat16* cb = cm + b * cs_.sb + g * cs_.sh;
  const __nv_bfloat16* dyb = dy + b * dys.sb + h * dys.sh;
  __nv_bfloat16* dxb = dx + b * dxs.sb + h * dxs.sh;
  float* ddtb = ddt + (long long)b * L * H + h;                      // row stride H
  const long long prow = (long long)H * N;                          // partials' row stride
  __nv_bfloat16* dbpb = dbp + ((long long)b * L * H + h) * N;
  __nv_bfloat16* dcpb = dcp + ((long long)b * L * H + h) * N;
  const int nc = (L + kQ - 1) / kQ;
  const uint8_t* sinb = sin_in + ((long long)b * H + h) * (nc - 1) * kTileB;

  auto load_sin = [&](int c) {   // chunk 0's is the zero state: zero-filled
    const uint8_t* src = sinb + (long long)(c - 1) * kTileB;
#pragma unroll
    for (int i = 0; i < kTileB / 16 / kThreads; ++i) {
      const int k = tid + i * kThreads;
      cp_async16(sin_s + k * 16, c > 0 ? src + k * 16 : static_cast<const void*>(xb), c > 0);
    }
  };
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);   // this thread's rows r0, r0 + 8

  // dS of the last chunk: the final state's cotangent (rows p, columns n), or 0
  float ds[kNM / 2];
  const float* dsb = dstate == nullptr ? nullptr : dstate + ((long long)b * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < kNM / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = r0 + 8 * hh, n = 8 * j + c0;   // N % 8 == 0: the pair is in or out
      const float2 v = dsb != nullptr && p < P && n < N
                           ? *reinterpret_cast<const float2*>(dsb + (long long)p * N + n)
                           : make_float2(0.f, 0.f);
      ds[4 * j + 2 * hh] = v.x;
      ds[4 * j + 2 * hh + 1] = v.y;
    }
  auto store_ds_copy = [&]() {   // dS rounded to bf16 into its tile (rows p)
#pragma unroll
    for (int j = 0; j < kNM / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(ds_s + swz(r0 + 8 * hh, j) + c0 * 2) =
            pack_bf16(ds[4 * j + 2 * hh], ds[4 * j + 2 * hh + 1]);
  };
  store_ds_copy();
  {
    const int t0 = (nc - 1) * kQ;
    load_rows<kPM / 8>(x_s, xb, xs.sl, t0, L, P);
    load_rows<kPM / 8>(dy_s, dyb, dys.sl, t0, L, P);
    load_rows<kNM / 8>(b_s, bb, bs.sl, t0, L, N);
    load_rows<kNM / 8>(c_s, cb, cs_.sl, t0, L, N);
    load_dt(dts, dtb, dts_.sl, t0, L);
    load_sin(nc - 1);
  }
  cp_async_commit();

  const uint32_t x_addr = smem_addr(x_s), dy_addr = smem_addr(dy_s), b_addr = smem_addr(b_s);
  const uint32_t c_addr = smem_addr(c_s), sin_addr = smem_addr(sin_s), ds_addr = smem_addr(ds_s);
  float da_acc = 0.f;   // lane 0 of warp 0
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kQ, tn = t0 - kQ;   // this chunk's first row, the next one's
    cp_async_wait_all();   // chunk c has landed (this thread's copies)
    fence_proxy_async();   // ... and dS's copy: visible to wgmma
    __syncthreads();

    // G^T = B C^T (K = n), D^T = x dY^T and D = dY x^T (K = p)
    float gt[32], dtr[32], dm[32];
    zero(gt);
    zero(dtr);
    zero(dm);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNM / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kPanel + (kk & 3) * 32;
      wgmma_ss<64>(gt, smem_desc(b_addr + off, 16, 1024), smem_desc(c_addr + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kPM / 16; ++kk) {
      const uint32_t off = kk * 32;
      wgmma_ss<64>(dtr, smem_desc(x_addr + off, 16, 1024), smem_desc(dy_addr + off, 16, 1024), kk > 0);
      wgmma_ss<64>(dm, smem_desc(dy_addr + off, 16, 1024), smem_desc(x_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    chunk_cumsum(dts, a2, lane, cs);   // meanwhile
    const float total = cs[kQ - 1];
    wgmma_wait_all();
    fence_regs(gt);
    fence_regs(dtr);
    fence_regs(dm);

    // the score fragments: seg o G^T and seg o D^T (rows s, columns t >= s),
    // seg o D o dt_s (rows t, columns s <= t); W^T = seg o G^T o D^T o dt_s
    // into shared memory.  The argument is masked before the exponent.
    const float cs_r[2] = {cs[r0], cs[r0 + 8]}, dt_r[2] = {dts[r0], dts[r0 + 8]};
    uint32_t sg[4][4], sd[4][4], sdd[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c0 + e;
        const float cs_c = cs[col], dt_c = dts[col];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + 8 * hh, i = 4 * j + 2 * hh + e;
          const float seg_t = exp2f(col >= row ? cs_c - cs_r[hh] : -INFINITY);   // (s, t) = (row, col)
          const float gv = seg_t * gt[i];
          wt[row * kWld + col] = gv * dtr[i] * dt_r[hh];
          gt[i] = gv;
          dtr[i] *= seg_t;
          const float seg_d = exp2f(col <= row ? cs_r[hh] - cs_c : -INFINITY);   // (t, s) = (row, col)
          dm[i] *= seg_d * dt_c;
        }
      }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sg[t][r] = pack_bf16(gt[8 * t + 2 * r], gt[8 * t + 2 * r + 1]);
        sd[t][r] = pack_bf16(dtr[8 * t + 2 * r], dtr[8 * t + 2 * r + 1]);
        sdd[t][r] = pack_bf16(dm[8 * t + 2 * r], dm[8 * t + 2 * r + 1]);
      }
    __syncthreads();   // W^T stored
    {  // each row's suffix over t, two threads a row: R[s][t] = sum over t' >= t of W^T[s][t']
      const int s = tid >> 1, hf = tid & 1;
      float* row = wt + s * kWld + 32 * hf;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 31; k >= 0; --k) {
        acc += row[k];
        row[k] = acc;
      }
      const float upper = __shfl_xor_sync(0xffffffffu, acc, 1);   // the other half's total
      if (hf == 0)
#pragma unroll 8
        for (int k = 0; k < 32; ++k) row[k] += upper;
    }
    __syncthreads();
    {  // each column's prefix over s < r: crossed_r = sum over s < r of R[s][r]
      const int r = tid >> 1, hf = tid & 1;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const int s = 32 * hf + k;
        if (s < r) acc += wt[s * kWld + r];
      }
      const float other = __shfl_xor_sync(0xffffffffu, acc, 1);
      if (hf == 0) crossed[r] = acc + other;
    }
    const float w_r[2] = {exp2f(total - cs_r[0]), exp2f(total - cs_r[1])};

    {  // dx (rows s, columns p): w o (B dS^T), the state term, then += (seg o G)^T dY
      float acc[32];
      zero(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kNM / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kPanel + (kk & 3) * 32;
        wgmma_ss<64>(acc, smem_desc(b_addr + off, 16, 1024), smem_desc(ds_addr + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh;
          const float2 xv = tile_pair(x_s, r0 + 8 * hh, j, c0);
          acc[i] *= w_r[hh];
          acc[i + 1] *= w_r[hh];
          part[hh] = fmaf(xv.x, acc[i], fmaf(xv.y, acc[i + 1], part[hh]));
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        part[hh] = quad_sum(part[hh]);
        if ((lane & 3) == 0) st_term[r0 + 8 * hh] = dt_r[hh] * part[hh];
      }
      fence_regs(acc);
      fence_regs(sg);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t)
        wgmma_rs<64>(acc, sg[t], smem_desc(dy_addr + t * 16 * 128, kPanel, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(sg);
      part[0] = part[1] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int s = r0 + 8 * hh, p = 8 * j + c0, i = 4 * j + 2 * hh;   // P % 8 == 0
          const float2 xv = tile_pair(x_s, s, j, c0);
          part[hh] = fmaf(xv.x, acc[i], fmaf(xv.y, acc[i + 1], part[hh]));
          if (t0 + s < L && p < P)   // the pair is in or out
            *reinterpret_cast<__nv_bfloat162*>(dxb + (long long)(t0 + s) * dxs.sl + p) =
                __floats2bfloat162_rn(dt_r[hh] * acc[i], dt_r[hh] * acc[i + 1]);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        part[hh] = quad_sum(part[hh]);
        if ((lane & 3) == 0) xdxr[r0 + 8 * hh] = part[hh];
      }
    }

    {  // dB (rows s, columns n): w o (x dS), then += (seg o D)^T C; times dt_s
      float acc[kNM / 2];
      zero(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPM / 16; ++kk)
        wgmma_ss_tb<kNM>(acc, smem_desc(x_addr + kk * 32, 16, 1024),
                         smem_desc(ds_addr + kk * 16 * 128, kPanel, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < kNM / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          acc[4 * j + 2 * hh] *= w_r[hh];
          acc[4 * j + 2 * hh + 1] *= w_r[hh];
        }
      fence_regs(acc);
      fence_regs(sd);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t)
        wgmma_rs<kNM>(acc, sd[t], smem_desc(c_addr + t * 16 * 128, kPanel, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(sd);
#pragma unroll
      for (int j = 0; j < kNM / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int s = r0 + 8 * hh, n = 8 * j + c0;   // N % 8 == 0: the pair is in or out
          if (t0 + s < L && n < N)
            *reinterpret_cast<__nv_bfloat162*>(dbpb + (long long)(t0 + s) * prow + n) =
                __floats2bfloat162_rn(dt_r[hh] * acc[4 * j + 2 * hh],
                                      dt_r[hh] * acc[4 * j + 2 * hh + 1]);
        }
    }
    __syncthreads();   // every read of x is done: the next chunk's x streams in
    if (c > 0) load_rows<kPM / 8>(x_s, xb, xs.sl, tn, L, P);

    {  // dC (rows t, columns n): exp(cs_t) (dY S_in), the read-out term, then += (seg o D o dt) B
      float part = 0.f;   // <dS, S_in>: this thread's share, S_in from its tile
#pragma unroll
      for (int j = 0; j < kNM / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 sv = tile_pair(sin_s, r0 + 8 * hh, j, c0);
          part = fmaf(ds[4 * j + 2 * hh], sv.x, fmaf(ds[4 * j + 2 * hh + 1], sv.y, part));
        }
#pragma unroll
      for (int o = 1; o < 32; o *= 2) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[warp] = part;
      float acc[kNM / 2];
      zero(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPM / 16; ++kk)
        wgmma_ss_tb<kNM>(acc, smem_desc(dy_addr + kk * 32, 16, 1024),
                         smem_desc(sin_addr + kk * 16 * 128, kPanel, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      const float ecs_r[2] = {exp2f(cs_r[0]), exp2f(cs_r[1])};
      float tpart[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNM / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh;
          const float2 cv = tile_pair(c_s, r0 + 8 * hh, j, c0);
          acc[i] *= ecs_r[hh];
          acc[i + 1] *= ecs_r[hh];
          tpart[hh] = fmaf(cv.x, acc[i], fmaf(cv.y, acc[i + 1], tpart[hh]));
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tpart[hh] = quad_sum(tpart[hh]);
        if ((lane & 3) == 0) ro_term[r0 + 8 * hh] = tpart[hh];
      }
      fence_regs(acc);
      fence_regs(sdd);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t)
        wgmma_rs<kNM>(acc, sdd[t], smem_desc(b_addr + t * 16 * 128, kPanel, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(sdd);
#pragma unroll
      for (int j = 0; j < kNM / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = r0 + 8 * hh, n = 8 * j + c0;
          if (t0 + t < L && n < N)
            *reinterpret_cast<__nv_bfloat162*>(dcpb + (long long)(t0 + t) * prow + n) =
                __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
    }
    __syncthreads();   // every read of B and S_in is done; the terms are stored
    if (c > 0) {
      load_rows<kNM / 8>(b_s, bb, bs.sl, tn, L, N);
      load_sin(c - 1);
    }

    if (warp == 0) {  // d(a dt) of rows 2 lane and 2 lane + 1, ddt, and da's share
      const int r = 2 * lane;
      const float v0 = st_term[r], v1 = st_term[r + 1];   // the state term over s < r
      float pre = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, pre, o);
        if (lane >= o) pre += u;
      }
      float before = __shfl_up_sync(0xffffffffu, pre, 1);
      if (lane == 0) before = 0.f;
      const float u0 = ro_term[r], u1 = ro_term[r + 1];   // the read-out term over t >= r
      float suf = u0 + u1;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const float v = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += v;
      }
      float after = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) after = 0.f;
      const float e0 = exp2f(total) * (((red[0] + red[1]) + red[2]) + red[3]);
      const float dadt0 = e0 + before + (after + u1 + u0) + crossed[r];
      const float dadt1 = e0 + (before + v0) + (after + u1) + crossed[r + 1];
      if (t0 + r < L) ddtb[(long long)(t0 + r) * H] = fmaf(ah, dadt0, xdxr[r]);
      if (t0 + r + 1 < L) ddtb[(long long)(t0 + r + 1) * H] = fmaf(ah, dadt1, xdxr[r + 1]);
      float da_c = fmaf(dts[r], dadt0, dts[r + 1] * dadt1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) da_c += __shfl_xor_sync(0xffffffffu, da_c, o);
      da_acc += da_c;
    }

    // dS <- exp(cs_Q) dS + (dY o exp(cs))^T C: dY o exp(cs_t) in bf16 in place of dY
#pragma unroll
    for (int i = 0; i < kQ * 8 / kThreads; ++i) {
      const int k = tid + i * kThreads, r = k >> 3;
      const int off = r * 128 + (((k & 7) ^ (r & 7)) << 4);
      const float e = exp2f(cs[r]);
      uint4 v = *reinterpret_cast<const uint4*>(dy_s + off);
      uint32_t* pv = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pv + q));
        pv[q] = pack_bf16(f.x * e, f.y * e);
      }
      *reinterpret_cast<uint4*>(dy_s + off) = v;
    }
    const float decay = exp2f(total);
#pragma unroll
    for (int i = 0; i < kNM / 2; ++i) ds[i] *= decay;
    fence_proxy_async();
    __syncthreads();   // every warp's dY o exp(cs) written; warp 0's reads of dt done
    fence_regs(ds);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kQ / 16; ++t)
      wgmma_ss_tt<kNM>(ds, smem_desc(dy_addr + t * 16 * 128, kPanel, 1024),
                       smem_desc(c_addr + t * 16 * 128, kPanel, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(ds);
    __syncthreads();   // every warp's part of the update has read C and dY
    if (c > 0) {
      load_rows<kPM / 8>(dy_s, dyb, dys.sl, tn, L, P);
      load_rows<kNM / 8>(c_s, cb, cs_.sl, tn, L, N);
      load_dt(dts, dtb, dts_.sl, tn, L);
      store_ds_copy();
    }
    cp_async_commit();
  }
  cp_async_wait_all();
  if (tid == 0) da_part[(long long)b * H + h] = da_acc;
}

// ------------------------------------------------------------ (c) group sum

// dB and dC (B, L, G, N) bf16 contiguous: each the sum of its group's H/G
// heads of dbp and dcp (bf16) in head order, in f32; da (H) f32 the sum over
// b of da_part.  A thread owns 2 columns of a row (4-byte reads: a warp
// reads 128 bytes of a head's row, and 16 heads' reads are in flight).
__global__ void __launch_bounds__(kSumThreads) ssd_bwd_group_sum_wgmma_kernel(
    const __nv_bfloat16* __restrict__ dbp, const __nv_bfloat16* __restrict__ dcp,
    const float* __restrict__ da_part, __nv_bfloat16* __restrict__ db,
    __nv_bfloat16* __restrict__ dc, float* __restrict__ da, int B, int L, int H, int G, int N) {
  const int rep = H / G, n2 = N / 2;
  const long long total = (long long)B * L * G * n2;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int c2 = static_cast<int>(e % n2);
    const long long rest = e / n2;
    const int g = static_cast<int>(rest % G);
    const long long bl = rest / G;   // b L + l
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(
        dbp + (bl * H + (long long)g * rep) * N + c2 * 2);
    const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(
        dcp + (bl * H + (long long)g * rep) * N + c2 * 2);
    float2 sb = make_float2(0.f, 0.f), sc = make_float2(0.f, 0.f);
#pragma unroll 16
    for (int k = 0; k < rep; ++k) {
      const float2 fb = __bfloat1622float2(pb[(long long)k * n2]);
      const float2 fc = __bfloat1622float2(pc[(long long)k * n2]);
      sb.x += fb.x;
      sb.y += fb.y;
      sc.x += fc.x;
      sc.y += fc.y;
    }
    reinterpret_cast<__nv_bfloat162*>(db)[e] = __floats2bfloat162_rn(sb.x, sb.y);
    reinterpret_cast<__nv_bfloat162*>(dc)[e] = __floats2bfloat162_rn(sc.x, sc.y);
  }
  if (blockIdx.x == 0)
    for (int hh = threadIdx.x; hh < H; hh += blockDim.x) {
      float s = 0.f;
      for (int bi = 0; bi < B; ++bi) s += da_part[(long long)bi * H + hh];
      da[hh] = s;
    }
}

// ------------------------------------------------------------ launches

Strides at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

int check(int dtype, int H, int G, int P, int N) {
  if (dtype != 1 || G <= 0 || H % G != 0 || P <= 0 || N <= 0 || P > kPM || N > kNM || P % 8 != 0 ||
      N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Rows of the bwd_wgmma chunk: the S_in scratch holds ceil(L / rows) - 1
// tiles a (b, h), each of repro_ssd_scan_bwd_wgmma_tile_bytes() bytes.
extern "C" int repro_ssd_scan_bwd_wgmma_chunk_rows() { return kQ; }
extern "C" int repro_ssd_scan_bwd_wgmma_tile_bytes() { return kTileB; }

// Dynamic shared memory of a states (which = 0) or chunk (which = 1) block.
extern "C" int repro_ssd_scan_bwd_wgmma_smem_bytes(int which) {
  return which == 0 ? StatesLayout::bytes : which == 1 ? ChunkLayout::bytes : 0;
}

// The entries take ssd_scan_bwd.cu's arguments; dtype (of x, B, C, dY, dx)
// must be 1 = bfloat16.  dt and a f32.  strides: (batch, length, head-or-group) in
// elements of x, dt and B (9 values).  sin: (B, H, ceil(L / rows) - 1) tiles
// of repro_ssd_scan_bwd_wgmma_tile_bytes() bytes.  Each entry launches on
// `stream` and returns the CUDA error of its launch (0 on success).
extern "C" int repro_ssd_scan_bwd_wgmma_states(int dtype, const void* x, const void* dt, const void* a,
                                               const void* bm, void* sin, int B, int L, int H,
                                               int P, int G, int N, const long long* strides,
                                               void* stream) {
  if (int err = check(dtype, H, G, P, N)) return err;
  if ((L + kQ - 1) / kQ <= 1 || B == 0) return 0;   // no chunk enters with a state
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         StatesLayout::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_states_wgmma_kernel<<<dim3((unsigned)H, (unsigned)B), kThreads, StatesLayout::bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(bm),
      static_cast<uint8_t*>(sin), L, H, P, G, N, at(strides, 0), at(strides, 1), at(strides, 2));
  return static_cast<int>(cudaGetLastError());
}

// strides: (batch, length, head-or-group) of x, dt, B, C, dY and dx (18
// values).  dstate: the final state's cotangent (B, H, P, N) f32 contiguous,
// or null for 0.  ddt (B, L, H) and da_part (B, H) f32, dbp and dcp (B, L,
// H, N) bf16, all contiguous.
extern "C" int repro_ssd_scan_bwd_wgmma_dchunk(int dtype, const void* x, const void* dt, const void* a,
                                               const void* bm, const void* cm, const void* dy,
                                               const void* sin, const void* dstate, void* dx,
                                               void* ddt, void* dbp, void* dcp, void* da_part,
                                               int B, int L, int H, int P, int G, int N,
                                               const long long* strides, void* stream) {
  if (int err = check(dtype, H, G, P, N)) return err;
  if (L == 0 || B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         ChunkLayout::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_wgmma_kernel<<<dim3((unsigned)H, (unsigned)B), kThreads, ChunkLayout::bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const uint8_t*>(sin), static_cast<const float*>(dstate),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ddt), static_cast<__nv_bfloat16*>(dbp),
      static_cast<__nv_bfloat16*>(dcp), static_cast<float*>(da_part), L, H, P, G, N,
      at(strides, 0), at(strides, 1), at(strides, 2), at(strides, 3), at(strides, 4),
      at(strides, 5));
  return static_cast<int>(cudaGetLastError());
}

// dbp and dcp (B, L, H, N) bf16 as the chunk pass writes them; db and dc:
// (B, L, G, N) bf16, contiguous; da: (H) f32.
extern "C" int repro_ssd_scan_bwd_wgmma_group_sum(int dtype, const void* dbp, const void* dcp,
                                                  const void* da_part, void* db, void* dc,
                                                  void* da, int B, int L, int H, int G, int N,
                                                  void* stream) {
  if (int err = check(dtype, H, G, 8, N)) return err;
  const long long total = (long long)B * L * G * (N / 2);
  const long long want = (total + kSumThreads - 1) / kSumThreads;
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : want > 8192 ? 8192 : want);
  ssd_bwd_group_sum_wgmma_kernel<<<blocks, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dbp), static_cast<const __nv_bfloat16*>(dcp),
      static_cast<const float*>(da_part), static_cast<__nv_bfloat16*>(db),
      static_cast<__nv_bfloat16*>(dc), static_cast<float*>(da), B, L, H, G, N);
  return static_cast<int>(cudaGetLastError());
}
