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
// cores; at the f32 FFMA rate the operations take ~0.26 ms.  Common to both
// paths:
//   * The TPU kernel holds a whole chunk of the model's ssm_chunk = 256 rows
//     in VMEM and carries the state across a *sequential* grid axis.  Here
//     one block per (b, h) walks L in short chunks with the state inside the
//     block (the chunk length does not change the function, only the order
//     of its sums): the serve shape's 256 blocks are all resident at once,
//     two an SM.  Mamba-2's chunk-parallel split (chunk states, state
//     passing, chunk scan) would write and read every chunk's f32 state
//     through memory, several times the 149 MB bound.
//   * Head h reads group h / (H/G) of B and C in place (at G = 1 all heads of
//     a batch row read the same B and C, from L2); x, dt, B, C and y are read
//     and written in the model's (B, L, H, P) layout through strides: no
//     transposed or repeated copies.
//   * A ragged tail is masked as the reference pads it: dt = 0 and zero x, B,
//     C past L, so the decay is 1, nothing enters the state, and the final
//     state is exact.  s > t is never exponentiated (the reference's "mask
//     the ARGUMENT before exp"), and seg is never factored as
//     exp(cs_t) exp(-cs_s): at |a dt| ~ 7 a row cs reaches -450 in 64 rows
//     and exp(+450) is inf in f32.
// Two paths, chosen by the wrapper before the launch (ops.choose_path):
//   * wgmma (bf16 with 16-byte rows: P and N multiples of 8, N above 32,
//     the batch, length and head or group strides multiples of 8 elements,
//     pointers 16-byte aligned): ssd_wgmma_kernel.  One warpgroup a block,
//     chunks of kWgQ = 64 rows (wgmma's M), every product on the tensor
//     cores from 128-byte-swizzled shared memory, f32 accumulators:
//       G = C B^T            m64n64k16 x 8, both operands K-major (n)
//       Y = C S_in^T         m64n64k16 x 8, S_in the state entering the
//                            chunk, bf16, rows p (K-major), written by the
//                            previous chunk from the registers that carry it
//       Y = exp(cs_t) o Y    in registers
//       L = G o seg o dt_s   in registers, split in place into bf16 pairs hi
//                            and lo (L - hi): the accumulator's fragment is
//                            the register A operand of the next product (as
//                            flash feeds P); dt is folded into L so that x
//                            stays an exact operand
//       Y += L X             m64n64k16 x 4 for hi and 4 for lo, X N-major:
//                            the transposed-B mode
//       S = exp(cs_Q) S + (x o w)^T B,  w_s = exp(cs_Q - cs_s) dt_s:
//                            m64n128k16 x 4, x o w (bf16, M-major) through
//                            the transposed-A mode and B (N-major) through
//                            the transposed-B mode; S stays an f32
//                            accumulator in registers for the whole walk (64
//                            a thread) and is never rounded: only its copy
//                            S_in is, and the final state leaves in f32.
//     y leaves through the chunk's spent C tile, each warp's 16 rows at a
//     time, so that one 16-byte store writes four whole 128-byte rows of y
//     (straight from the fragments a store puts 4 bytes into each of 8
//     rows 8 KB apart).
//     cs is summed per row in log2 units by each warp with shuffles (the
//     difference cs_t - cs_s keeps ~5 digits at |cs| ~ 450: harmless at
//     bf16's 2e-2, which is why f32 stays on ffma).  x, B, C and dt of the
//     next chunk stream in through a 2-stage ring of cp.async copies (16
//     bytes; 4 for dt) while this chunk computes.  P pads to 64 and N to
//     kWgN = 128 with zero-filled copies.
//     Precision: rounding L, S_in and x o w once each to bf16 left y 2.8e-3
//     from the step recurrence (relative norm) at the served shape, and
//     mamba2-1.3b's served logits 0.411 and 0.373 from the plain scan's on
//     two seeds, against ffma's 0.277 and 0.271.  Splitting L alone (4 more
//     products a chunk, no shared memory) brings y to 6.5e-4 and the logits
//     to 0.284 and 0.252 for 6 % more time; splitting all three brings y to
//     1.0e-4 at twice the time (tools/torch_ssd_precision.py).  With L
//     split, y still misses 2e-2 elementwise where a read-out over 32 state
//     columns cancels (P = 64, N = 32): bf16 with N <= 32, whose y is held
//     elementwise, runs on ffma.  Shared memory 110,592 bytes a block: two
//     blocks an SM; 236 registers, no spill (-Xptxas -v).
//   * ffma (f32, whose parity tolerance is 2e-5 and which a bf16 or TF32
//     operand would miss, and bf16 that is not aligned so): ssd_kernel.  One
//     block of 256 threads per (b, h), chunks of kQ = 32 rows (one warp),
//     the state in shared memory, ~79 KB a block at P = 64, N = 128.  Warp 0
//     takes the chunk's prefix and suffix sums of a dt with shuffles, and
//     the exponents cs_t - cs_s and cs_Q - cs_t are summed directly over
//     their own rows, never taken as differences of two cumsums, so the step
//     recurrence is matched to f32 rounding.  Every product is scalar FFMA
//     on values widened to f32; y is written in x's dtype.
// That C B^T is the same for every head of a group (all 64 heads at G = 1)
// is left to a later redesign, as are TMA and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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


// ----------------------------------------------------------------- wgmma path

constexpr int kWgQ = 64;          // rows of a chunk: wgmma's M
constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kWgStages = 2;      // x, B, C, dt ring
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kWgN = 128;         // state columns of a block: N pads to 128

// Shared memory of one block (P pads to 64, N to kWgN): every tile is rows x
// 64-column panels of 128 bytes, 1 KB aligned.
struct WgLayout {
  static constexpr int X = kWgQ * 64 * 2;     // x, and x o w: 8 KB
  static constexpr int BC = kWgQ * kWgN * 2;  // each of B, C, S_in: 16 KB
  static constexpr int STAGE = X + 2 * BC + 1024;   // x, B, C, dt (256 B in 1 KB)
  static constexpr int XW = kWgStages * STAGE;       // x o w
  static constexpr int SIN = XW + X;                 // S_in
  static constexpr int CS = SIN + BC;                // cs of each warp: 4 x 64 f32
  static constexpr int bytes = CS + 4 * kWgQ * 4 + 1024;   // + room to align to 1 KB
};

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
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// generic-proxy writes to shared memory made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Registers that an asynchronous wgmma reads or writes: the compiler may
// neither move their other uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// v's bf16 pair and the pair of what that rounding left out
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// d (64 x 64, f32, in the registers of a warpgroup) = (scale_d ? d : 0) +
// A (64 x 16) B (16 x 64), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers) B (16 x 64), B N-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128) += A (64 x 16) B (16 x 128), A M-major and B N-major in
// shared memory: the transposed-A and transposed-B modes
__device__ __forceinline__ void wgmma_tt(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Accumulator layout of the warpgroup: warp w holds rows 16 w .. + 15;
// register 4 j + 2 h + e is (row lane / 4 + 8 h, column 8 j + 2 (lane % 4)
// + e).  Registers 8 t .. 8 t + 7 of G (columns s) are then exactly the A
// fragment of k-step t of Y += L X, so L feeds that product from the
// registers it is made in.  Shared memory: every tile is 64 rows of 64-column
// panels of 128 bytes, 16-byte chunk c of row r at panel c / 8, r * 128 +
// ((c % 8) ^ (r % 8)) * 16.  x, B and C have rows t (or s); S_in rows p.
// As K-major operands (n contiguous) C, B and S_in step K within a panel;
// as MN-major ones x, x o w and B step K by 16 rows (2 KB), the
// descriptor's leading offset stepping panels and its stride offset 8 rows.
// Grid: (H, B), one warpgroup a block.  Strides in elements; the last
// dimension of x, B, C, y is unit-stride.  state: (B, H, P, N) contiguous f32.
__global__ void __launch_bounds__(kWgThreads, 2) ssd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
    __nv_bfloat16* __restrict__ y, float* __restrict__ state, int L, int H, int P, int G, int N,
    long long x_sb, long long x_sl, long long x_sh, long long dt_sb, long long dt_sl,
    long long dt_sh, long long b_sb, long long b_sl, long long b_sg, long long c_sb,
    long long c_sl, long long c_sg, long long y_sb, long long y_sl, long long y_sh) {
  using Lay = WgLayout;
  constexpr int CH = kWgN / 8;        // 16-byte chunks of a row of B, C and S_in
  constexpr int PANEL = kWgQ * 128;   // one 64-column panel of a 64-row tile
  constexpr int NS = kWgN / 2;        // registers of the state (64 x kWgN)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* xw_s = smem + Lay::XW;
  uint8_t* sin_s = smem + Lay::SIN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* cs = reinterpret_cast<float*>(smem + Lay::CS) + warp * kWgQ;  // this warp's copy
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a2 = a[h] * kLog2e;     // exponents in log2 units
  const __nv_bfloat16* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const __nv_bfloat16* bb = bm + b * b_sb + g * b_sg;
  const __nv_bfloat16* cb = cm + b * c_sb + g * c_sg;
  __nv_bfloat16* yb = y + b * y_sb + h * y_sh;

  // x, B, C and dt of rows [t0, t0 + 64) into a stage; zero past L, P and N
  auto load_chunk = [&](int stage, int t0) {
    uint8_t* st = smem + stage * Lay::STAGE;
#pragma unroll
    for (int i = 0; i < kWgQ * 8 / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads, r = c >> 3, ch = c & 7;
      const bool ok = t0 + r < L && ch * 8 < P;
      cp_async16(st + r * 128 + ((ch ^ (r & 7)) << 4),
                 ok ? xb + (long long)(t0 + r) * x_sl + ch * 8 : xb, ok);
    }
#pragma unroll
    for (int i = 0; i < kWgQ * CH / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads, r = c / CH, ch = c % CH;
      const bool ok = t0 + r < L && ch * 8 < N;
      const int off = (ch >> 3) * PANEL + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
      cp_async16(st + Lay::X + off, ok ? bb + (long long)(t0 + r) * b_sl + ch * 8 : bb, ok);
      cp_async16(st + Lay::X + Lay::BC + off, ok ? cb + (long long)(t0 + r) * c_sl + ch * 8 : cb, ok);
    }
    if (tid < kWgQ) {
      const bool ok = t0 + tid < L;
      cp_async4(st + Lay::X + 2 * Lay::BC + tid * 4, ok ? dtb + (long long)(t0 + tid) * dt_sl : dtb, ok);
    }
  };

  for (int i = tid; i < Lay::BC / 16; i += kWgThreads)
    reinterpret_cast<uint4*>(sin_s)[i] = make_uint4(0u, 0u, 0u, 0u);   // the state entering chunk 0

  float st_acc[NS], gl[32], ya[32];   // the state (f32, never rounded); G, then L; y
  uint32_t lhi[4][4], llo[4][4];      // L in bf16 pairs, and the rest of it
#pragma unroll
  for (int i = 0; i < NS; ++i) st_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) gl[i] = ya[i] = 0.f;

  const int nc = (L + kWgQ - 1) / kWgQ;
  if (nc > 0) load_chunk(0, 0);
  cp_async_commit();
  const uint32_t xw_addr = smem_addr(xw_s), sin_addr = smem_addr(sin_s);
  const int r0 = warp * 16 + (lane >> 2);   // this thread's rows of every accumulator: r0, r0 + 8
  const int c0 = 2 * (lane & 3);            // and its columns 8 j + c0 + {0, 1}
  for (int ci = 0; ci < nc; ++ci) {
    const int stage = ci & 1, t0 = ci * kWgQ;
    cp_async_wait_all();   // chunk ci has landed (this thread's copies)
    fence_async_smem();    // ... and S_in, written by the last chunk: visible to wgmma
    __syncthreads();       // every thread's; and nobody still reads the other stage
    if (ci + 1 < nc) load_chunk(stage ^ 1, t0 + kWgQ);
    cp_async_commit();
    uint8_t* st = smem + stage * Lay::STAGE;
    const float* dts = reinterpret_cast<const float*>(st + Lay::X + 2 * Lay::BC);
    const uint32_t x_addr = smem_addr(st), b_addr = x_addr + Lay::X, c_addr = b_addr + Lay::BC;

    // G = C B^T and Y = C S_in^T, K = n
    fence_regs(gl);
    fence_regs(ya);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgN / 16; ++kk) {
      const uint32_t off = (kk >> 2) * PANEL + (kk & 3) * 32;   // k-step within a panel
      const uint64_t dc = smem_desc(c_addr + off, 16, 1024);
      wgmma_ss(gl, dc, smem_desc(b_addr + off, 16, 1024), kk > 0);
      wgmma_ss(ya, dc, smem_desc(sin_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();

    // meanwhile: cs, the inclusive cumsum of a dt (this warp's copy; lane l
    // sums rows 2 l and 2 l + 1), then x o w into its tile
    {
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
    const float total = cs[kWgQ - 1];
#pragma unroll
    for (int i = 0; i < kWgQ * 8 / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads, r = c >> 3;
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

    wgmma_wait<0>();
    fence_regs(gl);
    fence_regs(ya);

    // L = G o seg o dt_s; seg's argument masked before the exponent
    const float cs_t[2] = {cs[r0], cs[r0 + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = 8 * j + c0 + e;
        const float cs_s = cs[s], d_s = dts[s];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float arg = s <= r0 + 8 * hh ? cs_t[hh] - cs_s : -INFINITY;
          gl[4 * j + 2 * hh + e] *= exp2f(arg) * d_s;
        }
      }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(gl[8 * t + 2 * r], gl[8 * t + 2 * r + 1], lhi[t][r], llo[t][r]);
    const float e0 = exp2f(cs_t[0]), e1 = exp2f(cs_t[1]);   // y's rows: exp(cs_t) C S_in^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ya[4 * j] *= e0;
      ya[4 * j + 1] *= e0;
      ya[4 * j + 2] *= e1;
      ya[4 * j + 3] *= e1;
    }
    const float decay = exp2f(total);
#pragma unroll
    for (int i = 0; i < NS; ++i) st_acc[i] *= decay;

    fence_async_smem();   // x o w visible to wgmma
    __syncthreads();      // every warp's x o w written; every warp's reads of S_in done

    // Y += L X (X N-major: transposed B); S += (x o w)^T B (transposed A and B)
    fence_regs(ya);
    fence_regs(lhi);
    fence_regs(llo);
    fence_regs(st_acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint64_t dx = smem_desc(x_addr + t * 16 * 128, PANEL, 1024);
      wgmma_rs(ya, lhi[t], dx);
      wgmma_rs(ya, llo[t], dx);
    }
    wgmma_commit();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint64_t db = smem_desc(b_addr + t * 16 * 128, PANEL, 1024);
      wgmma_tt(st_acc, smem_desc(xw_addr + t * 16 * 128, PANEL, 1024), db);
    }
    wgmma_commit();

    wgmma_wait<1>();      // y's product is done; the state's may still run
    fence_regs(ya);
    fence_regs(lhi);
    fence_regs(llo);
    {  // y through this warp's 16 rows of the spent C tile (swizzled as the
       // tiles are), then 16-byte stores: four whole 128-byte rows a store
      uint8_t* ys = st + Lay::X + Lay::BC + warp * 16 * 128;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = (lane >> 2) + 8 * hh;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(ys + r * 128 + ((j ^ (r & 7)) << 4) + c0 * 2) =
              pack_bf16(ya[4 * j + 2 * hh], ya[4 * j + 2 * hh + 1]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i, r = c >> 3, ch = c & 7;
        const int t = t0 + warp * 16 + r;
        if (t < L && ch * 8 < P)   // P % 8 == 0: a 16-byte chunk is in or out
          *reinterpret_cast<uint4*>(yb + (long long)t * y_sl + ch * 8) =
              *reinterpret_cast<const uint4*>(ys + r * 128 + ((ch ^ (r & 7)) << 4));
      }
    }
    wgmma_wait<0>();
    fence_regs(st_acc);

    // S_in of the next chunk: the state rounded to bf16
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = r0 + 8 * hh;
        const int off = (j >> 3) * PANEL + p * 128 + (((j & 7) ^ (p & 7)) << 4) + c0 * 2;
        *reinterpret_cast<uint32_t*>(sin_s + off) =
            pack_bf16(st_acc[4 * j + 2 * hh], st_acc[4 * j + 2 * hh + 1]);
      }
  }
  cp_async_wait_all();

  float* sb = state + ((long long)b * H + h) * P * N;   // the final state, f32
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = r0 + 8 * hh, n = 8 * j + c0;   // N % 8 == 0: the pair is in or out
      if (p < P && n < N)
        *reinterpret_cast<float2*>(sb + (long long)p * N + n) =
            make_float2(st_acc[4 * j + 2 * hh], st_acc[4 * j + 2 * hh + 1]);
    }
}

int launch_wgmma(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
                 void* y, float* state, int B, int L, int H, int P, int G, int N,
                 const long long* st, cudaStream_t stream) {
  if (P % 8 != 0 || N % 8 != 0 || P > 64 || N > kWgN) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WgLayout::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)H, (unsigned)B);
  ssd_wgmma_kernel<<<grid, kWgThreads, WgLayout::bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, a, static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<__nv_bfloat16*>(y), state, L, H, P, G,
      N, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// path: 0 = ffma, 1 = wgmma.  Dynamic shared memory of one block for head
// size P and state size N (0: not supported).
extern "C" int repro_ssd_scan_smem_bytes(int path, int P, int N) {
  if (P <= 0 || N <= 0) return 0;
  if (path == 1) return P % 8 == 0 && N % 8 == 0 && P <= 64 && N <= kWgN ? WgLayout::bytes : 0;
  if (P <= 16 && N <= 32) return Layout<16, 32>::bytes;
  if (P <= 16 && N <= 128) return Layout<16, 128>::bytes;
  if (P <= 64 && N <= 32) return Layout<64, 32>::bytes;
  if (P <= 64 && N <= 128) return Layout<64, 128>::bytes;
  return 0;
}

// The wgmma path's tile: rows of a chunk (which = 0), and the head and
// state sizes a block pads P and N to (which = 1, 2).
extern "C" int repro_ssd_scan_wgmma_tile(int which) {
  return which == 0 ? kWgQ : which == 1 ? 64 : kWgN;
}

// path: 0 = ffma, 1 = wgmma (bf16 only).  dtype of x, B, C and y: 0 =
// float32, 1 = bfloat16; dt and a are float32.  strides: (batch, length,
// head-or-group) of x, dt, B, C and y in elements, 15 values.  Launches on
// `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int repro_ssd_scan(int path, int dtype, const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y, void* state, int B,
                              int L, int H, int P, int G, int N, const long long* strides,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* stf = static_cast<float*>(state);
  if (path == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma(x, dtf, af, bm, cm, y, stf, B, L, H, P, G, N, strides, s);
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(x, dtf, af, bm, cm, y, stf, B, L, H, P, G, N, strides, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dtf, af, bm, cm, y, stf, B, L, H, P, G, N, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
