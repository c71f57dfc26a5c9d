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
// -1e30, not -inf, exactly as the TPU kernel writes them (kernel.py:63-68);
// keys past Skv do not exist (-inf).  q is pre-scaled by 1/sqrt(D) in f32
// and rounded back to its dtype before the product (kernel.py:109-110); the
// final division clamps l at 1e-37 (kernel.py:82).  Output in q's dtype.
//
// What bounds it on the card: operations.  At the serve shape of qwen1.5-0.5b
// (B = 4, Hq = 16, S = 2048, D = 64, causal) attention moves ~34 MB of q, k,
// v and o but does ~34 GFLOP: 10 us of HBM traffic against ~35 us on the bf16
// tensor cores.  Common to both paths:
//   * The TPU kernel carries m, l and the (TQ, D) accumulator in VMEM scratch
//     across a *sequential* KV axis of its grid.  Blocks on Hopper run in
//     parallel and in no order, so here one block owns one (batch, q-head,
//     q tile), loops over its KV tiles itself with the online-softmax
//     statistics and the accumulator in registers, and writes its output
//     tile once.
//   * Only the KV tiles that can hold a live key for the block's rows are
//     visited (the block-skip of kernel.py:44-52): under a causal mask the
//     work is about half the square, and blocks start heaviest-first.
//   * GQA reads KV head h / (Hq/Hk) in place, and q, k, v, o are read and
//     written in the model's (B, S, H, D) layout through strides: no
//     transposed or repeated copies.  Ragged Sq, Skv and D are masked or
//     zero-filled here.
// Two paths, chosen by the wrapper before the launch (ops.choose_path):
//   * wgmma (bf16 with 16-byte rows): flash_fwd_wgmma_kernel.  A block owns
//     128 query rows, 64 for each of two warpgroups.  S = Q K^T is wgmma
//     m64nTKk16 from 128-byte-swizzled shared memory (both operands K-major:
//     D is contiguous); the online softmax runs on the f32 accumulators in
//     registers (row max and sum over the 4 lanes of a quad, exp2 with
//     log2(e) folded into the scores); P is rounded to bf16 in registers and
//     is the register A operand of O += P V (wgmma m64nDk16, V N-major
//     through the transposed-B mode): the accumulator's fragment layout is
//     the A operand's, so P never goes through shared memory.  K and V
//     stream through a 2-stage ring of 16-byte cp.async copies, the next
//     tile's loads in flight under this tile's products.  Element masks run
//     only on tiles that straddle a mask's edge.  Tiles by head size: TK =
//     128 keys at D <= 128 (80 KB and 160 KB of shared memory), 64 at D =
//     256 (192 KB); D pads up to 64, 128 or 256 with zero-filled copies.
//   * ffma (f32, whose parity tolerance is 2e-5 and which one TF32 pass
//     would miss, and bf16 rows that are not 16-byte aligned):
//     flash_fwd_kernel, 64-row q tiles, K and V widened to f32 in padded
//     shared-memory rows, every product with scalar FFMA.
// Under grad the wrapper also passes `lse`, (B, Hq, Sq) f32: each row's
// log-sum-exp of its masked scores q^ k^T, in natural-log units on both paths
// (the wgmma path converts from its log2 units: lse = (m + log2 l) ln 2), so
// that the backward (flash_attention_bwd.cu) recomputes P = exp(S - lse)
// from the same rounded q^.  A null `lse` stores nothing: the launches of a
// forward without grad are those of a forward before the backward existed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/wgmma.cuh"

namespace {

// ------------------------------------------------------------------ FFMA path

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
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int Hq, int Hk, int D,
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
    if (lse != nullptr && tx == 0) lse[((long long)b * Hq + h) * Sq + row] = m[i] + logf(l[i]);
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) store_f(ob + row * o_ss + col, acc[i][j] / denom);
    }
  }
}

// ----------------------------------------------------------------- wgmma path

constexpr int kWgTQ = 128;     // query rows a block: two warpgroups of 64
constexpr int kWgThreads = 256;
constexpr int kWgStages = 2;   // K/V ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DM>
__host__ __device__ constexpr int wg_tk() { return DM >= 256 ? 64 : 128; }  // keys a KV tile
template <int DM>
constexpr int wg_smem_bytes() {  // Q, then the ring of (K, V); + room to align to 1 KB
  return kWgTQ * DM * 2 + kWgStages * 2 * wg_tk<DM>() * DM * 2 + 1024;
}

// Shared memory, every 8-row atom of 1 KB swizzled by row % 8: a tile of R
// rows (queries or keys) by DM columns is DM / 64 panels of R rows x 128
// bytes; chunk c (8 columns) of row r lies at panel c / 8, r * 128 +
// ((c % 8) ^ (r % 8)) * 16.  K serves S = Q K^T as a K-major B (n = keys);
// V serves O += P V as an N-major B (k = keys, n = D), the descriptor's
// leading offset stepping panels and its stride offset 8 key rows.
// Accumulator layout of a warpgroup: warp w % 4 holds rows 16 (w % 4) ..
// + 15; register 4j + 2h + e is (row lane / 4 + 8h, column 8j + 2 (lane % 4)
// + e).  Registers 8t .. 8t + 7 of S are then exactly the A fragment of
// k-step t of P V (rows lane / 4 and + 8, columns 16t + 2 (lane % 4) + {0, 1}
// and + 8), so P feeds the second product from the registers it is made in.
// Grid: B * Hq * ceil(Sq / 128) blocks, the q tiles that see the most keys
// first across every (batch, head).
template <int DM>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int Sq, int Skv, int Hq, int Hk, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int causal, int window) {
  constexpr int TK = wg_tk<DM>();
  constexpr int CH = DM / 8;              // 16-byte chunks of a row
  constexpr int KV_BYTES = TK * DM * 2;   // one of K, V
  constexpr int NS = TK / 2, NO = DM / 2; // accumulator registers of S and O
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + kWgTQ * DM * 2;  // stage s: K at + 2 s KV_BYTES, V after it

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wgi = warp >> 2;
  const int n_qt = (Sq + kWgTQ - 1) / kWgTQ;
  const int n_bh = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;  // the last tiles see the most keys: start them first
  const int h = blockIdx.x % n_bh % Hq, b = blockIdx.x % n_bh / Hq;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * kWgTQ;
  const int q_offset = Skv - Sq;  // suffix convention: the queries are the last Sq positions

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  // Q once: load, scale in f32, round to bf16, store swizzled
  for (int c = tid; c < kWgTQ * CH; c += kWgThreads) {
    const int r = c / CH, ch = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq && ch * 8 < D) {
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * q_ss + ch * 8);
      __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(pr[i]);
        pr[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(q_s + (ch >> 3) * (kWgTQ * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4)) = val;
  }

  // KV tiles that can hold a live key for rows [q0, q0 + kWgTQ)
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + kWgTQ, Sq) - 1 + q_offset;
  const int n_kt = (Skv + TK - 1) / TK;
  int kt_begin = 0, kt_end = n_kt;
  if (causal) kt_end = q_hi < 0 ? 0 : min(n_kt, q_hi / TK + 1);
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / TK;

  auto load_kv = [&](int stage, int kt) {
    const int k0 = kt * TK;
    uint8_t* ks = kv_s + stage * 2 * KV_BYTES;
    uint8_t* vs = ks + KV_BYTES;
#pragma unroll
    for (int i = 0; i < TK * CH / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads, r = c / CH, ch = c % CH;
      const bool ok = k0 + r < Skv && ch * 8 < D;
      const int off = (ch >> 3) * (TK * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
      const long long kofs = (long long)(k0 + r) * k_ss + ch * 8;
      const long long vofs = (long long)(k0 + r) * v_ss + ch * 8;
      cp_async16(ks + off, ok ? kb + kofs : kb, ok);
      cp_async16(vs + off, ok ? vb + vofs : vb, ok);
    }
  };

  const int row = wgi * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's rows: row, row + 8
  const int qpos = q0 + row + q_offset;
  float o_acc[NO], s[NS];
  uint32_t p[TK / 16][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};  // m in log2 units; l this thread's part of the row sum

  if (kt_begin < kt_end) load_kv(0, kt_begin);
  cp_async_commit();
  const uint32_t q_addr = smem_addr(q_s) + wgi * 64 * 128;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait_all();  // tile kt has landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... visible to wgmma
    __syncthreads();      // every thread's; and nobody still reads the other stage
    if (kt + 1 < kt_end) load_kv(stage ^ 1, kt + 1);
    cp_async_commit();
    const uint32_t k_addr = smem_addr(kv_s) + stage * 2 * KV_BYTES, v_addr = k_addr + KV_BYTES;

    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // k-step within a 128-byte panel
      wgmma_ss<TK>(s, smem_desc(q_addr + (kk >> 2) * (kWgTQ * 128) + off, 16, 1024),
                   smem_desc(k_addr + (kk >> 2) * (TK * 128) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scores in log2 units; masks only where the tile straddles a mask's edge
    const int k0 = kt * TK;
    bool full = k0 + TK <= Skv;
    if (causal) full = full && k0 + TK - 1 <= q_lo;
    if (window > 0) full = full && k0 > q_hi - window;
    if (full) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= kLog2e;
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qp = qpos + 8 * ((i >> 1) & 1);
        bool live = true;
        if (causal) live = live && kpos <= qp;
        if (window > 0) live = live && kpos > qp - window;
        s[i] = kpos >= Skv ? -INFINITY : (live ? s[i] * kLog2e : kMask);
      }
    }

    // online softmax, two rows a thread (a row with no live key yet has m =
    // -1e30 and p = 1 for its masked scores; the first live key wipes them
    // through corr)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f(m[hh] - mx);
      m[hh] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = exp2f(s[4 * j + 2 * hh + e] - mx);
          s[4 * j + 2 * hh + e] = pe;
          rs += pe;
        }
      l[hh] = l[hh] * corr + rs;
#pragma unroll
      for (int j = 0; j < DM / 8; ++j) {
        o_acc[4 * j + 2 * hh] *= corr;
        o_acc[4 * j + 2 * hh + 1] *= corr;
      }
    }
#pragma unroll
    for (int t = 0; t < TK / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);

    fence_regs(o_acc);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < TK / 16; ++t)
      wgmma_rs<DM>(o_acc, p[t], smem_desc(v_addr + t * 16 * 128, TK * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
    fence_regs(p);
  }
  cp_async_wait_all();

  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = q0 + row + 8 * hh;
    if (r >= Sq) continue;
    const float denom = fmaxf(lt, 1e-37f);
    if (lse != nullptr && (lane & 3) == 0)  // m is quad-uniform, in log2 units
      lse[((long long)b * Hq + h) * Sq + r] = (m[hh] + log2f(lt)) * kLn2;
#pragma unroll
    for (int j = 0; j < DM / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);  // D % 8 == 0: the pair is in or out
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r * o_ss + col) =
            __floats2bfloat162_rn(o_acc[4 * j + 2 * hh] / denom, o_acc[4 * j + 2 * hh + 1] / denom);
    }
  }
}

template <typename T, int DM>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Skv,
           int Hq, int Hk, int D, const long long* st, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((Sq + kTQ - 1) / kTQ), (unsigned)Hq, (unsigned)B);
  flash_fwd_kernel<T, DM><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Skv, Hq, Hk, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Skv,
                 int Hq, int Hk, int D, const long long* st, float scale, int causal, int window,
                 cudaStream_t stream) {
  constexpr int bytes = wg_smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)B * Hq * ((Sq + kWgTQ - 1) / kWgTQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_wgmma_kernel<DM><<<(unsigned)blocks, kWgThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, Hq, Hk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Skv,
               int Hq, int Hk, int D, const long long* st, float scale, int causal,
               int window, cudaStream_t s) {
  if (D <= 32) return launch<T, 32>(q, k, v, o, lse, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  if (D <= 64) return launch<T, 64>(q, k, v, o, lse, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  if (D <= 128) return launch<T, 128>(q, k, v, o, lse, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  if (D <= 256) return launch<T, 256>(q, k, v, o, lse, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Skv,
                   int Hq, int Hk, int D, const long long* st, float scale, int causal,
                   int window, cudaStream_t s) {
  if (D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);  // 16-byte rows
  if (D <= 64) return launch_wgmma<64>(q, k, v, o, lse, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  if (D <= 128) return launch_wgmma<128>(q, k, v, o, lse, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  if (D <= 256) return launch_wgmma<256>(q, k, v, o, lse, B, Sq, Skv, Hq, Hk, D, st, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// path: 0 = ffma, 1 = wgmma.  Dynamic shared memory of one block for head
// size D (0: D not supported).
extern "C" int repro_flash_attention_smem_bytes(int path, int D) {
  if (D <= 0) return 0;
  if (path == 1) {
    if (D <= 64) return wg_smem_bytes<64>();
    if (D <= 128) return wg_smem_bytes<128>();
    if (D <= 256) return wg_smem_bytes<256>();
    return 0;
  }
  if (D <= 32) return smem_bytes<32>();
  if (D <= 64) return smem_bytes<64>();
  if (D <= 128) return smem_bytes<128>();
  if (D <= 256) return smem_bytes<256>();
  return 0;
}

// Query rows (which = 0) or keys (which = 1) of a block's tile on `path`
// for head size D.
extern "C" int repro_flash_attention_tile(int path, int D, int which) {
  if (path == 1) {
    if (which == 0) return kWgTQ;
    return D <= 128 ? wg_tk<128>() : wg_tk<256>();
  }
  return which == 0 ? kTQ : kTK;
}

// path: 0 = ffma, 1 = wgmma (bf16 only).  dtype: 0 = float32, 1 =
// bfloat16.  strides: (batch, seq, head) of q, k, v and o in elements, 12
// values; the head dimension is unit-stride.  lse: null, or (B, Hq, Sq) f32
// contiguous, each row's log-sum-exp (natural log).  Launches on `stream` and
// returns the CUDA error of the launch (0 on success).
extern "C" int repro_flash_attention(int path, int dtype, const void* q, const void* k,
                                     const void* v, void* o, float* lse, int B, int Sq, int Skv, int Hq,
                                     int Hk, int D, const long long* strides, float scale,
                                     int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || Hq % Hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (path == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_wgmma(q, k, v, o, lse, B, Sq, Skv, Hq, Hk, D, strides, scale, causal, window, s);
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, lse, B, Sq, Skv, Hq, Hk, D, strides, scale, causal, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Skv, Hq, Hk, D, strides, scale, causal,
                                     window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
