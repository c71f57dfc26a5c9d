// Flash-attention backward on Hopper's tensor cores (sm_90a), path bwd_wgmma:
// dq, dk, dv of the forward in flash_attention.cu for bf16 with 16-byte rows
// (D % 8 == 0, D <= 256), causal / sliding-window / bidirectional / GQA, with
// the suffix offset Skv - Sq.  f32, and bf16 rows that are not 16-byte
// aligned, take bwd_ffma (flash_attention_bwd.cu), whose f32 gradients hold
// 1e-4, which one TF32 pass would miss.
//
// Replaces the backward of the TPU kernel's custom VJP
// (src/repro/kernels/flash_attention/ops.py:43-46, _bwd: the vjp of
// attention_chunked at the suffix offset); the Pallas kernel (kernel.py:89,
// pallas_call at :113) is a forward only.  The function is the one of
// flash_attention_bwd.cu: with q^ = q / sqrt(D) rounded to bf16 exactly as
// the forward rounds it (P normalises against the saved natural-log lse only
// if the scores are recomputed from the same q^), S = q^ k^T,
// P = exp(S - lse) on the live pairs (0 elsewhere), delta_i = sum_d dO_i O_i:
//
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),  dK = dS^T q^,  dQ = dS K / sqrt(D)
//
// What bounds it on the card: operations at every timed shape but the 8 x 128
// training shapes, where bytes do (e.g. qwen's 8 x 128, D 64: 0.54 GFLOP
// against 16.8 MB).  Every product runs on wgmma (bf16 operands from 128-byte
// swizzled shared memory or registers, f32 accumulators), P and dS are
// rounded to bf16 for their products as the forward rounds P, and there are
// no atomics: a backward is deterministic, the same inputs give the same bits.
// Four kernels:
//   * flash_bwd_preprocess_wgmma_kernel: delta (B, Hq, Sq) f32 and q^
//     (B, Hq, Sq, D) bf16 in one pass, one warp a row: cp.async cannot scale
//     q on its way into shared memory, so the two products that read q^ copy
//     it rounded once.  A launch of its own, not fused into dQ's prologue:
//     the dK/dV kernel, which runs first, reads delta and q^ too.
//   * flash_bwd_dkdv_wgmma_kernel: one block owns (batch, KV head, a tile of
//     keys, a split of the group's query heads), K and V resident in shared
//     memory; q^, dO, lse and delta of each (head, q tile) it walks
//     (ops.q_tiles) stream through a two-stage cp.async ring.  At D <= 128
//     a block is one warpgroup owning 64 keys, two blocks an SM (at most
//     255 registers a thread), so that one block's exp2 on the SFU runs
//     under another's wgmma: S^T = K q^T and
//     dP^T = V dO^T on wgmma (both operands K-major), P^T and dS^T in
//     registers (lse and delta broadcast per column), then dV += P^T dO and
//     dK += dS^T q^ with P^T and dS^T as the register A operand and dO, q^
//     N-major (the forward's P V).  At D = 256 the 64 x 256 dK and dV
//     accumulators would need 256 registers a thread, so the block owns 64
//     keys and its warpgroups split the work with A and B swapped: each
//     makes S^T and dP^T for 32 of the 64 q rows, stages P^T and dS^T in
//     shared memory as bf16, and accumulates dV^T = dO^T P and dK^T = q^T dS
//     for 128 of the 256 columns, dO^T and q^T read MN-major from the ring
//     (FlashAttention-3's hdim-256 backward).
//   * flash_bwd_dq_wgmma_kernel: one block, one warpgroup, owns (batch, q
//     head, 64 q rows) and walks the KV tiles the forward walks
//     (ops.kv_tiles), K and V through a two-stage ring: S and dP on wgmma,
//     dS in registers, dQ += dS K as the register A operand with K N-major;
//     1/sqrt(D) at the store.  Recomputing S and dP here issues 14 D FLOP a
//     visited pair against the bound's 8 D: the price of no atomics.
//   * flash_bwd_split_reduce_kernel: where (batch, KV head, key tile) blocks
//     are too few for the card (ops.bwd_head_splits: MQA, short sequences),
//     the group's query heads are split across blocks; each split writes f32
//     partial dK, dV into a workspace the wrapper allocates, and this kernel
//     sums them in split order and casts them.  One split: no workspace, no
//     launch.
// Shared memory (+ 1 KB to align): dK/dV at D = 64 / 128: K, V (64 keys)
// 16 / 32 KB, the q^/dO ring 32 / 64 KB, lse/delta 1 KB; at D = 256: K, V
// (64 keys) 64 KB, ring 128 KB, P^T and dS^T 16 KB, lse/delta 1 KB: 210 KB
// of the 227.  dQ: q^ and dO of 64 rows 16 / 32 / 64 KB and the K/V ring of
// 64 keys (32 at D = 256) 32 / 64 / 64 KB.  Ragged Sq, Skv and D are
// zero-filled copies (D pads to 64, 128 or 256) with masks only on tiles
// that straddle an edge; k, v, o, dO are read and dq, dk, dv written in the
// model's (B, S, H, D) layout through strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/wgmma.cuh"

namespace {

constexpr int kThreads = 256;  // the preprocess and the split reduce
constexpr int kTQ = 64;        // q rows of a dK/dV step and of a dQ block (one warpgroup)
constexpr int kTK = 64;        // keys of a dK/dV block
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {               // x[b, s, h, d] at x + b*sb + s*ss + h*sh + d
  long long sb, ss, sh;
};

template <int DM>
__host__ __device__ constexpr bool split_d() { return DM >= 256; }
template <int DM>
__host__ __device__ constexpr int dkdv_threads() { return split_d<DM>() ? 256 : 128; }
template <int DM>
__host__ __device__ constexpr int dq_tk() { return DM >= 256 ? 32 : 64; }   // keys a dQ KV tile

template <int DM>
constexpr int dkdv_smem_bytes() {  // K, V; the (q^, dO) ring; P^T, dS^T; the (lse, delta) ring
  return 2 * kTK * DM * 2 + 2 * 2 * kTQ * DM * 2 + (split_d<DM>() ? 2 * kTK * kTQ * 2 : 0) +
         2 * 2 * kTQ * 4 + 1024;
}
template <int DM>
constexpr int dq_smem_bytes() {    // q^, dO; the (K, V) ring
  return 2 * kTQ * DM * 2 + 2 * 2 * dq_tk<DM>() * DM * 2 + 1024;
}

__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// Byte offset of 16-byte chunk ch of row r in a swizzled tile of R rows
// (DM / 64 panels of R rows x 128 bytes; see flash_attention.cu)
template <int R>
__device__ __forceinline__ int swz(int r, int ch) {
  return (ch >> 3) * (R * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// Rows [r0, r0 + R) of a bf16 matrix (row stride ld elements) into a
// swizzled tile, by NT threads; zero past n_rows and D
template <int R, int DM, int NT>
__device__ __forceinline__ void load_tile(uint8_t* dst, const __nv_bfloat16* src, long long ld,
                                          int r0, int n_rows, int D) {
  constexpr int CH = DM / 8;
  static_assert(R * CH % NT == 0, "tile chunks must split evenly over the threads");
#pragma unroll
  for (int i = 0; i < R * CH / NT; ++i) {
    const int c = threadIdx.x + i * NT, r = c / CH, ch = c % CH;
    const bool ok = r0 + r < n_rows && ch * 8 < D;
    cp_async16(dst + swz<R>(r, ch), ok ? src + (long long)(r0 + r) * ld + ch * 8 : src, ok);
  }
}

// ------------------------------------------------------------ preprocess

// delta[(b Hq + h) Sq + i] = sum_d dO[b, i, h, d] O[b, i, h, d] and
// q^[((b Hq + h) Sq + i) D + d] = bf16(q[b, i, h, d] / sqrt(D)); one warp a
// row, 8 columns a lane (D % 8 == 0, 16-byte rows)
__global__ void __launch_bounds__(kThreads) flash_bwd_preprocess_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
    __nv_bfloat16* __restrict__ qh, int B, int Sq, int Hq, int D, Strides qs, Strides os,
    Strides gs, float scale) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= (long long)B * Hq * Sq) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(row % Sq);
  const long long bh = row / Sq;
  const int h = (int)(bh % Hq), b = (int)(bh / Hq);
  const __nv_bfloat16* qb = q + b * qs.sb + i * qs.ss + h * qs.sh;
  const __nv_bfloat16* ob = o + b * os.sb + i * os.ss + h * os.sh;
  const __nv_bfloat16* gb = dout + b * gs.sb + i * gs.ss + h * gs.sh;
  float acc = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 qv = *reinterpret_cast<const uint4*>(qb + c);
    const uint4 ov = *reinterpret_cast<const uint4*>(ob + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(gb + c);
    __nv_bfloat162* qp = reinterpret_cast<__nv_bfloat162*>(&qv);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fo = __bfloat1622float2(op[j]), fg = __bfloat1622float2(gp[j]);
      acc = fmaf(fo.x, fg.x, acc);
      acc = fmaf(fo.y, fg.y, acc);
      const float2 fq = __bfloat1622float2(qp[j]);
      qp[j] = __floats2bfloat162_rn(fq.x * scale, fq.y * scale);
    }
    *reinterpret_cast<uint4*>(qh + row * D + c) = qv;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ------------------------------------------------------------ dK, dV

// Two values of dk / dv row `key`, columns d and d + 1 (d even, D even): f32
// into the split's workspace slice, or bf16 into the output
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, Strides st, float* ws, long long wofs,
                                           int b, int key, int hk, int d, float x, float y) {
  if (ws != nullptr)
    *reinterpret_cast<float2*>(ws + wofs) = make_float2(x, y);
  else
    *reinterpret_cast<__nv_bfloat162*>(out + b * st.sb + key * st.ss + hk * st.sh + d) =
        __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_one(__nv_bfloat16* out, Strides st, float* ws, long long wofs,
                                          int b, int key, int hk, int d, float x) {
  if (ws != nullptr)
    ws[wofs] = x;
  else
    out[b * st.sb + key * st.ss + hk * st.sh + d] = __float2bfloat16(x);
}

// Grid: ceil(Skv / kTK) * splits * Hk * B blocks, key tile slowest: under a
// causal mask the first key tiles see the most q tiles, so they start first.
// ws: null (one split), or 2 * splits slices of B * Skv * Hk * D f32 (dK's,
// then dV's), split sp's partial sums at slice sp.  window <= 0: no window.
template <int DM>
__global__ void __launch_bounds__(dkdv_threads<DM>()) flash_bwd_dkdv_wgmma_kernel(
    const __nv_bfloat16* __restrict__ qh, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, float* __restrict__ ws, int B, int Sq, int Skv, int Hq, int Hk,
    int D, int splits, int heads_per_split, Strides ks_, Strides vs_, Strides gs_, Strides dks_,
    Strides dvs_, int causal, int window) {
  constexpr int TK = kTK, NT = dkdv_threads<DM>();
  constexpr bool SPLIT_D = split_d<DM>();
  constexpr int TILE_KV = TK * DM * 2, TILE_Q = kTQ * DM * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align_1k(smem_raw);
  uint8_t* v_s = k_s + TILE_KV;
  uint8_t* ring = v_s + TILE_KV;               // stage s: q^ at + 2 s TILE_Q, dO after it
  uint8_t* pt_s = ring + 4 * TILE_Q;           // D = 256: P^T [TK keys][kTQ q], then dS^T
  uint8_t* dst_s = pt_s + TK * kTQ * 2;
  float* ld_s = reinterpret_cast<float*>(pt_s + (SPLIT_D ? 2 * TK * kTQ * 2 : 0));  // stage s: lse, delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int per_kt = splits * Hk * B;
  const int kt = blockIdx.x / per_kt;
  int rest = blockIdx.x % per_kt;
  const int sp = rest % splits;
  rest /= splits;
  const int hk = rest % Hk, b = rest / Hk;
  const int group = Hq / Hk;
  const int h_begin = hk * group + sp * heads_per_split;
  const int n_heads = max(0, min(group, (sp + 1) * heads_per_split) - sp * heads_per_split);
  const int k0 = kt * TK;
  const long long q_offset = (long long)Skv - Sq;

  // the q tiles that can see a key of this tile (ops.q_tiles): rows
  // [i_lo, i_hi], every one of which holds a live pair with the tile
  const long long k_hi = min(k0 + TK, Skv) - 1;
  long long i_lo = 0, i_hi = Sq - 1;
  if (causal) i_lo = max(i_lo, k0 - q_offset);
  if (window > 0) i_hi = min(i_hi, k_hi + window - 1 - q_offset);
  const int qt_begin = i_lo <= i_hi ? (int)(i_lo / kTQ) : 0;
  const int n_qt = i_lo <= i_hi ? (int)(i_hi / kTQ) + 1 - qt_begin : 0;
  const int n_it = n_qt * n_heads;              // (head, q tile), heads slowest

  load_tile<TK, DM, NT>(k_s, k + b * ks_.sb + hk * ks_.sh, ks_.ss, k0, Skv, D);
  load_tile<TK, DM, NT>(v_s, v + b * vs_.sb + hk * vs_.sh, vs_.ss, k0, Skv, D);
  auto load_q = [&](int stage, int it) {
    const int h = h_begin + it / n_qt, q0 = (qt_begin + it % n_qt) * kTQ;
    uint8_t* qs = ring + stage * 2 * TILE_Q;
    load_tile<kTQ, DM, NT>(qs, qh + ((long long)b * Hq + h) * Sq * D, D, q0, Sq, D);
    load_tile<kTQ, DM, NT>(qs + TILE_Q, dout + b * gs_.sb + h * gs_.sh, gs_.ss, q0, Sq, D);
    if (tid < 2 * kTQ) {
      const int r = tid % kTQ;
      const float* src = (tid < kTQ ? lse : delta) + ((long long)b * Hq + h) * Sq;
      const bool ok = q0 + r < Sq;
      cp_async4(ld_s + stage * 2 * kTQ + tid, ok ? src + q0 + r : src, ok);
    }
  };
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  const uint32_t k_addr = smem_addr(k_s), v_addr = smem_addr(v_s);
  float* const wsk = ws;
  const long long n_out = (long long)B * Skv * Hk * D;  // one workspace slice
  if constexpr (!SPLIT_D) {
    // one warpgroup: the tile's 64 keys, every column
    constexpr int NO = DM / 2;
    float dv_acc[NO], dk_acc[NO], st[32], dpt[32];   // S^T, dP^T: 64 keys x 64 q rows
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < NO; ++i) dv_acc[i] = dk_acc[i] = 0.f;
    const int key_base = k0 + warp * 16 + (lane >> 2);  // this thread's keys: + 0, + 8
    for (int it = 0; it < n_it; ++it) {
      const int stage = it & 1;
      cp_async_wait_all();  // stage `stage` has landed (this thread's copies)
      fence_proxy_async();  // ... visible to wgmma
      __syncthreads();      // every thread's; and nobody still reads the other stage
      if (it + 1 < n_it) load_q(stage ^ 1, it + 1);
      cp_async_commit();
      const int q0 = (qt_begin + it % n_qt) * kTQ;
      const uint32_t q_addr = smem_addr(ring + stage * 2 * TILE_Q), g_addr = q_addr + TILE_Q;
      const float* lse_t = ld_s + stage * 2 * kTQ;
      const float* dl_t = lse_t + kTQ;

#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;  // the last step's P^T, dS^T are dead
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk) {
        const uint32_t ok = (kk >> 2) * (TK * 128) + (kk & 3) * 32;
        const uint32_t oq = (kk >> 2) * (kTQ * 128) + (kk & 3) * 32;
        wgmma_ss<64>(st, smem_desc(k_addr + ok, 16, 1024), smem_desc(q_addr + oq, 16, 1024), kk > 0);
        wgmma_ss<64>(dpt, smem_desc(v_addr + ok, 16, 1024), smem_desc(g_addr + oq, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T; masks only where the tile straddles an edge
      const long long q_lo = q0 + q_offset, q_hi = min(q0 + kTQ, Sq) - 1 + q_offset;
      bool full = q0 + kTQ <= Sq && k0 + TK <= Skv;
      if (causal) full = full && k0 + TK - 1 <= q_lo;
      if (window > 0) full = full && k0 > q_hi - window;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qi = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        float p = exp2f(fmaf(st[i], kLog2e, -lse_t[qi] * kLog2e));
        if (!full) {
          const int key = key_base + 8 * ((i >> 1) & 1);
          const long long qpos = q0 + qi + q_offset;
          bool live = q0 + qi < Sq && key < Skv;
          if (causal) live = live && key <= qpos;
          if (window > 0) live = live && key > qpos - window;
          p = live ? p : 0.f;
        }
        st[i] = p;
        dpt[i] = p * (dpt[i] - dl_t[qi]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[t][r] = pack_bf16(st[8 * t + 2 * r], st[8 * t + 2 * r + 1]);
          da[t][r] = pack_bf16(dpt[8 * t + 2 * r], dpt[8 * t + 2 * r + 1]);
        }

      // dV += P^T dO, dK += dS^T q^: k = q rows, dO and q^ N-major
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        wgmma_rs<DM>(dv_acc, pa[t], smem_desc(g_addr + t * 16 * 128, kTQ * 128, 1024));
        wgmma_rs<DM>(dk_acc, da[t], smem_desc(q_addr + t * 16 * 128, kTQ * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
    }
    cp_async_wait_all();
#pragma unroll
    for (int i = 0; i < NO; i += 2) {
      const int key = key_base + 8 * ((i >> 1) & 1);
      const int d = 8 * (i >> 2) + 2 * (lane & 3);   // D % 8 == 0: the pair is in or out
      if (key >= Skv || d >= D) continue;
      const long long wofs = (((long long)b * Skv + key) * Hk + hk) * D + d;
      store_pair(dk, dks_, wsk == nullptr ? nullptr : wsk + sp * n_out, wofs, b, key, hk, d,
                 dk_acc[i], dk_acc[i + 1]);
      store_pair(dv, dvs_, wsk == nullptr ? nullptr : wsk + (splits + sp) * n_out, wofs, b, key,
                 hk, d, dv_acc[i], dv_acc[i + 1]);
    }
  } else {
    // D = 256, 64 keys: warpgroup wg makes S^T, dP^T for q rows [32 wg, 32 wg
    // + 32) and accumulates dV^T, dK^T for columns [128 wg, 128 wg + 128)
    float dvt[2][32], dkt[2][32], st[16], dpt[16];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) dvt[m][i] = dkt[m][i] = 0.f;
    const uint32_t pt_addr = smem_addr(pt_s), dst_addr = smem_addr(dst_s);
    const int krow = (warp & 3) * 16 + (lane >> 2);  // this thread's keys in the tile: + 0, + 8
    for (int it = 0; it < n_it; ++it) {
      const int stage = it & 1;
      cp_async_wait_all();
      fence_proxy_async();
      __syncthreads();      // also: both warpgroups are done with the last P^T and dS^T
      if (it + 1 < n_it) load_q(stage ^ 1, it + 1);
      cp_async_commit();
      const int q0 = (qt_begin + it % n_qt) * kTQ;
      const uint32_t q_addr = smem_addr(ring + stage * 2 * TILE_Q), g_addr = q_addr + TILE_Q;
      const float* lse_t = ld_s + stage * 2 * kTQ;
      const float* dl_t = lse_t + kTQ;

#pragma unroll
      for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk) {
        const uint32_t ok = (kk >> 2) * (TK * 128) + (kk & 3) * 32;
        const uint32_t oq = (kk >> 2) * (kTQ * 128) + wg * 32 * 128 + (kk & 3) * 32;
        wgmma_ss<32>(st, smem_desc(k_addr + ok, 16, 1024), smem_desc(q_addr + oq, 16, 1024), kk > 0);
        wgmma_ss<32>(dpt, smem_desc(v_addr + ok, 16, 1024), smem_desc(g_addr + oq, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      const long long q_lo = q0 + q_offset, q_hi = min(q0 + kTQ, Sq) - 1 + q_offset;
      bool full = q0 + kTQ <= Sq && k0 + TK <= Skv;
      if (causal) full = full && k0 + TK - 1 <= q_lo;
      if (window > 0) full = full && k0 > q_hi - window;
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int key = krow + 8 * ((i >> 1) & 1);
        const int qi = wg * 32 + 8 * (i >> 2) + 2 * (lane & 3);
        float pr[2], dr[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f(fmaf(st[i + e], kLog2e, -lse_t[qi + e] * kLog2e));
          if (!full) {
            const long long qpos = q0 + qi + e + q_offset;
            bool live = q0 + qi + e < Sq && k0 + key < Skv;
            if (causal) live = live && k0 + key <= qpos;
            if (window > 0) live = live && k0 + key > qpos - window;
            p = live ? p : 0.f;
          }
          pr[e] = p;
          dr[e] = p * (dpt[i + e] - dl_t[qi + e]);
        }
        // P^T and dS^T as [key][q] rows of 128 bytes, swizzled: the K-major B
        // of the products below (k = q rows)
        const int ofs = key * 128 + ((((qi >> 3) ^ (key & 7))) << 4) + (qi & 7) * 2;
        *reinterpret_cast<uint32_t*>(pt_s + ofs) = pack_bf16(pr[0], pr[1]);
        *reinterpret_cast<uint32_t*>(dst_s + ofs) = pack_bf16(dr[0], dr[1]);
      }
      fence_proxy_async();
      __syncthreads();      // P^T and dS^T of both halves stored

      // dV^T += dO^T P, dK^T += q^T dS: m = 64 columns of a panel, n = keys,
      // k = q rows; dO^T and q^T MN-major from the ring
      fence_regs(dvt[0]);
      fence_regs(dvt[1]);
      fence_regs(dkt[0]);
      fence_regs(dkt[1]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t panel = (2 * wg + m) * (kTQ * 128);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          wgmma_ss_ta<64>(dvt[m], smem_desc(g_addr + panel + t * 16 * 128, kTQ * 128, 1024),
                          smem_desc(pt_addr + t * 32, 16, 1024), 1);
          wgmma_ss_ta<64>(dkt[m], smem_desc(q_addr + panel + t * 16 * 128, kTQ * 128, 1024),
                          smem_desc(dst_addr + t * 32, 16, 1024), 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dvt[0]);
      fence_regs(dvt[1]);
      fence_regs(dkt[0]);
      fence_regs(dkt[1]);
    }
    cp_async_wait_all();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int d = 64 * (2 * wg + m) + (warp & 3) * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (key >= Skv || d >= D) continue;
        const long long wofs = (((long long)b * Skv + key) * Hk + hk) * D + d;
        store_one(dk, dks_, wsk == nullptr ? nullptr : wsk + sp * n_out, wofs, b, key, hk, d,
                  dkt[m][i]);
        store_one(dv, dvs_, wsk == nullptr ? nullptr : wsk + (splits + sp) * n_out, wofs, b, key,
                  hk, d, dvt[m][i]);
      }
  }
}

// dk, dv = the sum of the splits' partials, in split order, cast to bf16
__global__ void __launch_bounds__(kThreads) flash_bwd_split_reduce_kernel(
    const float* __restrict__ ws, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int splits, int B, int Skv, int Hk, int D, Strides dks, Strides dvs) {
  const long long n = (long long)B * Skv * Hk * D;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += ws[s * n + e];
      c += ws[(splits + s) * n + e];
    }
    const int d = (int)(e % D);
    long long t = e / D;
    const int hk = (int)(t % Hk);
    t /= Hk;
    const int key = (int)(t % Skv), b = (int)(t / Skv);
    dk[b * dks.sb + key * dks.ss + hk * dks.sh + d] = __float2bfloat16(a);
    dv[b * dvs.sb + key * dvs.ss + hk * dvs.sh + d] = __float2bfloat16(c);
  }
}

// ------------------------------------------------------------ dQ

// Grid: B * Hq * ceil(Sq / TQ) blocks, the q tiles that see the most keys
// first across every (batch, head).  window <= 0: no window.
template <int DM>
__global__ void __launch_bounds__(128) flash_bwd_dq_wgmma_kernel(
    const __nv_bfloat16* __restrict__ qh, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int B, int Sq, int Skv, int Hq, int Hk, int D, Strides ks_, Strides vs_, Strides gs_,
    Strides dqs_, float scale, int causal, int window) {
  constexpr int NT = 128, TQ = kTQ, TK = dq_tk<DM>();
  constexpr int TILE_Q = TQ * DM * 2, TILE_KV = TK * DM * 2;
  constexpr int NS = TK / 2, NO = DM / 2;  // accumulator registers of S (and dP), dQ
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1k(smem_raw);
  uint8_t* g_s = q_s + TILE_Q;
  uint8_t* kv_s = g_s + TILE_Q;               // stage s: K at + 2 s TILE_KV, V after it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_qt = (Sq + TQ - 1) / TQ;
  const int n_bh = B * Hq;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;  // the last tiles see the most keys: start them first
  const int h = blockIdx.x % n_bh % Hq, b = blockIdx.x % n_bh / Hq;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * TQ;
  const int q_offset = Skv - Sq;
  const __nv_bfloat16* kb = k + b * ks_.sb + hk * ks_.sh;
  const __nv_bfloat16* vb = v + b * vs_.sb + hk * vs_.sh;

  load_tile<TQ, DM, NT>(q_s, qh + ((long long)b * Hq + h) * Sq * D, D, q0, Sq, D);
  load_tile<TQ, DM, NT>(g_s, dout + b * gs_.sb + h * gs_.sh, gs_.ss, q0, Sq, D);

  // the KV tiles the forward visits (ops.kv_tiles)
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + TQ, Sq) - 1 + q_offset;
  const int n_kt = (Skv + TK - 1) / TK;
  int kt_begin = 0, kt_end = n_kt;
  if (causal) kt_end = q_hi < 0 ? 0 : min(n_kt, q_hi / TK + 1);
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / TK;

  auto load_kv = [&](int stage, int kt) {
    uint8_t* ks = kv_s + stage * 2 * TILE_KV;
    load_tile<TK, DM, NT>(ks, kb, ks_.ss, kt * TK, Skv, D);
    load_tile<TK, DM, NT>(ks + TILE_KV, vb, vs_.ss, kt * TK, Skv, D);
  };
  if (kt_begin < kt_end) load_kv(0, kt_begin);
  cp_async_commit();

  const int row = warp * 16 + (lane >> 2);  // this thread's rows: row, row + 8
  const long long bh_row = ((long long)b * Hq + h) * Sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + row + 8 * hh;
    lse2[hh] = r < Sq ? lse[bh_row + r] * kLog2e : 0.f;
    dl[hh] = r < Sq ? delta[bh_row + r] : 0.f;
  }
  float dq_acc[NO], s[NS], dp[NS];
  uint32_t da[TK / 16][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq_acc[i] = 0.f;

  const uint32_t q_addr = smem_addr(q_s), g_addr = smem_addr(g_s);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < kt_end) load_kv(stage ^ 1, kt + 1);
    cp_async_commit();
    const uint32_t k_addr = smem_addr(kv_s) + stage * 2 * TILE_KV, v_addr = k_addr + TILE_KV;

#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;  // the last step's dS is dead
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      const uint32_t oq = (kk >> 2) * (TQ * 128) + (kk & 3) * 32;
      const uint32_t ok = (kk >> 2) * (TK * 128) + (kk & 3) * 32;
      wgmma_ss<TK>(s, smem_desc(q_addr + oq, 16, 1024), smem_desc(k_addr + ok, 16, 1024), kk > 0);
      wgmma_ss<TK>(dp, smem_desc(g_addr + oq, 16, 1024), smem_desc(v_addr + ok, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS in registers (rows past Sq are never stored; no mask needed there)
    const int k0 = kt * TK;
    bool full = k0 + TK <= Skv;
    if (causal) full = full && k0 + TK - 1 <= q_lo;
    if (window > 0) full = full && k0 > q_hi - window;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int hh = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], kLog2e, -lse2[hh]));
      if (!full) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qp = q0 + row + 8 * hh + q_offset;
        bool live = kpos < Skv;
        if (causal) live = live && kpos <= qp;
        if (window > 0) live = live && kpos > qp - window;
        p = live ? p : 0.f;
      }
      s[i] = p * (dp[i] - dl[hh]);
    }
#pragma unroll
    for (int t = 0; t < TK / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) da[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);

    // dQ += dS K: k = keys, K N-major
    fence_regs(dq_acc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < TK / 16; ++t)
      wgmma_rs<DM>(dq_acc, da[t], smem_desc(k_addr + t * 16 * 128, TK * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);
    fence_regs(da);
  }
  cp_async_wait_all();

  __nv_bfloat16* dqb = dq + b * dqs_.sb + h * dqs_.sh;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int r = q0 + row + 8 * ((i >> 1) & 1);
    const int d = 8 * (i >> 2) + 2 * (lane & 3);
    if (r < Sq && d < D)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)r * dqs_.ss + d) =
          __floats2bfloat162_rn(dq_acc[i] * scale, dq_acc[i + 1] * scale);
  }
}

// ------------------------------------------------------------ launches

Strides at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

template <int DM>
int launch_dkdv(const void* qh, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, float* ws, int B, int Sq, int Skv, int Hq,
                int Hk, int D, int splits, int hps, const long long* st, int causal, int window,
                cudaStream_t s) {
  constexpr int bytes = dkdv_smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)((Skv + kTK - 1) / kTK) * splits * Hk * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  flash_bwd_dkdv_wgmma_kernel<DM><<<(unsigned)blocks, dkdv_threads<DM>(), bytes, s>>>(
      static_cast<const __nv_bfloat16*>(qh), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), ws, B, Sq, Skv, Hq, Hk, D,
      splits, hps, at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4), causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int launch_dq(const void* qh, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int Sq, int Skv, int Hq, int Hk, int D,
              const long long* st, float scale, int causal, int window, cudaStream_t s) {
  constexpr int bytes = dq_smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)B * Hq * ((Sq + kTQ - 1) / kTQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  flash_bwd_dq_wgmma_kernel<DM><<<(unsigned)blocks, 128, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(qh), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), B, Sq, Skv, Hq, Hk, D, at(st, 0), at(st, 1), at(st, 2),
      at(st, 3), scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int check(int Hq, int Hk, int D) {
  if (Hk <= 0 || Hq % Hk != 0 || D <= 0 || D > 256 || D % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Query rows and keys of the bwd_wgmma tiles for head size D: which = 0, 1
// the dK/dV kernel's (q rows a step, keys a block), 2, 3 the dQ kernel's
// (q rows a block, keys a step).
extern "C" int repro_flash_attention_bwd_wgmma_tile(int D, int which) {
  const bool wide = D > 128;
  switch (which) {
    case 0: return kTQ;
    case 1: return kTK;
    case 2: return kTQ;
    case 3: return wide ? dq_tk<256>() : dq_tk<128>();
    default: return 0;
  }
}

// Dynamic shared memory of a dK/dV (which = 0) or dQ (which = 1) block for
// head size D (0: D not supported).
extern "C" int repro_flash_attention_bwd_wgmma_smem_bytes(int D, int which) {
  if (D <= 0 || D > 256) return 0;
  if (D <= 64) return which == 0 ? dkdv_smem_bytes<64>() : dq_smem_bytes<64>();
  if (D <= 128) return which == 0 ? dkdv_smem_bytes<128>() : dq_smem_bytes<128>();
  return which == 0 ? dkdv_smem_bytes<256>() : dq_smem_bytes<256>();
}

// delta (B, Hq, Sq) f32 and q^ (B, Hq, Sq, D) bf16, both contiguous.
// strides: (batch, seq, head) of q, o and dO in elements, 9 values.  Each
// entry launches on `stream` and returns the CUDA error of its launch (0 on
// success).
extern "C" int repro_flash_attention_bwd_wgmma_preprocess(const void* q, const void* o,
                                                          const void* dout, float* delta,
                                                          void* qh, int B, int Sq, int Hq, int D,
                                                          const long long* strides, float scale,
                                                          void* stream) {
  if (D <= 0 || D > 256 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)B * Hq * Sq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  flash_bwd_preprocess_wgmma_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta, static_cast<__nv_bfloat16*>(qh), B, Sq, Hq,
      D, at(strides, 0), at(strides, 1), at(strides, 2), scale);
  return static_cast<int>(cudaGetLastError());
}

// strides: (batch, seq, head) of k, v, dO, dk and dv, 15 values.  qh, lse and
// delta contiguous as the preprocess writes them.  ws: null when splits ==
// 1, else 2 * splits * B * Skv * Hk * D f32; split sp takes the group's
// query heads [sp * heads_per_split, (sp + 1) * heads_per_split).
extern "C" int repro_flash_attention_bwd_wgmma_dkdv(const void* qh, const void* k, const void* v,
                                                    const void* dout, const float* lse,
                                                    const float* delta, void* dk, void* dv,
                                                    float* ws, int B, int Sq, int Skv, int Hq,
                                                    int Hk, int D, int splits, int heads_per_split,
                                                    const long long* strides, int causal,
                                                    int window, void* stream) {
  if (int err = check(Hq, Hk, D)) return err;
  if (splits < 1 || heads_per_split < 1 || (splits > 1) != (ws != nullptr) ||
      (long long)(splits - 1) * heads_per_split >= Hq / Hk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dkdv<64>(qh, k, v, dout, lse, delta, dk, dv, ws, B, Sq, Skv, Hq, Hk, D, splits,
                           heads_per_split, strides, causal, window, s);
  if (D <= 128)
    return launch_dkdv<128>(qh, k, v, dout, lse, delta, dk, dv, ws, B, Sq, Skv, Hq, Hk, D, splits,
                            heads_per_split, strides, causal, window, s);
  return launch_dkdv<256>(qh, k, v, dout, lse, delta, dk, dv, ws, B, Sq, Skv, Hq, Hk, D, splits,
                          heads_per_split, strides, causal, window, s);
}

// strides: (batch, seq, head) of dk and dv, 6 values.
extern "C" int repro_flash_attention_bwd_split_reduce(const float* ws, void* dk, void* dv,
                                                      int splits, int B, int Skv, int Hk, int D,
                                                      const long long* strides, void* stream) {
  if (splits < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (long long)B * Skv * Hk * D;
  if (n == 0) return 0;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long blocks = want < 132LL * 16 ? want : 132LL * 16;
  flash_bwd_split_reduce_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ws, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), splits, B, Skv, Hk, D,
      at(strides, 0), at(strides, 1));
  return static_cast<int>(cudaGetLastError());
}

// strides: (batch, seq, head) of k, v, dO and dq, 12 values.
extern "C" int repro_flash_attention_bwd_wgmma_dq(const void* qh, const void* k, const void* v,
                                                  const void* dout, const float* lse,
                                                  const float* delta, void* dq, int B, int Sq,
                                                  int Skv, int Hq, int Hk, int D,
                                                  const long long* strides, float scale,
                                                  int causal, int window, void* stream) {
  if (int err = check(Hq, Hk, D)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dq<64>(qh, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hk, D, strides, scale,
                         causal, window, s);
  if (D <= 128)
    return launch_dq<128>(qh, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hk, D, strides, scale,
                          causal, window, s);
  return launch_dq<256>(qh, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hk, D, strides, scale,
                        causal, window, s);
}
