// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of the forward in
// flash_attention.cu, causal / sliding-window / bidirectional / GQA, with the
// suffix offset Skv - Sq.
//
// Replaces the backward of the TPU kernel's custom VJP
// (src/repro/kernels/flash_attention/ops.py:43-46, _bwd: the vjp of
// attention_chunked at the suffix offset, _ref at :29-36); the Pallas kernel
// (kernel.py:89, pallas_call at :113) is a forward only.
//
// With q^ = q / sqrt(D) rounded to q's dtype (the forward's rounding:
// P normalises against the saved lse only if the scores are recomputed from
// the same q^), S = q^ k^T, P = exp(S - lse) under the forward's masks, lse
// the forward's log-sum-exp of each row (natural-log units, f32, (B, Hq, Sq):
// see flash_attention.cu), and delta_i = sum_d dO_i O_i:
//
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),  dK = dS^T q^,  dQ = dS K / sqrt(D)
//
// over the pairs the masks leave live (query position i + Skv - Sq; causal
// j <= position; window j > position - window).  A masked pair's forward
// score is -1e30, so its P is 0 here; keys past Skv do not exist.  dK and dV
// sum the Hq / Hk query heads of each KV head.
//
// What bounds it on the card: operations.  At qwen1.5-0.5b's training shape
// (B = 8, S = 128, H = 16, D = 64, causal) the four gradient products over
// the live pairs are 0.54 GFLOP against ~17 MB of q, k, v, o, dO, lse, dq, dk
// and dv; at its served shape (B = 4, S = 2048) 68.7 GFLOP against 34 MB.
// This first kernel issues every product with scalar FFMA in f32 (the card's
// 67 TFLOP/s, not the tensor cores' 989), and recomputes S and dP in both
// passes (14 D FLOP a visited pair against the bound's 8 D):
//   * flash_bwd_preprocess_kernel: delta (B, Hq, Sq) f32, one warp a row.
//   * flash_bwd_dkdv_kernel: one block owns (batch, KV head, KV tile).  It
//     keeps K and V in shared memory, loops over the query heads of its
//     group and over the q tiles that can see its keys (ops.q_tiles, the
//     mirror of the forward's block-skip), recomputes P and dS for each, and
//     accumulates dK and dV in f32 registers: GQA's heads are summed inside
//     the block, with no atomics and no repeated K/V.  Written once.
//   * flash_bwd_dq_kernel: one block owns (batch, q head, q tile) and walks
//     the KV tiles the forward walks (ops.kv_tiles), accumulating dQ in f32
//     registers.  Written once.
// No atomics anywhere: a backward is deterministic.  Tiles: 64 query rows;
// 64 keys at D <= 128, 32 at D = 256, where q^, dO, K and V widened to f32
// plus the P and dS tiles take 214,784 bytes of shared memory and the f32
// dK, dV accumulators 64 registers a thread.  dq, dk, dv are written in q's
// dtype in the model's (B, S, H, D) layout through strides, as the forward
// writes o; q, k, v, o and dO are read through strides too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTQ = 64;        // query rows of a tile

struct Strides {               // x[b, s, h, d] at x + b*sb + s*ss + h*sh + d
  long long sb, ss, sh;
};

template <int DM>
__host__ __device__ constexpr int bwd_tk() { return DM >= 256 ? 32 : 64; }  // keys of a KV tile

// dynamic shared memory: q^ and dO [kTQ][DM + 1], K and V [TK][DM + 1],
// P (dK/dV only) and dS [kTQ][TK + 1], lse and delta [kTQ]
template <int DM>
constexpr int dkdv_smem_bytes() {
  return (2 * kTQ * (DM + 1) + 2 * bwd_tk<DM>() * (DM + 1) + 2 * kTQ * (bwd_tk<DM>() + 1) +
          2 * kTQ) * static_cast<int>(sizeof(float));
}
template <int DM>
constexpr int dq_smem_bytes() {
  return dkdv_smem_bytes<DM>() - kTQ * (bwd_tk<DM>() + 1) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// ------------------------------------------------------------ preprocess

// delta[(b Hq + h) Sq + i] = sum_d dO[b, i, h, d] O[b, i, h, d]; one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_preprocess_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta, int B,
    int Sq, int Hq, int D, Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= (long long)B * Hq * Sq) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(row % Sq);
  const long long bh = row / Sq;
  const int h = (int)(bh % Hq), b = (int)(bh / Hq);
  const T* ob = o + b * os.sb + i * os.ss + h * os.sh;
  const T* gb = dout + b * dos.sb + i * dos.ss + h * dos.sh;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(load_f(ob + d), load_f(gb + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ------------------------------------------------------------ shared pieces

// q^ (scaled, rounded to T) and dO (widened) of rows [q0, q0 + kTQ) of head
// h, with their lse and delta; zero past Sq and D
template <typename T, int DM>
__device__ __forceinline__ void load_q_tile(float* qs, float* dos, float* lses, float* dls,
                                            const T* qb, const T* gb, const float* lseb,
                                            const float* dlb, int q0, int Sq, int D,
                                            long long q_ss, long long g_ss, float scale) {
  constexpr int LD = DM + 1;
  for (int e = threadIdx.x; e < kTQ * DM; e += kThreads) {
    const int r = e / DM, c = e % DM;
    const bool in = q0 + r < Sq && c < D;
    qs[r * LD + c] = in ? round_to(load_f(qb + (long long)(q0 + r) * q_ss + c) * scale, qb) : 0.f;
    dos[r * LD + c] = in ? load_f(gb + (long long)(q0 + r) * g_ss + c) : 0.f;
  }
  for (int r = threadIdx.x; r < kTQ; r += kThreads) {
    lses[r] = q0 + r < Sq ? lseb[q0 + r] : 0.f;
    dls[r] = q0 + r < Sq ? dlb[q0 + r] : 0.f;
  }
}

// K and V rows [k0, k0 + TK), widened; zero past Skv and D
template <typename T, int DM, int TK>
__device__ __forceinline__ void load_kv_tile(float* ks, float* vs, const T* kb, const T* vb,
                                             int k0, int Skv, int D, long long k_ss,
                                             long long v_ss) {
  constexpr int LD = DM + 1;
  for (int e = threadIdx.x; e < TK * DM; e += kThreads) {
    const int r = e / DM, c = e % DM;
    const bool in = k0 + r < Skv && c < D;
    ks[r * LD + c] = in ? load_f(kb + (long long)(k0 + r) * k_ss + c) : 0.f;
    vs[r * LD + c] = in ? load_f(vb + (long long)(k0 + r) * v_ss + c) : 0.f;
  }
}

// P and dS of the (q tile at q0, KV tile at k0) pair into ps (when not null)
// and dss: S = q^ K^T and dP = dO V^T in one pass over D.  Thread (ty, tx)
// owns rows ty + 16 i and keys tx + 16 j.
template <int DM, int TK>
__device__ __forceinline__ void probs_and_dscores(float* ps, float* dss, const float* qs,
                                                  const float* dos, const float* ks,
                                                  const float* vs, const float* lses,
                                                  const float* dls, int q0, int k0, int Sq,
                                                  int Skv, int causal, int window) {
  constexpr int LD = DM + 1, LP = TK + 1, NJ = TK / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][NJ], dp[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DM; ++d) {
    float a[4], g[4], kc[NJ], vc[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty + 16 * i) * LD + d];
      g[i] = dos[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      kc[j] = ks[(tx + 16 * j) * LD + d];
      vc[j] = vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(a[i], kc[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vc[j], dp[i][j]);
      }
  }
  const int q_offset = Skv - Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r + q_offset;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kpos = k0 + tx + 16 * j;
      bool live = q0 + r < Sq && kpos < Skv;
      if (causal) live = live && kpos <= qpos;
      if (window > 0) live = live && kpos > qpos - window;
      const float p = live ? expf(s[i][j] - lses[r]) : 0.f;
      if (ps != nullptr) ps[r * LP + tx + 16 * j] = p;
      dss[r * LP + tx + 16 * j] = p * (dp[i][j] - dls[r]);
    }
  }
}

// ------------------------------------------------------------ dK, dV

// Grid: (KV tiles, Hk, B); the first KV tiles are seen by the most q tiles
// under a causal mask, so they start first.  window <= 0: no window.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int Hq, int Hk, int D, Strides qs_,
    Strides ks_, Strides vs_, Strides gs_, Strides dks_, Strides dvs_, float scale, int causal,
    int window) {
  constexpr int TK = bwd_tk<DM>(), LD = DM + 1, LP = TK + 1, NJ = TK / 16, CJ = DM / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [kTQ][LD] q^
  float* dos = qs + kTQ * LD;     // [kTQ][LD] dO
  float* ks = dos + kTQ * LD;     // [TK][LD]
  float* vs = ks + TK * LD;       // [TK][LD]
  float* dss = vs + TK * LD;      // [kTQ][LP] dS
  float* lses = dss + kTQ * LP;   // [kTQ]
  float* dls = lses + kTQ;        // [kTQ]
  float* ps = dls + kTQ;          // [kTQ][LP] P

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hk;
  const int k0 = kt * TK;
  const long long q_offset = (long long)Skv - Sq;

  load_kv_tile<T, DM, TK>(ks, vs, k + b * ks_.sb + hk * ks_.sh, v + b * vs_.sb + hk * vs_.sh, k0,
                          Skv, D, ks_.ss, vs_.ss);

  // the q tiles that can see a key of this tile (ops.q_tiles): rows
  // [i_lo, i_hi], every one of which holds a live pair with the tile
  const long long k_hi = min(k0 + TK, Skv) - 1;
  long long i_lo = 0, i_hi = Sq - 1;
  if (causal) i_lo = max(i_lo, k0 - q_offset);
  if (window > 0) i_hi = min(i_hi, k_hi + window - 1 - q_offset);
  const int qt_begin = i_lo <= i_hi ? (int)(i_lo / kTQ) : 0;
  const int qt_end = i_lo <= i_hi ? (int)(i_hi / kTQ) + 1 : 0;

  float dk_acc[NJ][CJ], dv_acc[NJ][CJ];
#pragma unroll
  for (int a = 0; a < NJ; ++a)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qs_.sb + h * qs_.sh;
    const T* gb = dout + b * gs_.sb + h * gs_.sh;
    const float* lseb = lse + ((long long)b * Hq + h) * Sq;
    const float* dlb = delta + ((long long)b * Hq + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kTQ;
      __syncthreads();  // K, V stored; the last tile's q^, dO, P and dS no longer read
      load_q_tile<T, DM>(qs, dos, lses, dls, qb, gb, lseb, dlb, q0, Sq, D, qs_.ss, gs_.ss, scale);
      __syncthreads();
      probs_and_dscores<DM, TK>(ps, dss, qs, dos, ks, vs, lses, dls, q0, k0, Sq, Skv, causal,
                                window);
      __syncthreads();
      // dV += P^T dO, dK += dS^T q^: thread (ty, tx) owns keys ty + 16 a, columns tx + 16 c
#pragma unroll 2
      for (int r = 0; r < kTQ; ++r) {
        float pr[NJ], dr[NJ], gc[CJ], qc[CJ];
#pragma unroll
        for (int a = 0; a < NJ; ++a) {
          pr[a] = ps[r * LP + ty + 16 * a];
          dr[a] = dss[r * LP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          gc[c] = dos[r * LD + tx + 16 * c];
          qc[c] = qs[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < NJ; ++a)
#pragma unroll
          for (int c = 0; c < CJ; ++c) {
            dv_acc[a][c] = fmaf(pr[a], gc[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(dr[a], qc[c], dk_acc[a][c]);
          }
      }
    }
  }

  T* dkb = dk + b * dks_.sb + hk * dks_.sh;
  T* dvb = dv + b * dvs_.sb + hk * dvs_.sh;
#pragma unroll
  for (int a = 0; a < NJ; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row >= Skv) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        store_f(dkb + (long long)row * dks_.ss + col, dk_acc[a][c]);
        store_f(dvb + (long long)row * dvs_.ss + col, dv_acc[a][c]);
      }
    }
  }
}

// ------------------------------------------------------------ dQ

// Grid: (q tiles, Hq, B); the last q tiles see the most keys under a causal
// mask, so they start first.  window <= 0: no window.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Skv, int Hq, int Hk, int D, Strides qs_, Strides ks_,
    Strides vs_, Strides gs_, Strides dqs_, float scale, int causal, int window) {
  constexpr int TK = bwd_tk<DM>(), LD = DM + 1, LP = TK + 1, CJ = DM / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [kTQ][LD] q^
  float* dos = qs + kTQ * LD;     // [kTQ][LD] dO
  float* ks = dos + kTQ * LD;     // [TK][LD]
  float* vs = ks + TK * LD;       // [TK][LD]
  float* dss = vs + TK * LD;      // [kTQ][LP] dS
  float* lses = dss + kTQ * LP;   // [kTQ]
  float* dls = lses + kTQ;        // [kTQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * kTQ;
  const int q_offset = Skv - Sq;

  load_q_tile<T, DM>(qs, dos, lses, dls, q + b * qs_.sb + h * qs_.sh,
                     dout + b * gs_.sb + h * gs_.sh, lse + ((long long)b * Hq + h) * Sq,
                     delta + ((long long)b * Hq + h) * Sq, q0, Sq, D, qs_.ss, gs_.ss, scale);
  const T* kb = k + b * ks_.sb + hk * ks_.sh;
  const T* vb = v + b * vs_.sb + hk * vs_.sh;

  // the KV tiles the forward visits (ops.kv_tiles)
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + kTQ, Sq) - 1 + q_offset;
  const int n_kt = (Skv + TK - 1) / TK;
  int kt_begin = 0, kt_end = n_kt;
  if (causal) kt_end = q_hi < 0 ? 0 : min(n_kt, q_hi / TK + 1);
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / TK;

  float dq_acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dq_acc[i][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();  // q^ and dO stored; the last tile's K, V and dS no longer read
    load_kv_tile<T, DM, TK>(ks, vs, kb, vb, k0, Skv, D, ks_.ss, vs_.ss);
    __syncthreads();
    probs_and_dscores<DM, TK>(nullptr, dss, qs, dos, ks, vs, lses, dls, q0, k0, Sq, Skv, causal,
                              window);
    __syncthreads();
    // dQ += dS K: thread (ty, tx) owns rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float dr[4], kc[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dss[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kc[c] = ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) dq_acc[i][c] = fmaf(dr[i], kc[c], dq_acc[i][c]);
    }
  }

  T* dqb = dq + b * dqs_.sb + h * dqs_.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store_f(dqb + (long long)row * dqs_.ss + col, dq_acc[i][c] * scale);
    }
  }
}

// ------------------------------------------------------------ launches

Strides at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

template <typename T, int DM>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hk,
                int D, const long long* st, float scale, int causal, int window, cudaStream_t s) {
  constexpr int bytes = dkdv_smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((Skv + bwd_tk<DM>() - 1) / bwd_tk<DM>()), (unsigned)Hk, (unsigned)B);
  flash_bwd_dkdv_kernel<T, DM><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv,
      Hq, Hk, D, at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5), scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DM>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int Sq, int Skv, int Hq, int Hk, int D,
              const long long* st, float scale, int causal, int window, cudaStream_t s) {
  constexpr int bytes = dq_smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((Sq + kTQ - 1) / kTQ), (unsigned)Hq, (unsigned)B);
  flash_bwd_dq_kernel<T, DM><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Sq, Skv, Hq, Hk, D, at(st, 0),
      at(st, 1), at(st, 2), at(st, 3), at(st, 4), scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = dK/dV, 1 = dQ
template <typename T>
int dispatch(int which, const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* d0, void* d1, int B, int Sq, int Skv,
             int Hq, int Hk, int D, const long long* st, float scale, int causal, int window,
             cudaStream_t s) {
#define REPRO_BWD_D(DM)                                                                          \
  if (D <= DM)                                                                                   \
    return which == 0 ? launch_dkdv<T, DM>(q, k, v, dout, lse, delta, d0, d1, B, Sq, Skv, Hq, Hk, \
                                           D, st, scale, causal, window, s)                      \
                      : launch_dq<T, DM>(q, k, v, dout, lse, delta, d0, B, Sq, Skv, Hq, Hk, D, st, \
                                         scale, causal, window, s);
  REPRO_BWD_D(32)
  REPRO_BWD_D(64)
  REPRO_BWD_D(128)
  REPRO_BWD_D(256)
#undef REPRO_BWD_D
  return static_cast<int>(cudaErrorInvalidValue);
}

int check(int dtype, int Hq, int Hk, int D) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (Hk <= 0 || Hq % Hk != 0 || D <= 0 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Query rows (which = 0) or keys (which = 1) of a backward tile for head size D.
extern "C" int repro_flash_attention_bwd_tile(int D, int which) {
  if (which == 0) return kTQ;
  return D <= 128 ? bwd_tk<128>() : bwd_tk<256>();
}

// Dynamic shared memory of a dK/dV (which = 0) or dQ (which = 1) block for
// head size D (0: D not supported).
extern "C" int repro_flash_attention_bwd_smem_bytes(int D, int which) {
  if (D <= 0 || D > 256) return 0;
  if (D <= 32) return which == 0 ? dkdv_smem_bytes<32>() : dq_smem_bytes<32>();
  if (D <= 64) return which == 0 ? dkdv_smem_bytes<64>() : dq_smem_bytes<64>();
  if (D <= 128) return which == 0 ? dkdv_smem_bytes<128>() : dq_smem_bytes<128>();
  return which == 0 ? dkdv_smem_bytes<256>() : dq_smem_bytes<256>();
}

// dtype: 0 = float32, 1 = bfloat16.  strides: (batch, seq, head) of o and
// dO in elements; the head dimension is unit-stride.  delta: (B, Hq, Sq)
// f32, contiguous.  Each entry launches on `stream` and returns the CUDA
// error of its launch (0 on success).
extern "C" int repro_flash_attention_bwd_preprocess(int dtype, const void* o, const void* dout,
                                                    float* delta, int B, int Sq, int Hq, int D,
                                                    const long long* strides, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * Hq * Sq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Strides os{strides[0], strides[1], strides[2]}, gs{strides[3], strides[4], strides[5]};
  if (dtype == 0)
    flash_bwd_preprocess_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta, B, Sq, Hq, D, os, gs);
  else
    flash_bwd_preprocess_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta, B,
        Sq, Hq, D, os, gs);
  return static_cast<int>(cudaGetLastError());
}

// strides: (batch, seq, head) of q, k, v, dO, dk and dv, 18 values.  lse and
// delta: (B, Hq, Sq) f32, contiguous.  window <= 0: no window.
extern "C" int repro_flash_attention_bwd_dkdv(int dtype, const void* q, const void* k,
                                              const void* v, const void* dout, const float* lse,
                                              const float* delta, void* dk, void* dv, int B,
                                              int Sq, int Skv, int Hq, int Hk, int D,
                                              const long long* strides, float scale, int causal,
                                              int window, void* stream) {
  if (int err = check(dtype, Hq, Hk, D)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(0, q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hk, D, strides,
                           scale, causal, window, s);
  return dispatch<__nv_bfloat16>(0, q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hk, D,
                                 strides, scale, causal, window, s);
}

// strides: (batch, seq, head) of q, k, v, dO and dq, 15 values.
extern "C" int repro_flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                                            const void* v, const void* dout, const float* lse,
                                            const float* delta, void* dq, int B, int Sq, int Skv,
                                            int Hq, int Hk, int D, const long long* strides,
                                            float scale, int causal, int window, void* stream) {
  if (int err = check(dtype, Hq, Hk, D)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(1, q, k, v, dout, lse, delta, dq, nullptr, B, Sq, Skv, Hq, Hk, D,
                           strides, scale, causal, window, s);
  return dispatch<__nv_bfloat16>(1, q, k, v, dout, lse, delta, dq, nullptr, B, Sq, Skv, Hq, Hk, D,
                                 strides, scale, causal, window, s);
}
