// Mamba-2 SSD chunked scan, the backward, for Hopper (sm_90a), path
// bwd_ffma: dx, ddt, da, dB and dC of the forward in ssd_scan.cu from the
// cotangents of y and of the final state, for f32 and for the bf16 that
// bwd_wgmma (ssd_scan_bwd_wgmma.cu, every product on the tensor cores) does
// not take: rows that 16-byte copies cannot read, N <= 32.
//
// Replaces the backward of the TPU kernel's custom VJP
// (src/repro/kernels/ssd_scan/ops.py:44-49, _bwd: the vjp of
// ref.ssd_chunked at the wrapper's chunk); the Pallas kernel (kernel.py:63,
// pallas_call at :82) is a forward only.
//
// For each (batch b, head h), group g = h / (H/G), chunks of kQ rows walked
// last first, with cs the inclusive cumsum of a_h dt within the chunk,
// seg[t][s] = exp(cs_t - cs_s) for s <= t, G = C B^T, D = dY x^T,
// w_s = exp(cs_Q - cs_s), S_in the f32 state entering the chunk and dS the
// adjoint of the state leaving it (the final state's cotangent, or 0, for
// the last chunk):
//
//   dx_s  = dt_s (sum_t seg G [t][s] dY_t + w_s dS B_s)
//   dB_s  = dt_s (sum_t seg D [t][s] C_t + w_s dS^T x_s)           per head
//   dC_t  = exp(cs_t) S_in^T dY_t + sum_s seg D [t][s] dt_s B_s     per head
//   dS   <- exp(cs_Q) dS + sum_t exp(cs_t) dY_t C_t^T
//   d(a dt)_r = exp(cs_Q) <dS, S_in> + sum_{s<r} dt_s x_s . (w_s dS B_s)
//             + sum_{t>=r} exp(cs_t) dY_t . (S_in C_t)
//             + sum_{t>=r>s} seg G [t][s] dt_s D[t][s]
//   ddt_r = x_r . (dx_r / dt_r) + a_h d(a dt)_r,   da_h = sum_r dt_r d(a dt)_r
//
// (ref.ssd_bwd_chunked is the same in plain PyTorch.)  d(a dt)_r sums what
// the decay of row r multiplies, term by term: no term is a difference of
// two large sums, so the f32 gradient holds 1e-4 of an f64 one where autograd
// through ssd_chunked at the model's 256-row chunk, whose exp(cs) factors
// carry the rounding of |cs| in the hundreds, does not.  As in the forward,
// seg's exponent is summed over its own rows and never exponentiated for
// s > t.
//
// What bounds it on the card: bytes, by a small margin.  At mamba2-1.3b's
// training shape (B = 8, L = 128, H = 64, P = 64, G = 1, N = 128, bf16 x, B,
// C, dY) the backward reads x, dt, B, C and dY and writes dx, ddt, dB and dC:
// ~26.7 MB, 0.008 ms at 3.35 TB/s, against ~7 GFLOP of recurrence (~0.007
// ms on the bf16 tensor cores).  This first kernel issues every product with
// scalar FFMA in f32 and keeps f32 intermediates in device memory between
// its three launches (no atomics anywhere: a backward is deterministic):
//   * ssd_bwd_states_kernel: one block per (b, h) walks L forward and
//     writes the f32 state entering each chunk (B, H, chunks, P, N) to
//     scratch; the state stays in registers.  The forward kernel and its
//     wgmma path are untouched.
//   * ssd_bwd_chunk_kernel: one block per (b, h) walks the chunks last
//     first with dS in shared memory (x, dY, B, C, S_in, dS and the three
//     kQ x kQ score tiles: 129,312 bytes at P = 64, N = 128, one block an
//     SM).  It writes dx in x's dtype and ddt (f32), each head's f32 dB and
//     dC (B, L, H, N), and a per-(b, h) partial of da.
//   * ssd_bwd_group_sum_kernel: dB and dC summed over each group's H/G
//     heads in head order and written in B's and C's dtype; da summed over
//     b.  At G = 1 all 64 heads of mamba2 share one B and C: a block that
//     walked them all would serialize the scan 64-fold.
// x, dt, B, C, dY and dx are read and written in the model's (B, L, H, P)
// layout through strides.  A ragged tail is masked as the forward masks it
// (dt = 0 and zero x, B, C, dY past L): padded rows contribute nothing and
// no gradient is written past L.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps; 16 x 16 for the state tiles
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 32;                   // rows of a chunk: one warp's lanes
constexpr int kRows = kQ / kWarps;       // rows of a chunk each warp owns

struct Strides {   // t[b, l, h] at t + b*sb + l*sl + h*sh; the last dimension unit-stride
  long long sb, sl, sh;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// the sum over the warp, the same in every lane (a fixed butterfly)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warp 0, lane t: dt of row t0 + t (0 past L), a dt, exp of a dt summed over
// rows 0..t (ecs) and over rows t+1..kQ-1 (ew), as the forward takes them.
__device__ __forceinline__ void chunk_decays(const float* dtb, long long dt_sl, int t0, int L,
                                             float ah, int lane, float* dt_s, float* adt_s,
                                             float* ecs_s, float* ew_s) {
  const float d = t0 + lane < L ? dtb[(long long)(t0 + lane) * dt_sl] : 0.f;
  const float ad = ah * d;
  float pre = ad, suf = ad;
#pragma unroll
  for (int off = 1; off < kQ; off *= 2) {
    const float u = __shfl_up_sync(0xffffffffu, pre, off);
    const float w = __shfl_down_sync(0xffffffffu, suf, off);
    if (lane >= off) pre += u;
    if (lane + off < kQ) suf += w;
  }
  const float after = __shfl_down_sync(0xffffffffu, suf, 1);   // rows t+1..kQ-1
  dt_s[lane] = d;
  adt_s[lane] = ad;
  ecs_s[lane] = expf(pre);
  ew_s[lane] = lane + 1 < kQ ? expf(after) : 1.f;
}

// ------------------------------------------------------------ (a) states

template <int PM, int NM>
struct StatesLayout {
  static constexpr int LN = NM + 1, LP = PM + 1;
  static constexpr int floats = kQ * LN + kQ * LP + 4 * kQ;
  static constexpr int bytes = floats * static_cast<int>(sizeof(float));
};

// Grid (H, B).  states: (B, H, chunks, P, N) f32, chunk c's entry the state
// entering it (chunk 0's is 0).
template <typename T, int PM, int NM>
__global__ void __launch_bounds__(kThreads) ssd_bwd_states_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, float* __restrict__ states, int L, int H, int P, int G, int N,
    Strides xs, Strides dts, Strides bs) {
  using Lay = StatesLayout<PM, NM>;
  constexpr int LN = Lay::LN, LP = Lay::LP, IP = PM / 16, JN = NM / 16;
  extern __shared__ float smem[];
  float* b_s = smem;               // [kQ][LN]  B of the chunk
  float* x_s = b_s + kQ * LN;      // [kQ][LP]  x dt exp(cs_Q - cs_t)
  float* dt_s = x_s + kQ * LP;     // [kQ]
  float* adt_s = dt_s + kQ;        // [kQ]
  float* ecs_s = adt_s + kQ;       // [kQ]
  float* ew_s = ecs_s + kQ;        // [kQ]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float ah = a[h];
  const T* xb = x + b * xs.sb + h * xs.sh;
  const float* dtb = dt + b * dts.sb + h * dts.sh;
  const T* bb = bm + b * bs.sb + g * bs.sh;
  const int nc = (L + kQ - 1) / kQ;
  float* out = states + ((long long)b * H + h) * nc * P * N;

  float st[IP][JN];   // the state: rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < IP; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) st[i][j] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kQ;
    float* o = out + (long long)c * P * N;
#pragma unroll
    for (int i = 0; i < IP; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int p = ty + 16 * i, n = tx + 16 * j;
        if (p < P && n < N) o[(long long)p * N + n] = st[i][j];
      }
    __syncthreads();  // the last chunk's reads of every buffer are done
    if (tid < kQ) chunk_decays(dtb, dts.sl, t0, L, ah, tid, dt_s, adt_s, ecs_s, ew_s);
    for (int e = tid; e < kQ * NM; e += kThreads) {
      const int r = e / NM, col = e % NM;
      b_s[r * LN + col] = t0 + r < L && col < N ? load_f(bb + (long long)(t0 + r) * bs.sl + col) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kQ * PM; e += kThreads) {
      const int r = e / PM, col = e % PM;
      x_s[r * LP + col] = t0 + r < L && col < P
                              ? load_f(xb + (long long)(t0 + r) * xs.sl + col) * dt_s[r] * ew_s[r]
                              : 0.f;
    }
    __syncthreads();
    float acc[IP][JN];
#pragma unroll
    for (int i = 0; i < IP; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int t = 0; t < kQ; ++t) {
      float xv[IP], bv[JN];
#pragma unroll
      for (int i = 0; i < IP; ++i) xv[i] = x_s[t * LP + ty + 16 * i];
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
      for (int j = 0; j < JN; ++j) st[i][j] = decay * st[i][j] + acc[i][j];
  }
}

// ------------------------------------------------------------ (b) dchunk

template <int PM, int NM>
struct ChunkLayout {
  static constexpr int LN = NM + 1, LP = PM + 1, LQ = kQ + 1;
  static constexpr int floats =
      2 * kQ * LP + 2 * kQ * LN + 2 * PM * LN + 3 * kQ * LQ + 7 * kQ + kWarps;
  static constexpr int bytes = floats * static_cast<int>(sizeof(float));
};

// Grid (H, B).  ddt: (B, L, H) f32, dbp and dcp: (B, L, H, N) f32, da_part:
// (B, H) f32, all contiguous; dstate: (B, H, P, N) f32 contiguous or null.
template <typename T, int PM, int NM>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm, const T* __restrict__ dy,
    const float* __restrict__ states, const float* __restrict__ dstate, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dbp, float* __restrict__ dcp,
    float* __restrict__ da_part, int L, int H, int P, int G, int N, Strides xs, Strides dts,
    Strides bs, Strides cs, Strides dys, Strides dxs) {
  using Lay = ChunkLayout<PM, NM>;
  constexpr int LN = Lay::LN, LP = Lay::LP, LQ = Lay::LQ;
  constexpr int IP = PM / 16, JN = NM / 16;
  constexpr int MP = (PM + 31) / 32, MN = NM / 32;   // a lane's head and state columns
  extern __shared__ float smem[];
  float* x_s = smem;               // [kQ][LP]  x
  float* dy_s = x_s + kQ * LP;     // [kQ][LP]  dY
  float* b_s = dy_s + kQ * LP;     // [kQ][LN]  B
  float* c_s = b_s + kQ * LN;      // [kQ][LN]  C
  float* sin_s = c_s + kQ * LN;    // [PM][LN]  the state entering the chunk
  float* ds_s = sin_s + PM * LN;   // [PM][LN]  dS, the adjoint of the state leaving it
  float* gs_s = ds_s + PM * LN;    // [kQ][LQ]  seg G   (0 above the diagonal)
  float* hs_s = gs_s + kQ * LQ;    // [kQ][LQ]  seg D
  float* w_s = hs_s + kQ * LQ;     // [kQ][LQ]  seg G dt_s D
  float* dt_s = w_s + kQ * LQ;     // [kQ]
  float* adt_s = dt_s + kQ;        // [kQ]
  float* ecs_s = adt_s + kQ;       // [kQ]      exp(cs_t)
  float* ew_s = ecs_s + kQ;        // [kQ]      exp(cs_Q - cs_t)
  float* xdxr_s = ew_s + kQ;       // [kQ]      x_r . dx_r / dt_r
  float* arow_s = xdxr_s + kQ;     // [kQ]      dt_s x_s . (w_s dS B_s)
  float* term_s = arow_s + kQ;     // [kQ]      exp(cs_t) dY_t . (S_in C_t)
  float* red_s = term_s + kQ;      // [kWarps]  <dS, S_in> by warp

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float ah = a[h];
  const T* xb = x + b * xs.sb + h * xs.sh;
  const float* dtb = dt + b * dts.sb + h * dts.sh;
  const T* bb = bm + b * bs.sb + g * bs.sh;
  const T* cb = cm + b * cs.sb + g * cs.sh;
  const T* dyb = dy + b * dys.sb + h * dys.sh;
  T* dxb = dx + b * dxs.sb + h * dxs.sh;
  float* ddtb = ddt + (long long)b * L * H + h;                    // row stride H
  float* dbpb = dbp + ((long long)b * L * H + h) * N;              // row stride H N
  float* dcpb = dcp + ((long long)b * L * H + h) * N;
  const long long prow = (long long)H * N;
  const int nc = (L + kQ - 1) / kQ;
  const float* sb = states + ((long long)b * H + h) * nc * P * N;
  const float* dsb = dstate == nullptr ? nullptr : dstate + ((long long)b * H + h) * P * N;

  for (int e = tid; e < PM * NM; e += kThreads) {
    const int p = e / NM, n = e % NM;
    ds_s[p * LN + n] = dsb != nullptr && p < P && n < N ? dsb[(long long)p * N + n] : 0.f;
  }
  float da_acc = 0.f;   // lane 0 of warp 0

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kQ;
    __syncthreads();  // the last chunk's reads of every buffer are done; dS written
    if (tid < kQ) chunk_decays(dtb, dts.sl, t0, L, ah, tid, dt_s, adt_s, ecs_s, ew_s);
    for (int e = tid; e < kQ * NM; e += kThreads) {
      const int r = e / NM, col = e % NM;
      const bool in = t0 + r < L && col < N;
      c_s[r * LN + col] = in ? load_f(cb + (long long)(t0 + r) * cs.sl + col) : 0.f;
      b_s[r * LN + col] = in ? load_f(bb + (long long)(t0 + r) * bs.sl + col) : 0.f;
    }
    for (int e = tid; e < kQ * PM; e += kThreads) {
      const int r = e / PM, col = e % PM;
      const bool in = t0 + r < L && col < P;
      x_s[r * LP + col] = in ? load_f(xb + (long long)(t0 + r) * xs.sl + col) : 0.f;
      dy_s[r * LP + col] = in ? load_f(dyb + (long long)(t0 + r) * dys.sl + col) : 0.f;
    }
    const float* si = sb + (long long)c * P * N;
    for (int e = tid; e < PM * NM; e += kThreads) {
      const int p = e / NM, n = e % NM;
      sin_s[p * LN + n] = p < P && n < N ? si[(long long)p * N + n] : 0.f;
    }
    __syncthreads();

    {  // (1) rows t = ty + 16 i, columns s = tx + 16 j: seg G, seg D, seg G dt_s D
      float gv[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
      for (int n = 0; n < NM; ++n) {
        const float c0 = c_s[ty * LN + n], c1 = c_s[(ty + 16) * LN + n];
        const float b0 = b_s[tx * LN + n], b1 = b_s[(tx + 16) * LN + n];
        gv[0][0] = fmaf(c0, b0, gv[0][0]);
        gv[0][1] = fmaf(c0, b1, gv[0][1]);
        gv[1][0] = fmaf(c1, b0, gv[1][0]);
        gv[1][1] = fmaf(c1, b1, gv[1][1]);
      }
#pragma unroll 8
      for (int p = 0; p < PM; ++p) {
        const float y0 = dy_s[ty * LP + p], y1 = dy_s[(ty + 16) * LP + p];
        const float x0 = x_s[tx * LP + p], x1 = x_s[(tx + 16) * LP + p];
        dv[0][0] = fmaf(y0, x0, dv[0][0]);
        dv[0][1] = fmaf(y0, x1, dv[0][1]);
        dv[1][0] = fmaf(y1, x0, dv[1][0]);
        dv[1][1] = fmaf(y1, x1, dv[1][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          float e = 0.f;  // a dt summed over rows s+1..t
          for (int r = s + 1; r <= t; ++r) e += adt_s[r];
          const float sg = s <= t ? expf(e) : 0.f;
          const float gsv = sg * gv[i][j];
          gs_s[t * LQ + s] = gsv;
          hs_s[t * LQ + s] = sg * dv[i][j];
          w_s[t * LQ + s] = gsv * dt_s[s] * dv[i][j];
        }
    }
    __syncthreads();

    {  // (2) dx: warp w owns rows s = w + kWarps k, lane the head columns lane + 32 m
      float intra[kRows][MP], stp[kRows][MP];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int m = 0; m < MP; ++m) intra[k][m] = stp[k][m] = 0.f;
#pragma unroll 4
      for (int t = 0; t < kQ; ++t) {   // sum_t seg G [t][s] dY_t
        float yv[MP];
#pragma unroll
        for (int m = 0; m < MP; ++m) {
          const int p = lane + 32 * m;
          yv[m] = p < PM ? dy_s[t * LP + p] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float gk = gs_s[t * LQ + warp + kWarps * k];
#pragma unroll
          for (int m = 0; m < MP; ++m) intra[k][m] = fmaf(gk, yv[m], intra[k][m]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < NM; ++n) {   // (dS B_s)[p]
        float dv[MP];
#pragma unroll
        for (int m = 0; m < MP; ++m) {
          const int p = lane + 32 * m;
          dv[m] = p < PM ? ds_s[p * LN + n] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float bk = b_s[(warp + kWarps * k) * LN + n];
#pragma unroll
          for (int m = 0; m < MP; ++m) stp[k][m] = fmaf(dv[m], bk, stp[k][m]);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int s = warp + kWarps * k;
        const float d = dt_s[s], w = ew_s[s];
        float xr = 0.f, xst = 0.f;
#pragma unroll
        for (int m = 0; m < MP; ++m) {
          const int p = lane + 32 * m;
          if (p < PM) {
            const float dxsv = w * stp[k][m];
            const float dxr = intra[k][m] + dxsv;
            const float xv = x_s[s * LP + p];
            xr = fmaf(xv, dxr, xr);
            xst = fmaf(xv, dxsv, xst);
            if (t0 + s < L && p < P) store_f(dxb + (long long)(t0 + s) * dxs.sl + p, d * dxr);
          }
        }
        xr = warp_sum(xr);
        xst = warp_sum(xst);
        if (lane == 0) {
          xdxr_s[s] = xr;
          arow_s[s] = d * xst;
        }
      }
    }

    {  // (3) dB and dC of this head: warp w owns rows r = w + kWarps k, lane the
       // state columns lane + 32 m
      float bi[kRows][MN], bst[kRows][MN], ci[kRows][MN], cst[kRows][MN];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int m = 0; m < MN; ++m) bi[k][m] = bst[k][m] = ci[k][m] = cst[k][m] = 0.f;
#pragma unroll 2
      for (int t = 0; t < kQ; ++t) {
        float cv[MN], bv[MN];
        const float d = dt_s[t];
#pragma unroll
        for (int m = 0; m < MN; ++m) {
          cv[m] = c_s[t * LN + lane + 32 * m];
          bv[m] = b_s[t * LN + lane + 32 * m] * d;
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int r = warp + kWarps * k;
          const float hc = hs_s[t * LQ + r];   // seg D [t][r]: 0 for t < r
          const float hb = hs_s[r * LQ + t];   // seg D [r][t]: 0 for t > r
#pragma unroll
          for (int m = 0; m < MN; ++m) {
            bi[k][m] = fmaf(hc, cv[m], bi[k][m]);
            ci[k][m] = fmaf(hb, bv[m], ci[k][m]);
          }
        }
      }
#pragma unroll 2
      for (int p = 0; p < PM; ++p) {   // dS^T x_r and S_in^T dY_r
        float dsv[MN], siv[MN];
#pragma unroll
        for (int m = 0; m < MN; ++m) {
          dsv[m] = ds_s[p * LN + lane + 32 * m];
          siv[m] = sin_s[p * LN + lane + 32 * m];
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int r = warp + kWarps * k;
          const float xv = x_s[r * LP + p], yv = dy_s[r * LP + p];
#pragma unroll
          for (int m = 0; m < MN; ++m) {
            bst[k][m] = fmaf(dsv[m], xv, bst[k][m]);
            cst[k][m] = fmaf(siv[m], yv, cst[k][m]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = warp + kWarps * k;
        const float d = dt_s[r], w = ew_s[r], ec = ecs_s[r];
        const bool row_in = t0 + r < L;
        float t1 = 0.f;
#pragma unroll
        for (int m = 0; m < MN; ++m) {
          const int n = lane + 32 * m;
          const float dci = ec * cst[k][m];      // exp(cs_r) S_in^T dY_r
          t1 = fmaf(c_s[r * LN + n], dci, t1);
          if (row_in && n < N) {
            dbpb[(long long)(t0 + r) * prow + n] = d * (bi[k][m] + w * bst[k][m]);
            dcpb[(long long)(t0 + r) * prow + n] = dci + ci[k][m];
          }
        }
        t1 = warp_sum(t1);
        if (lane == 0) term_s[r] = t1;
      }
    }
    __syncthreads();  // every read of dS for this chunk is done

    {  // (4) dS <- exp(cs_Q) dS + sum_t exp(cs_t) dY_t C_t^T: rows ty + 16 i,
       // columns tx + 16 j; and this thread's share of <dS, S_in>
      float acc[IP][JN];
#pragma unroll
      for (int i = 0; i < IP; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int t = 0; t < kQ; ++t) {
        const float e = ecs_s[t];
        float yv[IP], cv[JN];
#pragma unroll
        for (int i = 0; i < IP; ++i) yv[i] = dy_s[t * LP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < JN; ++j) cv[j] = c_s[t * LN + tx + 16 * j] * e;
#pragma unroll
        for (int i = 0; i < IP; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(yv[i], cv[j], acc[i][j]);
      }
      const float decay = ecs_s[kQ - 1];
      float e0 = 0.f;
#pragma unroll
      for (int i = 0; i < IP; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          const int off = (ty + 16 * i) * LN + tx + 16 * j;
          const float old = ds_s[off];
          e0 = fmaf(old, sin_s[off], e0);
          ds_s[off] = fmaf(decay, old, acc[i][j]);
        }
      e0 = warp_sum(e0);
      if (lane == 0) red_s[warp] = e0;
    }
    __syncthreads();

    if (warp == 0) {  // (5) d(a dt) of row r = lane, ddt, and da's share
      const int r = lane;
      float crossed = 0.f;   // pairs t >= r > s: the segment from s to t holds row r's decay
      for (int t = r; t < kQ; ++t)
        for (int s = 0; s < r; ++s) crossed += w_s[t * LQ + s];
      float pre = arow_s[r], suf = term_s[r];
#pragma unroll
      for (int off = 1; off < kQ; off *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, pre, off);
        const float v = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane >= off) pre += u;
        if (lane + off < kQ) suf += v;
      }
      float before = __shfl_up_sync(0xffffffffu, pre, 1);   // rows s < r
      if (lane == 0) before = 0.f;
      float e0 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) e0 += red_s[w];
      const float dadt = ecs_s[kQ - 1] * e0 + before + suf + crossed;
      if (t0 + r < L) ddtb[(long long)(t0 + r) * H] = fmaf(ah, dadt, xdxr_s[r]);
      const float da_c = warp_sum(dt_s[r] * dadt);
      if (lane == 0) da_acc += da_c;
    }
  }
  if (tid == 0) da_part[(long long)b * H + h] = da_acc;
}

// ------------------------------------------------------------ (c) group sum

// dB and dC (B, L, G, N) in T, contiguous: each the sum of its group's H/G
// heads of dbp and dcp in head order; da (H) f32 the sum over b of da_part.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_group_sum_kernel(
    const float* __restrict__ dbp, const float* __restrict__ dcp,
    const float* __restrict__ da_part, T* __restrict__ db, T* __restrict__ dc,
    float* __restrict__ da, int B, int L, int H, int G, int N) {
  const int rep = H / G;
  const long long total = (long long)B * L * G * N;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int n = static_cast<int>(e % N);
    const long long rest = e / N;
    const int g = static_cast<int>(rest % G);
    const long long bl = rest / G;   // b L + l
    const long long base = (bl * H + (long long)g * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < rep; ++k) {
      sb += dbp[base + (long long)k * N];
      sc += dcp[base + (long long)k * N];
    }
    store_f(db + e, sb);
    store_f(dc + e, sc);
  }
  if (blockIdx.x == 0)
    for (int hh = threadIdx.x; hh < H; hh += blockDim.x) {
      float s = 0.f;
      for (int bi = 0; bi < B; ++bi) s += da_part[(long long)bi * H + hh];
      da[hh] = s;
    }
}

// ------------------------------------------------------------ launches

template <typename T, int PM, int NM>
int launch_states(const void* x, const float* dt, const float* a, const void* bm, float* states,
                  int B, int L, int H, int P, int G, int N, const long long* st,
                  cudaStream_t stream) {
  constexpr int bytes = StatesLayout<PM, NM>::bytes;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_kernel<T, PM, NM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_states_kernel<T, PM, NM><<<dim3((unsigned)H, (unsigned)B), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), states, L, H, P, G, N,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]});
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PM, int NM>
int launch_chunk(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
                 const void* dy, const float* states, const float* dstate, void* dx, float* ddt,
                 float* dbp, float* dcp, float* da_part, int B, int L, int H, int P, int G, int N,
                 const long long* st, cudaStream_t stream) {
  constexpr int bytes = ChunkLayout<PM, NM>::bytes;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, PM, NM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<T, PM, NM><<<dim3((unsigned)H, (unsigned)B), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(dy), states, dstate, static_cast<T*>(dx), ddt, dbp, dcp, da_part, L,
      H, P, G, N, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]});
  return static_cast<int>(cudaGetLastError());
}

// the head-size and state-size buckets, as the forward's ffma path
template <typename T>
int dispatch_states(const void* x, const float* dt, const float* a, const void* bm,
                    float* states, int B, int L, int H, int P, int G, int N, const long long* st,
                    cudaStream_t s) {
  auto* fn = P <= 16 && N <= 32    ? &launch_states<T, 16, 32>
             : P <= 16 && N <= 128 ? &launch_states<T, 16, 128>
             : P <= 64 && N <= 32  ? &launch_states<T, 64, 32>
             : P <= 64 && N <= 128 ? &launch_states<T, 64, 128>
                                   : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(x, dt, a, bm, states, B, L, H, P, G, N, st, s);
}

template <typename T>
int dispatch_chunk(const void* x, const float* dt, const float* a, const void* bm,
                   const void* cm, const void* dy, const float* states, const float* dstate,
                   void* dx, float* ddt, float* dbp, float* dcp, float* da_part, int B, int L,
                   int H, int P, int G, int N, const long long* st, cudaStream_t s) {
  auto* fn = P <= 16 && N <= 32    ? &launch_chunk<T, 16, 32>
             : P <= 16 && N <= 128 ? &launch_chunk<T, 16, 128>
             : P <= 64 && N <= 32  ? &launch_chunk<T, 64, 32>
             : P <= 64 && N <= 128 ? &launch_chunk<T, 64, 128>
                                   : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(x, dt, a, bm, cm, dy, states, dstate, dx, ddt, dbp, dcp, da_part, B, L, H, P, G, N,
            st, s);
}

int check(int dtype, int H, int G, int P, int N) {
  if ((dtype != 0 && dtype != 1) || G <= 0 || H % G != 0 || P <= 0 || N <= 0 || P > 64 ||
      N > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Rows of the backward's chunk: the states scratch holds ceil(L / rows)
// states a (b, h).
extern "C" int repro_ssd_scan_bwd_chunk_rows() { return kQ; }

// Dynamic shared memory of a states (which = 0) or dchunk (which = 1) block
// for head size P and state size N (0: not supported).
extern "C" int repro_ssd_scan_bwd_smem_bytes(int which, int P, int N) {
  if (P <= 0 || N <= 0) return 0;
#define BYTES(PM, NM) (which == 0 ? StatesLayout<PM, NM>::bytes : ChunkLayout<PM, NM>::bytes)
  if (P <= 16 && N <= 32) return BYTES(16, 32);
  if (P <= 16 && N <= 128) return BYTES(16, 128);
  if (P <= 64 && N <= 32) return BYTES(64, 32);
  if (P <= 64 && N <= 128) return BYTES(64, 128);
#undef BYTES
  return 0;
}

// dtype of x, B, C, dY and dx: 0 = float32, 1 = bfloat16; dt and a are
// float32.  strides: (batch, length, head-or-group) in elements of x, dt
// and B (9 values).  states: (B, H, ceil(L / rows), P, N) f32, contiguous.
// Each entry launches on `stream` and returns the CUDA error of its launch
// (0 on success).
extern "C" int repro_ssd_scan_bwd_states(int dtype, const void* x, const void* dt,
                                         const void* a, const void* bm, void* states, int B,
                                         int L, int H, int P, int G, int N,
                                         const long long* strides, void* stream) {
  if (int err = check(dtype, H, G, P, N)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* stf = static_cast<float*>(states);
  if (dtype == 0) return dispatch_states<float>(x, dtf, af, bm, stf, B, L, H, P, G, N, strides, s);
  return dispatch_states<__nv_bfloat16>(x, dtf, af, bm, stf, B, L, H, P, G, N, strides, s);
}

// strides: (batch, length, head-or-group) of x, dt, B, C, dY and dx (18
// values).  dstate: the final state's cotangent (B, H, P, N) f32
// contiguous, or null for 0.  ddt (B, L, H), dbp and dcp (B, L, H, N),
// da_part (B, H): f32, contiguous.
extern "C" int repro_ssd_scan_bwd_dchunk(int dtype, const void* x, const void* dt,
                                         const void* a, const void* bm, const void* cm,
                                         const void* dy, const void* states,
                                         const void* dstate, void* dx, void* ddt, void* dbp,
                                         void* dcp, void* da_part, int B, int L, int H, int P,
                                         int G, int N, const long long* strides, void* stream) {
  if (int err = check(dtype, H, G, P, N)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* stf = static_cast<const float*>(states);
  const float* dsf = static_cast<const float*>(dstate);
  float* ddtf = static_cast<float*>(ddt);
  float* dbpf = static_cast<float*>(dbp);
  float* dcpf = static_cast<float*>(dcp);
  float* daf = static_cast<float*>(da_part);
  if (dtype == 0)
    return dispatch_chunk<float>(x, dtf, af, bm, cm, dy, stf, dsf, dx, ddtf, dbpf, dcpf, daf, B,
                                 L, H, P, G, N, strides, s);
  return dispatch_chunk<__nv_bfloat16>(x, dtf, af, bm, cm, dy, stf, dsf, dx, ddtf, dbpf, dcpf,
                                       daf, B, L, H, P, G, N, strides, s);
}

// db and dc: (B, L, G, N) in the dtype, contiguous; da: (H) f32.
extern "C" int repro_ssd_scan_bwd_group_sum(int dtype, const void* dbp, const void* dcp,
                                            const void* da_part, void* db, void* dc, void* da,
                                            int B, int L, int H, int G, int N, void* stream) {
  if (int err = check(dtype, H, G, 1, N)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * L * G * N;
  const long long want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : want > 8192 ? 8192 : want);
  const float* dbpf = static_cast<const float*>(dbp);
  const float* dcpf = static_cast<const float*>(dcp);
  const float* dapf = static_cast<const float*>(da_part);
  float* daf = static_cast<float*>(da);
  if (dtype == 0)
    ssd_bwd_group_sum_kernel<float><<<blocks, kThreads, 0, s>>>(
        dbpf, dcpf, dapf, static_cast<float*>(db), static_cast<float*>(dc), daf, B, L, H, G, N);
  else
    ssd_bwd_group_sum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        dbpf, dcpf, dapf, static_cast<__nv_bfloat16*>(db), static_cast<__nv_bfloat16*>(dc), daf,
        B, L, H, G, N);
  return static_cast<int>(cudaGetLastError());
}
