// Int8 split-KV flash-decoding for Hopper (sm_90a): one launch a call, the
// cache streamed through a cp.async ring, the splits combined inside a
// thread-block cluster.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/decode_kernel.py
// (flash_decode_int8, pallas_call at :93, body :30-66).
//
//   o[b, h, :] = softmax_j(qs[b, h] . k[b, h / G, j]) v[b, h / G, j],   G = Hq / Hk
//   qs = round_to_q_dtype(q * 1/sqrt(D)),  k = int8 * f32(k_scale),  v = int8 * f32(v_scale)
//
// over the positions j < kv_len (the others score -1e30 in the TPU kernel, so
// their weight is 0 and they are not read here); softmax with the 1e-37 floor
// on its sum; output f32.
//
// What bounds it on the card: bytes.  At qwen1.5-0.5b's served decode (B = 4,
// Hk = 16, kv_len = 2,080, D = 64) it reads 17.04 MB of int8 K/V and 0.53 MB
// of bf16 scales for ~8.5 MFLOP: 5.3 us at 3.35 TB/s; at decode_32k's length
// (kv_len = 32,768) 276.9 MB, 82.6 us.  The design, part by part:
//   * Grid (splits, Hk, B): one block a (b, KV head, split of the positions)
//     serves all G query heads of that KV head, so each int8 row leaves memory
//     once per group.  A block is 512 threads (one an SM at 128 registers a
//     thread) where G = 1, 256 where a thread holds more heads.
//   * The splits of one (b, KV head) are one thread-block cluster, so their
//     count is the largest of 1, 2, 4, 8 whose B * Hk clusters all fit on the
//     card at once (cudaOccupancyMaxActiveClusters, asked by the wrapper: a
//     cluster stays inside one GPC, so on an H100 64 clusters of 2 fit and 64
//     of 4 do not): 2 at qwen's served shape, 128 blocks; one split where
//     B * Hk alone fills the card.  Splits cut [0, S); kv_len is a runtime
//     argument, so one build serves every decode position, and a split wholly
//     past kv_len reads nothing.
//   * The stream.  lanes_per_row(D) lanes own a row, 16 columns (one 16-byte
//     vector) each, and a thread walks its rows through a 4-stage cp.async
//     ring in shared memory, one row a stage: three rows (96 bytes, ~48 KB an
//     SM) in flight while one is computed.  Each thread copies only the bytes
//     it reads itself, so cp.async.wait_group is the only wait: no block
//     barrier in the position loop.  The copies ask L2 for the whole 128-byte
//     line: in the model's layout the rest of it is the next KV head's row,
//     which another block reads soon after (in trials on an H100 this beat no
//     hint and a 256-byte one; a deeper ring, two rows a stage and 128-thread
//     blocks were slower).  The scales (2 or 4 bytes, Hk apart in the model's
//     layout: below cp.async's 4-byte grain for bf16) ride in a register ring
//     beside it, loaded when their rows' copies are issued.  Not TMA: the
//     model's (B, S, Hk, D) cache puts a row's 64 bytes 1,024 bytes apart, so
//     a tensor map would be built on the host for every call and view, and
//     per-thread 16-byte copies already keep enough bytes in flight.  Where D
//     is not a multiple of 16 or a view is not 16-byte aligned (vec = 0),
//     rows are read a byte at a time when computed, with no ring.
//   * The arithmetic stays on FFMA (the limit is 1e-5 against an f32 plain
//     version, which a bf16 P.V would miss; ~8.5 MFLOP is 0.13 us at the f32
//     rate).  int8 -> f32 is a byte permute into 2^23's mantissa and a
//     subtraction (I2F runs at a quarter of FFMA's rate).  A row's score is
//     summed across its lanes with shuffles; each thread keeps its own running
//     (m, l) and an f32 acc for its 16 columns of each of its heads, rescaled
//     only when a row raises the max.
//   * Heads.  A thread holds 1, 2 or 4 heads (G = 1, 2, >= 3).  Where G needs
//     more than one group of four, the block's warps split into 2 or 4 teams,
//     one group each at a time, and every team streams the split's rows (the
//     repeats hit L2).  Every G * D <= 4096 takes this one path; qwen's served
//     shape (G = 1, D = 64) has one team of 16 warps.
//   * The merge.  Threads of a warp that share columns merge (m, l, acc) with
//     shuffles, the team's warps through shared memory; the block's (m, l,
//     acc) for its G heads stay in its shared memory.  After a cluster
//     barrier each block reads its peers' partials through distributed
//     shared memory and writes its share of the (head, column) outputs; a
//     second cluster barrier keeps every block resident until its peers have
//     read it.  Idle splits reach both barriers and contribute l = 0.  No
//     scratch in device memory, no second kernel: one launch a call.
//   * The cache is read in place through strides: the model's (B, S, Hk, D)
//     int8 cache and (B, S, Hk) scales, viewed as (B, Hk, S, D) and (B, Hk, S).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = 4;              // cp.async ring depth: rows a thread has in flight + 1
constexpr int kMaxSplits = 8;           // the portable cluster size
constexpr int kMaxGroupColumns = 4096;  // G * D
constexpr int kMaxPositions = (1 << 30);  // row counters run past S in int
constexpr float kMask = -1e30f;

struct Strides {  // element strides; the head dimension is unit-stride
  long long q_b, q_h;
  long long k_b, k_h, k_s, v_b, v_h, v_s;
  long long ks_b, ks_h, ks_s, vs_b, vs_h, vs_s;
};

// a power of two >= ceil(D / 16), at most 16
__host__ __device__ inline int lanes_per_row(int D) {
  int l = 1;
  while (l * 16 < D) l *= 2;
  return l;
}

__host__ __device__ inline int heads_per_thread(int G) { return G == 1 ? 1 : G == 2 ? 2 : 4; }

// warps split into teams, one group of heads_per_thread heads a team at a time
__host__ __device__ inline int teams(int G) {
  const int hpt = heads_per_thread(G), groups = (G + hpt - 1) / hpt;
  return groups == 1 ? 1 : groups == 2 ? 2 : 4;
}

// threads a block: one block an SM, every register a thread may hold
__host__ __device__ constexpr int block_threads(int hpt) { return hpt == 1 ? 512 : 256; }

// a 16-byte K and V slice a thread a stage
__host__ __device__ constexpr int ring_bytes(int hpt) {
  return kStages * 2 * block_threads(hpt) * 16;
}

// ring, then the team warps' partials (TS, G, 2 + D) and the block's (G, 2 + D), f32
inline size_t smem_bytes(int G, int D) {
  const int hpt = heads_per_thread(G), ts = block_threads(hpt) / 32 / teams(G);
  return ring_bytes(hpt) + sizeof(float) * (size_t)(ts + 1) * G * (D + 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f(integral_constant<int, 0>), ..., f(integral_constant<int, N - 1>), in order
template <int N>
struct Unroll {
  template <class F>
  __device__ __forceinline__ static void run(F&& f) {
    Unroll<N - 1>::run(f);
    f(std::integral_constant<int, N - 1>{});
  }
};
template <>
struct Unroll<0> {
  template <class F>
  __device__ __forceinline__ static void run(F&&) {}
};

__device__ __forceinline__ float load_f(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// a scale as it lies in memory (bf16 bits or f32), widened when used
template <bool SBF16>
struct Scale {
  using raw = float;
  __device__ static raw load(const void* p, long long i) { return static_cast<const float*>(p)[i]; }
  __device__ static float f(raw x) { return x; }
};
template <>
struct Scale<true> {
  using raw = unsigned short;
  __device__ static raw load(const void* p, long long i) {
    return static_cast<const unsigned short*>(p)[i];
  }
  __device__ static float f(raw x) { return __uint_as_float(static_cast<unsigned>(x) << 16); }
};

// 16 int8 values as f32: each byte, biased by 128, becomes the low mantissa
// bits of 2^23 and 2^23 + 128 comes off again (exact)
__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  const unsigned w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                         u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u | j)) - 8388736.f;
}

// 16 int8 values of a row from its lane's first column on, a byte at a time
// (zeros past D): the path of rows that 16-byte copies cannot read
__device__ __forceinline__ uint4 load16_bytes(const int8_t* p, int n) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && i < n; ++i) w[i / 4] |= (unsigned)(uint8_t)p[i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Grid (splits, Hk, B), clusters of (splits, 1, 1); out (B, Hq, D) f32.
template <int HPT, bool VEC, bool SBF16>
__global__ void __launch_bounds__(block_threads(HPT), 1) decode_kernel(
    const void* __restrict__ q, const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const void* __restrict__ ks, const void* __restrict__ vs, float* __restrict__ out, int Hq,
    int Hk, int S, int D, int kv_len, int chunk, float scale, int q_bf16, Strides st) {
  constexpr int kThreads = block_threads(HPT), kWarps = kThreads / 32;
  using Sc = Scale<SBF16>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int G = Hq / Hk;
  const int lpr = lanes_per_row(D), rpw = 32 / lpr;
  const int groups = (G + HPT - 1) / HPT;
  const int T = groups == 1 ? 1 : groups == 2 ? 2 : 4, TS = kWarps / T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = warp % T, wi = warp / T;
  const int li = lane % lpr, d0 = li * 16;
  const bool live_lane = d0 < D;
  const int nslots = TS * rpw, slot = wi * rpw + lane / lpr;

  uint4* ring = reinterpret_cast<uint4*>(smem);  // (kStages, K|V, kThreads)
  float* part = reinterpret_cast<float*>(smem + ring_bytes(HPT));
  float* fin = part + (size_t)TS * G * (D + 2);  // (G, 2 + D): m, l, acc
  const int row_f = D + 2;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int j_begin = split * chunk;
  const int j_end = min(min(j_begin + chunk, S), kv_len);
  // rows a thread folds: every slot of the team takes one a step
  const int steps = j_end > j_begin ? (j_end - j_begin + nslots - 1) / nslots : 0;

  const int8_t* kb = k + b * st.k_b + hk * st.k_h + d0;
  const int8_t* vb = v + b * st.v_b + hk * st.v_h + d0;
  const long long ks_off = b * st.ks_b + hk * st.ks_h, vs_off = b * st.vs_b + hk * st.vs_h;

  for (int hg = team; hg < groups; hg += T) {
    float qr[HPT][16], m[HPT], l[HPT], acc[HPT][16];
    typename Sc::raw ksr[kStages], vsr[kStages];
    // the next row to issue and to fold (a thread's rows are nslots apart),
    // and where the issued row and its scales lie
    int j_iss = j_begin + slot, j_use = j_iss;
    const int8_t* k_iss = kb + j_iss * st.k_s;
    const int8_t* v_iss = vb + j_iss * st.v_s;
    const int8_t* k_use = k_iss;
    const int8_t* v_use = v_iss;
    long long ks_iss = ks_off + j_iss * st.ks_s, vs_iss = vs_off + j_iss * st.vs_s;
    const long long k_row = nslots * st.k_s, v_row = nslots * st.v_s;
    const long long ks_row = nslots * st.ks_s, vs_row = nslots * st.vs_s;

    // copy the next row into ring stage ST and load its scales
    auto issue = [&](auto stage) {
      constexpr int ST = decltype(stage)::value;
      const bool valid = j_iss < j_end;
      if (VEC && valid && live_lane) {
        cp_async16(&ring[(ST * 2) * kThreads + tid], k_iss);
        cp_async16(&ring[(ST * 2 + 1) * kThreads + tid], v_iss);
      }
      typename Sc::raw a = 0, c = 0;
      if (valid) {
        a = Sc::load(ks, ks_iss);
        c = Sc::load(vs, vs_iss);
      }
      ksr[ST] = a;
      vsr[ST] = c;
      cp_async_commit();
      j_iss += nslots;
      k_iss += k_row;
      v_iss += v_row;
      ks_iss += ks_row;
      vs_iss += vs_row;
    };

    // fold the next row, in ring stage ST, into (m, l, acc)
    auto consume = [&](auto stage) {
      constexpr int ST = decltype(stage)::value;
      const bool valid = j_use < j_end;
      uint4 ku = make_uint4(0u, 0u, 0u, 0u), vu = ku;
      if (valid && live_lane) {
        if (VEC) {
          ku = ring[(ST * 2) * kThreads + tid];
          vu = ring[(ST * 2 + 1) * kThreads + tid];
        } else {
          ku = load16_bytes(k_use, D - d0);
          vu = load16_bytes(v_use, D - d0);
        }
      }
      j_use += nslots;
      if (!VEC) {
        k_use += k_row;
        v_use += v_row;
      }
      float kf[16], s[HPT];
      unpack16(ku, kf);
      const float ksc = Sc::f(ksr[ST]);
#pragma unroll
      for (int h = 0; h < HPT; ++h) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int c = 0; c < 16; c += 2) {
          p0 = fmaf(qr[h][c], kf[c], p0);
          p1 = fmaf(qr[h][c + 1], kf[c + 1], p1);
        }
        float dot = p0 + p1;
        for (int off = lpr / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[h] = dot * ksc;
      }
      if (!valid) return;  // past the split or kv_len: after the row's shuffles
      float vf[16];
      unpack16(vu, vf);
      const float vsc = Sc::f(vsr[ST]);
#pragma unroll
      for (int h = 0; h < HPT; ++h) {
        if (s[h] > m[h]) {  // a new max: rescale what came before
          const float corr = expf(m[h] - s[h]);
          l[h] *= corr;
#pragma unroll
          for (int c = 0; c < 16; ++c) acc[h][c] *= corr;
          m[h] = s[h];
        }
        const float p = expf(s[h] - m[h]);
        l[h] += p;
        const float pv = p * vsc;
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[h][c] = fmaf(pv, vf[c], acc[h][c]);
      }
    };

    Unroll<kStages - 1>::run([&](auto stage) { issue(stage); });
    // q, and the running state, while the prologue's copies are in flight
#pragma unroll
    for (int h = 0; h < HPT; ++h) {
      const int g = hg * HPT + h;
      m[h] = kMask;
      l[h] = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float x = 0.f;
        if (g < G && d0 + c < D) {
          x = load_f(q, b * st.q_b + (long long)(hk * G + g) * st.q_h + d0 + c, q_bf16) * scale;
          if (q_bf16) x = __bfloat162float(__float2bfloat16(x));  // rounded back, as the TPU wrapper
        }
        qr[h][c] = x;
        acc[h][c] = 0.f;
      }
    }
    for (int i0 = 0; i0 < steps; i0 += kStages) {
      // stage i holds row step i0 + i; each issue refills the stage folded last
      Unroll<kStages>::run([&](auto stage) {
        constexpr int ST = decltype(stage)::value;
        if (i0 + ST < steps) {
          issue(std::integral_constant<int, (ST + kStages - 1) % kStages>{});
          cp_async_wait<kStages - 1>();
          consume(stage);
        }
      });
    }
    cp_async_wait<0>();

    // merge the warp's row slots that share columns, then leave the warp's
    // partial in shared memory
#pragma unroll
    for (int h = 0; h < HPT; ++h) {
      for (int off = lpr; off < 32; off *= 2) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
        const float mn = fmaxf(m[h], mo);
        const float a = expf(m[h] - mn), c = expf(mo - mn);
        l[h] = l[h] * a + lo * c;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          acc[h][i] = acc[h][i] * a + __shfl_xor_sync(0xffffffffu, acc[h][i], off) * c;
        m[h] = mn;
      }
      const int g = hg * HPT + h;
      if (lane < lpr && g < G) {
        float* p = part + ((size_t)wi * G + g) * row_f;
        if (li == 0) {
          p[0] = m[h];
          p[1] = l[h];
        }
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (d0 + i < D) p[2 + d0 + i] = acc[h][i];
      }
    }
  }
  __syncthreads();

  // the team's warps into the block's partial
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float mx = kMask;
    for (int w = 0; w < TS; ++w) mx = fmaxf(mx, part[((size_t)w * G + g) * row_f]);
    float ls = 0.f, as = 0.f;
    for (int w = 0; w < TS; ++w) {
      const float* p = part + ((size_t)w * G + g) * row_f;
      const float c = expf(p[0] - mx);
      ls = fmaf(c, p[1], ls);
      as = fmaf(c, p[2 + d], as);
    }
    fin[g * row_f + 2 + d] = as;
    if (d == 0) {
      fin[g * row_f] = mx;
      fin[g * row_f + 1] = ls;
    }
  }

  // the splits: every block of the cluster reads its peers' partials and
  // writes its share of the outputs; the last barrier keeps each block's
  // shared memory alive until its peers are done reading it
  cluster.sync();
  const int rank = (int)cluster.block_rank(), nsplit = (int)cluster.num_blocks();
  float* o = out + ((long long)b * Hq + (long long)hk * G) * D;
  for (int e = rank * kThreads + tid; e < G * D; e += nsplit * kThreads) {
    const int g = e / D, d = e % D;
    float pm[kMaxSplits], pl[kMaxSplits], pa[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {  // every peer's loads in flight at once
      pm[r] = kMask;
      pl[r] = pa[r] = 0.f;
      if (r < nsplit) {
        const float* p = cluster.map_shared_rank(fin, r) + g * row_f;
        pm[r] = p[0];
        pl[r] = p[1];
        pa[r] = p[2 + d];
      }
    }
    float mx = kMask;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) mx = fmaxf(mx, pm[r]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      const float c = expf(pm[r] - mx);
      ls = fmaf(c, pl[r], ls);
      as = fmaf(c, pa[r], as);
    }
    o[e] = as / fmaxf(ls, 1e-37f);
  }
  cluster.sync();
}

// the kernel's launch shape: grid (splits, Hk, B) in clusters of (splits, 1, 1)
template <int HPT, bool VEC, bool SBF16>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, dim3 grid, size_t smem,
                      cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<HPT, VEC, SBF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block_threads(HPT));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;  // the splits of one (b, KV head)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int HPT, bool VEC, bool SBF16>
int launch(dim3 grid, size_t smem, cudaStream_t s, const void* q, const int8_t* k,
           const int8_t* v, const void* ks, const void* vs, float* out, int Hq, int Hk, int S,
           int D, int kv_len, int chunk, float scale, int q_bf16, const Strides& st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<HPT, VEC, SBF16>(cfg, attr, grid, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, decode_kernel<HPT, VEC, SBF16>, q, k, v, ks, vs, out, Hq, Hk, S,
                         D, kv_len, chunk, scale, q_bf16, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int HPT>
int max_clusters(int G, int D, int splits) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  cudaError_t e = configure<HPT, true, true>(cfg, attr, dim3((unsigned)splits), smem_bytes(G, D),
                                             nullptr);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&n, decode_kernel<HPT, true, true>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <int HPT>
int launch_hpt(int vec, int s_bf16, dim3 grid, size_t smem, cudaStream_t s, const void* q,
               const int8_t* k, const int8_t* v, const void* ks, const void* vs, float* out,
               int Hq, int Hk, int S, int D, int kv_len, int chunk, float scale, int q_bf16,
               const Strides& st) {
#define REPRO_DECODE(VEC, SB)                                                                    \
  launch<HPT, VEC, SB>(grid, smem, s, q, k, v, ks, vs, out, Hq, Hk, S, D, kv_len, chunk, scale, \
                       q_bf16, st)
  if (vec) return s_bf16 ? REPRO_DECODE(true, true) : REPRO_DECODE(true, false);
  return s_bf16 ? REPRO_DECODE(false, true) : REPRO_DECODE(false, false);
#undef REPRO_DECODE
}

}  // namespace

extern "C" int repro_flash_decode_int8_smem_bytes(int G, int D) { return (int)smem_bytes(G, D); }

// clusters of `splits` blocks that fit on the card at once at group size G and head size D
// (cudaOccupancyMaxActiveClusters; a negative CUDA error on failure)
extern "C" int repro_flash_decode_int8_max_clusters(int G, int D, int splits) {
  if (G < 1 || D < 1 || D > 256 || G * D > kMaxGroupColumns || splits < 1 || splits > kMaxSplits)
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (heads_per_thread(G)) {
    case 1: return max_clusters<1>(G, D, splits);
    case 2: return max_clusters<2>(G, D, splits);
    default: return max_clusters<4>(G, D, splits);
  }
}

// q (B, Hq, D) f32/bf16; k, v int8 (B, Hk, S, D); k_scale, v_scale (B, Hk, S) f32/bf16,
// all through `strides` (14 element strides, see Strides); out (B, Hq, D) f32 contiguous.
// Positions [split * chunk, (split + 1) * chunk) form a split; splits <= 8 blocks form the
// cluster of one (b, KV head).  vec: D % 16 == 0 and K/V rows 16-byte aligned.  Launches once
// on `stream` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int repro_flash_decode_int8(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale, void* out,
                                       int B, int Hq, int Hk, int S, int D, int kv_len, int chunk,
                                       int splits, float scale, int q_bf16, int s_bf16, int vec,
                                       const long long* strides, void* stream) {
  if (B <= 0 || Hk <= 0 || Hq % Hk || D <= 0 || D > 256 || (Hq / Hk) * D > kMaxGroupColumns ||
      kv_len < 1 || kv_len > S || S > kMaxPositions || chunk < 1 || splits < 1 ||
      splits > kMaxSplits ||
      (long long)chunk * splits < S || (long long)chunk * (splits - 1) >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  long long* f = &st.q_b;
  for (int i = 0; i < 14; ++i) f[i] = strides[i];
  const int G = Hq / Hk;
  const dim3 grid((unsigned)splits, (unsigned)Hk, (unsigned)B);
  const size_t smem = smem_bytes(G, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  float* o = static_cast<float*>(out);
  switch (heads_per_thread(G)) {
    case 1:
      return launch_hpt<1>(vec, s_bf16, grid, smem, s, q, kp, vp, k_scale, v_scale, o, Hq, Hk, S,
                           D, kv_len, chunk, scale, q_bf16, st);
    case 2:
      return launch_hpt<2>(vec, s_bf16, grid, smem, s, q, kp, vp, k_scale, v_scale, o, Hq, Hk, S,
                           D, kv_len, chunk, scale, q_bf16, st);
    default:
      return launch_hpt<4>(vec, s_bf16, grid, smem, s, q, kp, vp, k_scale, v_scale, o, Hq, Hk, S,
                           D, kv_len, chunk, scale, q_bf16, st);
  }
}
