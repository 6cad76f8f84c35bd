// The body of the group-pair packed int4 decode products, K7a (W4A16,
// int4_matmul.cu) and K7b (W4A8, int4_matmul_a8.cu): one kernel template,
// instantiated over a `Dot`, the inner product of a ring stage's weights
// with rows of x.
//
//   out[m, n] = rs[m] * sum_g scale[g, n] * sum_{k in g} x[m, k] * q4[k, n]
//
// wp (K/2, N) int8 in the layout of grove_tpu/ops/quant.py:pack_int4:
// packed row p*G + i holds logical row 2p*G + i in its low nibble and
// (2p+1)*G + i in its high nibble, so one "super-group" p of G packed rows
// carries quantisation groups 2p and 2p+1; scale (K/G, N) fp32. rs is 1
// (K7a) or the per-token scale sx (K7b, `Dot::kRowScale`).
//
// Bound on the H100: device-memory bytes, 0.5 B per weight plus the fp32
// group scales, read once. The template keeps weight bytes in flight on
// every SM and does little else per byte:
//   * One launch, no scratch. A CTA owns kTileN = 64 columns and MT <= 8
//     rows of x; the K / (2G) super-groups are split over the CTAs of a
//     thread-block cluster (cudaLaunchKernelEx), rank r taking
//     [S r / C, S (r + 1) / C). The ranks' fp32 partial tiles meet through
//     distributed shared memory: each rank adds every rank's tile, in rank
//     order, for its own share of the elements and writes out. No atomics:
//     the result does not depend on scheduling.
//   * The split depends on K and G alone (C = min(2, K / (2G)), chosen by
//     `_plan` in ops/int4_matmul.py), the tile width is fixed, and a
//     column's arithmetic does not depend on where its tile lies: a fused
//     projection sums each column in exactly the order of its unfused part.
//     Why 2 and 64 columns: an H100's GPCs do not hold the 16 clusters of 8
//     that a 4096-wide output in 256-column tiles makes one CTA an SM, so
//     some SMs took two and set the time; clusters of 2 spread 128 CTAs
//     over 128 SMs, one each.
//   * A deep weight stream: 16-byte cp.async copies (neighbouring lanes on
//     neighbouring columns) of 128 packed rows x 64 columns (8 KB) into a
//     ring of kStages = 4 stages (three of them, 24 KB, in flight while one
//     is consumed; a ring of 8 was measured no faster), beside them the
//     scale rows of the super-groups the stage overlaps. The CTA's K range
//     of x is copied into shared memory once, with the first stage. Shapes
//     with N % 16 != 0 take the instantiation with 4-byte copies; a K range
//     too long for shared memory the one that reads x from global memory.
//   * Each pair of warps takes a 32-row slice of a stage (the Dot's
//     `consume`); at a super-group's end the Dot folds its two groups'
//     sums, times their scales, into its fp32 totals in group order. At the
//     end the CTA adds its slices' totals in slice order, then the ranks'
//     tiles in rank order.
// `_plan` mirrors smem_bytes() below.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace int4mm {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kTileN = 64;           // columns (packed bytes) of a CTA
constexpr int kStageRows = 128;      // packed rows of a ring stage
constexpr int kSlice = 32;           // rows of a stage a warp pair takes
constexpr int kSlices = kStageRows / kSlice;              // 4
constexpr int kWeightBytes = kStageRows * kTileN;         // 8 KB
// a stage: its weights, then the 2 scale rows of each of the (at most 4)
// super-groups it overlaps
constexpr int kStageBytes = kWeightBytes + kSlices * 2 * kTileN * 4;
constexpr int kStages = 4;           // ring stages
constexpr int kMaxCluster = 8;
constexpr size_t kSmemLimit = 232448;   // shared bytes a block can use

struct Int4Args {
  const void* x;
  const int8_t* wp;
  const float* scale;
  const float* rs;   // per-row scale of the output (Dot::kRowScale), or null
  void* out;
  int m, k, n, g;
  int supers;    // K / (2G)
  int cluster;   // ranks splitting the super-groups
  int xstride;   // elements of a staged row of x: the longest rank's 2G share
};

inline size_t smem_bytes(int mt, int xstride, int xbytes) {
  return (size_t)kStages * kStageBytes + (size_t)mt * xstride * xbytes +
         sizeof(float) * (size_t)mt * kTileN;
}

__device__ __forceinline__ int rank_start(int supers, int cluster, int r) {
  return (int)((long long)supers * r / cluster);
}

// byte offset of (row, col) in a stage: the 16-byte chunks of a row are
// XOR-swizzled by (row / 4) % 4, so that the four rows 4t + i a tensor-core
// lane group reads meet at most two to a bank
__device__ __forceinline__ int swz(int row, int col) {
  return row * kTileN + ((((col >> 4) ^ (row >> 2)) & 3) << 4) + (col & 15);
}

template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = ok ? VEC : 0;                      // 0: zero-fill, no read
  if (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp pair's 32-row slice of a stage: the stage, the slice's first row
// in it, and the k of its first low-group row (the high group is G
// further), from the rank's start (`xlo`, the staged x) and in x (`kglob`).
struct Slice {
  const unsigned char* st;
  int row0;
  int xlo;
  int kglob;
};

// A Dot<MT> provides: Act (x's element type); kGroups (row groups of
// partial totals a CTA adds in order at the end); min_blocks(VEC, XS) (CTAs
// an SM, for __launch_bounds__); kMinMT (the fewest rows of x it takes);
// kRowScale (out times rs[m]); init(); slice() (the 32-row slice of a stage
// a thread's warp pair takes); consume<XS>(slice, x, x's row stride, G,
// rows of x left); fold(the super-group's two scale rows); partial(the
// CTA's [kGroups][MT][kTileN] tile of totals).
template <template <int> class Dot, int MT, int VEC, bool XS, typename Out>
__global__ void __launch_bounds__(kThreads, Dot<MT>::min_blocks(VEC, XS))
    int4_matmul_kernel(const Int4Args a) {
  using D = Dot<MT>;
  using Act = typename D::Act;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n0 = (int)(blockIdx.x / a.cluster) * kTileN;
  const int m0 = (int)blockIdx.y * MT;
  const int mrows = min(MT, a.m - m0);
  const int p0 = rank_start(a.supers, a.cluster, rank);
  const int p1 = rank_start(a.supers, a.cluster, rank + 1);
  const int rows = (p1 - p0) * a.g;              // packed rows of this rank
  const int stages = (rows + kStageRows - 1) / kStageRows;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  Act* xs = reinterpret_cast<Act*>(smem + kStages * kStageBytes);
  float* red = reinterpret_cast<float*>(xs + (XS ? MT * a.xstride : 0));

  // stage c of this rank into ring slot c % kStages: its rows (zero-filled
  // past the rank's range) and the two scale rows of each super-group it
  // overlaps, in its slots in order. A thread copies column `wcol` of rows
  // row0, row0 + kPass, ... of every stage (the swizzle is the same on
  // each, since kPass is a multiple of 16), so its offsets are worked out
  // once.
  constexpr int kPerRow = kTileN / VEC;
  constexpr int kPass = kThreads / kPerRow;         // rows a pass copies
  const int row0 = threadIdx.x / kPerRow, wcol = threadIdx.x % kPerRow * VEC;
  const int dst0 = swz(row0, wcol);
  const long long src0 = (long long)row0 * a.n + n0 + wcol;
  const int rowc = n0 + wcol < a.n ? row0 : kStageRows;  // past N: never
  // the next stage to load starts at rank row pq G + ps (pq: its first
  // super-group), carried from load to load: no division a stage
  int pq = 0, ps = 0;
  auto load = [&](int c) {
    unsigned char* st = ring + (c % kStages) * kStageBytes;
    const int8_t* wst = a.wp + ((long long)p0 * a.g + c * kStageRows) * a.n;
    const int valid = min(kStageRows, rows - c * kStageRows);
#pragma unroll
    for (int j = 0; j < kStageRows / kPass; ++j) {
      const bool ok = rowc + j * kPass < valid;
      cp_async<VEC>(st + dst0 + j * kPass * kTileN,
                    ok ? wst + src0 + (long long)j * kPass * a.n : a.wp, ok);
    }
    constexpr int kPerScale = kTileN * 4 / VEC;       // copies a scale row
    int sgs = 1;                       // super-groups the stage overlaps
    for (int e = ps + valid - a.g; e > 0; e -= a.g) ++sgs;
    for (int i = threadIdx.x; i < sgs * 2 * kPerScale; i += kThreads) {
      const int q = i / (2 * kPerScale);
      const int row = i / kPerScale % 2;
      const int col = i % kPerScale * (VEC / 4);
      const bool ok = n0 + col < a.n;
      const long long p = p0 + pq + q;
      cp_async<VEC>(reinterpret_cast<float*>(st + kWeightBytes) +
                        (q * 2 + row) * kTileN + col,
                    ok ? a.scale + (2 * p + row) * a.n + n0 + col : a.scale,
                    ok);
    }
    for (ps += kStageRows; ps >= a.g; ps -= a.g) ++pq;
  };

  if constexpr (XS) {  // the rank's K range of x, with the first stage
    constexpr int kPer = 16 / sizeof(Act);       // elements a copy
    const int per_row = (p1 - p0) * 2 * a.g / kPer;
    const Act* x = static_cast<const Act*>(a.x);
    const long long k0 = (long long)p0 * 2 * a.g;
    for (int i = threadIdx.x; i < MT * per_row; i += kThreads) {
      const int m = i / per_row;
      const int j = (i % per_row) * kPer;
      const bool ok = m < mrows;
      cp_async<16>(xs + m * a.xstride + j,
                   x + (ok ? (long long)(m0 + m) * a.k + k0 + j : 0), ok);
    }
  }
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < stages) load(c);
    cp_async_commit();
  }

  D d;
  d.init();
  const int sl = D::slice();
  const Act* xg = XS ? xs : static_cast<const Act*>(a.x) + (long long)m0 * a.k;
  const int xst = XS ? a.xstride : a.k;
  // the slice's rank row r = q G + ri (q: its super-group), and the
  // stage's first row q0 G + si, carried from stage to stage
  int r = sl * kSlice, q = r / a.g, ri = r % a.g, q0 = 0, si = 0;
  for (int c = 0; c < stages; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();             // stage c landed; stage c - 1 consumed
    if (c + kStages - 1 < stages) load(c + kStages - 1);
    cp_async_commit();

    if (r < rows) {
      const unsigned char* st = ring + (c % kStages) * kStageBytes;
      Slice s;
      s.st = st;
      s.row0 = sl * kSlice;
      s.xlo = q * 2 * a.g + ri;
      s.kglob = (p0 + q) * 2 * a.g + ri;
      d.template consume<XS>(s, xg, xst, a.g, mrows);
      // its warps' next slice lies in another super-group, or past the
      // rank's rows: fold with its super-group's scales
      if (ri + kStageRows >= a.g || r + kStageRows >= rows)
        d.fold(reinterpret_cast<const float*>(st + kWeightBytes) +
               (q - q0) * 2 * kTileN);
    }
    r += kStageRows;
    for (ri += kStageRows; ri >= a.g; ri -= a.g) ++q;
    for (si += kStageRows; si >= a.g; si -= a.g) ++q0;
  }

  // the CTA's tile: its row groups added in order into `red`
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free
  float* part = reinterpret_cast<float*>(ring);  // [kGroups][MT][kTileN]
  d.partial(part);
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kTileN; i += kThreads) {
    float s = part[i];
#pragma unroll
    for (int q = 1; q < D::kGroups; ++q) s += part[q * MT * kTileN + i];
    red[i] = s;
  }
  cluster.sync();                                // every rank's tile is done

  // this rank's share of the tile: every rank's partial, in rank order
  const int e0 = MT * kTileN * rank / a.cluster;
  const int e1 = MT * kTileN * (rank + 1) / a.cluster;
  Out* out = static_cast<Out*>(a.out);
  for (int i = e0 + threadIdx.x; i < e1; i += kThreads) {
    const int row = m0 + i / kTileN;
    const int n = n0 + i % kTileN;
    if (row < a.m && n < a.n) {
      float s = 0.f;
      for (int q = 0; q < a.cluster; ++q)
        s += cluster.map_shared_rank(red, q)[i];
      if constexpr (D::kRowScale) s = __fmul_rn(s, a.rs[row]);
      out[(long long)row * a.n + n] = grove::from_f<Out>(s);
    }
  }
  cluster.sync();                  // no rank leaves while its tile is read
}

template <template <int> class Dot, int MT, int VEC, bool XS, typename Out>
int run(const Int4Args& a, cudaStream_t st) {
  auto kernel = int4_matmul_kernel<Dot, MT, VEC, XS, Out>;
  const size_t bytes =
      smem_bytes(MT, XS ? a.xstride : 0, sizeof(typename Dot<MT>::Act));
  static size_t allowed = 48 * 1024;   // per instantiation
  if (bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((a.n + kTileN - 1) / kTileN * a.cluster),
                     (unsigned)((a.m + MT - 1) / MT), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the instantiations: 16-byte or 4-byte weight copies (N % 16 != 0, or
// weights or scales off 16 bytes) with x staged; x from global memory with
// 4-byte copies
template <template <int> class Dot, int MT, typename Out>
int run_mt(const Int4Args& a, int vec, int staged, cudaStream_t st) {
  if (!staged)
    return vec == 4 ? run<Dot, MT, 4, false, Out>(a, st)
                    : (int)cudaErrorInvalidValue;
  return vec == 16 ? run<Dot, MT, 16, true, Out>(a, st)
                   : run<Dot, MT, 4, true, Out>(a, st);
}

template <template <int> class Dot, typename Out>
int run_dot(const Int4Args& a, int mt, int vec, int staged,
            cudaStream_t st) {
  switch (mt) {
    case 1:
      if constexpr (Dot<8>::kMinMT == 1)
        return run_mt<Dot, 1, Out>(a, vec, staged, st);
      return (int)cudaErrorInvalidValue;
    case 2: return run_mt<Dot, 2, Out>(a, vec, staged, st);
    case 4: return run_mt<Dot, 4, Out>(a, vec, staged, st);
    case 8: return run_mt<Dot, 8, Out>(a, vec, staged, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The plan's fields (ops/int4_matmul.py `_plan`): mt rows of x per CTA (1,
// 2, 4 or 8), cluster ranks splitting the super-groups, vec bytes per
// weight copy (16, or 4), staged (x copied into shared memory, 16-byte
// aligned; else read from global memory, 8-byte aligned). Fills `a` and
// returns 0, or cudaErrorInvalidValue for what the template does not take.
inline int make_args(Int4Args& a, const void* x, const void* wp,
                     const float* scale, const float* rs, void* out, int m,
                     int k, int n, int g, int mt, int cluster, int vec,
                     int staged, int xbytes) {
  if (g <= 0 || g % kSlice != 0 || k <= 0 || k % (2 * g) != 0 || n <= 0 ||
      n % 4 != 0 || (vec != 4 && vec != 16) || (vec == 16 && n % 16 != 0) ||
      m <= 0 || mt < 1 || (m + mt - 1) / mt > 65535 || cluster < 1 ||
      cluster > kMaxCluster || cluster > k / (2 * g) ||
      (vec == 16 && ((uintptr_t)wp % 16 || (uintptr_t)scale % 16)) ||
      (uintptr_t)x % (staged ? 16 : 8))
    return (int)cudaErrorInvalidValue;
  a.x = x;
  a.wp = static_cast<const int8_t*>(wp);
  a.scale = scale;
  a.rs = rs;
  a.out = out;
  a.m = m;
  a.k = k;
  a.n = n;
  a.g = g;
  a.supers = k / (2 * g);
  a.cluster = cluster;
  a.xstride = (a.supers + cluster - 1) / cluster * 2 * g;
  if (smem_bytes(mt, staged ? a.xstride : 0, xbytes) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace int4mm
