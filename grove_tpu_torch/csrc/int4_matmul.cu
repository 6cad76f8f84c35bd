// K7a: W4A16 matmul over group-pair packed int4 weights (LLaMA decode).
//
// Replaces grove_tpu/ops/int4_matmul.py:_kernel (its pallas_call is at :317,
// reached through int4_matmul, :287), which Int4Dense takes for fewer than
// 64 rows (models/layers.py:263-267): every projection of every decode step
// of the int4 LLaMA-7B, at M = 2 and (K, N) = (4096, 4096), (4096, 11008)
// and (11008, 4096), or the fused (4096, 12288) and (4096, 22016).
//
//   out[m, n] = sum_g scale[g, n] * sum_{k in g} x[m, k] * q4[k, n]
//
// x (M, K) float or bf16; wp (K/2, N) int8 in the layout of
// grove_tpu/ops/quant.py:pack_int4: packed row p*G + i holds logical row
// 2p*G + i in its low nibble and (2p+1)*G + i in its high nibble, so one
// "super-group" p of G packed rows carries quantisation groups 2p and 2p+1.
// scale (K/G, N) fp32. Each group's products are summed in fp32, times the
// group's scale, added into an fp32 sum; out is in x's dtype. The TPU
// kernel's biased-nibble algebra existed only because Mosaic could not shift
// int8 vectors; it is not copied.
//
// Bound on the H100: device-memory bytes, 0.5 B per weight plus the fp32
// group scales (8.91 MB for 4096 x 4096 at G = 128, 0.0027 ms at 3.35 TB/s),
// read once; x and out are a few KB. The design keeps weight bytes in flight
// on every SM and does little else per byte:
//   * One launch, no scratch. A CTA owns kTileN = 64 columns and MT <= 8
//     rows of x; the K / (2G) super-groups are split over the CTAs of a
//     thread-block cluster (cudaLaunchKernelEx), rank r taking
//     [S r / C, S (r + 1) / C). The ranks' fp32 partial tiles meet through
//     distributed shared memory: each rank adds every rank's tile, in rank
//     order, for its own share of the elements and writes out. No atomics:
//     the result does not depend on scheduling.
//   * The split depends on K and G alone (C = min(2, K / (2G))), the tile
//     width is fixed, and a column's arithmetic does not depend on where its
//     tile lies: a fused projection sums each column in exactly the order of
//     its unfused part. Why 2 and 64 columns: an H100's GPCs do not hold
//     the 16 clusters of 8 that a 4096-wide output in 256-column tiles
//     makes one CTA an SM, so some SMs took two and set the time; clusters
//     of 2 spread 128 CTAs over 128 SMs, one each.
//   * A deep weight stream: 16-byte cp.async copies (neighbouring lanes on
//     neighbouring columns) of 128 packed rows x 64 columns (8 KB) into a
//     ring of kStages = 4 stages (three of them, 24 KB, in flight while one
//     is consumed; a ring of 8 was measured no faster), beside them the
//     scale rows of the super-groups the stage overlaps. The CTA's K range
//     of x is copied into shared memory once, with the first stage. Shapes
//     with N % 16 != 0 take the instantiation with 4-byte copies; a K range
//     too long for shared memory the one that reads x from global memory.
//   * bf16 x (the decode path) on the tensor cores (TcDot): each warp takes
//     a 32-row slice of a stage and 32 columns; mma.sync m16n8k16 computes
//     the transposed product, the weights as the A operand (16 columns x 16
//     rows: a lane's four 32-bit loads give two columns' k-pairs through
//     PRMT, a nibble pair becomes two exact bf16 n with one LOP3 and one
//     FMA.BF16x2 from the bits 0x4300 | (n ^ 8), i.e. 136 + n), x as the B
//     operand (up to 8 rows), products exact, sums in fp32: about 3.6
//     instructions a weight byte against ~9.5 for an FFMA per nibble and row.
//   * fp32 x (SimtDot) stays in fp32 FFMAs: a nibble becomes a float with
//     one LOP3 and one FADD, (w & (0xF << 4j)) ^ (0x4B000000 | 8 << 4j)
//     being 2^23 + (n + 8) 16^j, exact for j = 0..3; the 16^j comes out
//     exactly with the scale.
// `_plan` in ops/int4_matmul.py chooses MT, the cluster, the copy width and
// whether x is staged, and mirrors smem_bytes() below.

#include <cooperative_groups.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace cg = cooperative_groups;

namespace {

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

struct Int4Args {
  const void* x;
  const int8_t* wp;
  const float* scale;
  void* out;
  int m, k, n, g;
  int supers;    // K / (2G)
  int cluster;   // ranks splitting the super-groups
  int xstride;   // elements of a staged row of x: the longest rank's 2G share
};

size_t smem_bytes(int mt, int xstride, int xbytes) {
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

// fp32 x: two warps a slice, a lane 4 columns of 8 of its 32 rows (two
// rows a load: 16 lanes a 64-byte row, neighbouring rows in other banks);
// 16 row groups a CTA, added in order at the end.
template <int MT>
struct SimtDot {
  using Act = float;
  static constexpr int kGroups = 16;
  static constexpr int kMinBlocks = MT <= 2 ? 2 : 1;   // CTAs an SM
  static constexpr int kMinMT = 1;
  float lo[MT][4], hi[MT][4], tot[MT][4];
  int cl, sub;                     // 4-column group; row offset in the slice

  __device__ void init() {
    const int lane = threadIdx.x & 31;
    cl = lane & 15;
    sub = ((threadIdx.x >> 5) & 1) * 2 + (lane >> 4);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) lo[m][c] = hi[m][c] = tot[m][c] = 0.f;
  }
  __device__ static int slice() { return threadIdx.x >> 6; }
  __device__ int group() const { return slice() * 4 + sub; }

  template <bool XS>
  __device__ void consume(const Slice& s, const float* x, int xst, int g,
                          int mrows) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = sub + 4 * j;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          s.st + swz(s.row0 + r, cl * 4));
      const uint32_t u = w >> 16;
      float wl[4], wh[4];
      wl[0] = __uint_as_float((w & 0xFu) ^ 0x4B000008u) - 8388616.f;
      wh[0] = __uint_as_float((w & 0xF0u) ^ 0x4B000080u) - 8388736.f;
      wl[1] = __uint_as_float((w & 0xF00u) ^ 0x4B000800u) - 8390656.f;
      wh[1] = __uint_as_float((w & 0xF000u) ^ 0x4B008000u) - 8421376.f;
      wl[2] = __uint_as_float((u & 0xFu) ^ 0x4B000008u) - 8388616.f;
      wh[2] = __uint_as_float((u & 0xF0u) ^ 0x4B000080u) - 8388736.f;
      wl[3] = __uint_as_float((u & 0xF00u) ^ 0x4B000800u) - 8390656.f;
      wh[3] = __uint_as_float((u & 0xF000u) ^ 0x4B008000u) - 8421376.f;
      const int k = (XS ? s.xlo : s.kglob) + r;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = XS || m < mrows ? x[m * xst + k] : 0.f;
        const float xh = XS || m < mrows ? x[m * xst + k + g] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          lo[m][q] = fmaf(xl, wl[q], lo[m][q]);
          hi[m][q] = fmaf(xh, wh[q], hi[m][q]);
        }
      }
    }
  }

  // the two groups' sums, times their scales (the 16^j of each nibble
  // position undone exactly), into the total
  __device__ void fold(const float* ss) {
    const float4 sl = *reinterpret_cast<const float4*>(ss + cl * 4);
    const float4 sh = *reinterpret_cast<const float4*>(ss + kTileN + cl * 4);
    const float fl[4] = {sl.x, sl.y * (1.f / 256), sl.z, sl.w * (1.f / 256)};
    const float fh[4] = {sh.x * (1.f / 16), sh.y * (1.f / 4096),
                         sh.z * (1.f / 16), sh.w * (1.f / 4096)};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        tot[m][q] = fmaf(hi[m][q], fh[q], fmaf(lo[m][q], fl[q], tot[m][q]));
        lo[m][q] = hi[m][q] = 0.f;
      }
  }

  // this thread's totals into part[group][m][col]
  __device__ void partial(float* part) const {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      *reinterpret_cast<float4*>(part + (group() * MT + m) * kTileN +
                                 cl * 4) =
          make_float4(tot[m][0], tot[m][1], tot[m][2], tot[m][3]);
  }
};

// two exact bf16 n from the low nibbles of bytes 0 and 2 of p:
// (p & 0x000F000F) ^ 0x43084308 holds 136 + n in each half, minus 136
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t p) {
  const uint32_t v = (p & 0x000F000Fu) ^ 0x43084308u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

__device__ __forceinline__ void mma_bf16(float d[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 x on the tensor cores. Warp w: columns 32 (w & 1) + [0, 32), the
// slice w >> 1; lane (g, t) = (lane / 4, lane % 4). D^T = W^T X^T per 16
// rows: A row slots g and g + 8 are columns 4g + 2h and 4g + 2h + 1 (h: the
// two mmas of a 4-column group), k slots 2t, 2t + 1, 2t + 8, 2t + 9 are
// rows 4t .. 4t + 3; B column g is x row g. So a lane reads 4 bytes of each
// of its 4 rows, and 8 bytes of x; its D holds columns 4g .. 4g + 3 of x
// rows 2t and 2t + 1. 4 row groups a CTA (the slices).
template <int MT>
struct TcDot {
  using Act = __nv_bfloat16;
  static constexpr int kGroups = kSlices;
  // three CTAs an SM hold the 344 of a 4096 -> 11008 decode product at
  // once; one row of x takes the two-row instantiation (B holds 8 rows
  // anyway; one spilled at this register budget)
  static constexpr int kMinBlocks = MT <= 2 ? 3 : 1;
  static constexpr int kMinMT = 2;
  float lo[2][4], hi[2][4], tot[4][2];
  int g, t, c0;

  __device__ void init() {
    const int lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    c0 = ((threadIdx.x >> 5) & 1) * 32 + 4 * g;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) lo[h][i] = hi[h][i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) tot[c][0] = tot[c][1] = 0.f;
  }
  __device__ static int slice() { return threadIdx.x >> 6; }
  __device__ int group() const { return slice(); }

  template <bool XS>
  __device__ void consume(const Slice& s, const __nv_bfloat16* x, int xst,
                          int gsz, int mrows) {
#pragma unroll 1           // one 16-row block at a time: within 80 registers
    for (int rb = 0; rb < kSlice; rb += 16) {
      const int k = (XS ? s.xlo : s.kglob) + rb + 4 * t;
      uint2 bl = make_uint2(0u, 0u), bh = make_uint2(0u, 0u);
      if (g < MT && (XS || g < mrows)) {
        bl = *reinterpret_cast<const uint2*>(x + g * xst + k);
        bh = *reinterpret_cast<const uint2*>(x + g * xst + k + gsz);
      }
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const uint32_t*>(
            s.st + swz(s.row0 + rb + 4 * t + i, c0));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // bytes 2h and 2h + 1 of rows (4t, 4t + 1) and (4t + 2, 4t + 3)
        const uint32_t s0 = 0x4400u + 0x2222u * h;
        const uint32_t s1 = s0 + 0x1111u;
        const uint32_t p0 = __byte_perm(w[0], w[1], s0);
        const uint32_t p1 = __byte_perm(w[0], w[1], s1);
        const uint32_t p2 = __byte_perm(w[2], w[3], s0);
        const uint32_t p3 = __byte_perm(w[2], w[3], s1);
        mma_bf16(lo[h], nibbles_bf16(p0), nibbles_bf16(p1), nibbles_bf16(p2),
                 nibbles_bf16(p3), bl.x, bl.y);
        mma_bf16(hi[h], nibbles_bf16(p0 >> 4), nibbles_bf16(p1 >> 4),
                 nibbles_bf16(p2 >> 4), nibbles_bf16(p3 >> 4), bh.x, bh.y);
      }
    }
  }

  // D element i of mma h: column 4g + 2h + i / 2, x row 2t + i % 2
  __device__ void fold(const float* ss) {
    const float4 sl = *reinterpret_cast<const float4*>(ss + c0);
    const float4 sh = *reinterpret_cast<const float4*>(ss + kTileN + c0);
    const float fl[4] = {sl.x, sl.y, sl.z, sl.w};
    const float fh[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 2 * h + i / 2;
        tot[c][i % 2] = fmaf(hi[h][i], fh[c],
                             fmaf(lo[h][i], fl[c], tot[c][i % 2]));
        lo[h][i] = hi[h][i] = 0.f;
      }
  }

  __device__ void partial(float* part) const {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 2 * t + e;
      if (m < MT)
        *reinterpret_cast<float4*>(part + (group() * MT + m) * kTileN + c0) =
            make_float4(tot[0][e], tot[1][e], tot[2][e], tot[3][e]);
    }
  }
};

template <template <int> class Dot, int MT, int VEC, bool XS>
__global__ void __launch_bounds__(kThreads, Dot<MT>::kMinBlocks)
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
  Act* out = static_cast<Act*>(a.out);
  for (int i = e0 + threadIdx.x; i < e1; i += kThreads) {
    const int row = m0 + i / kTileN;
    const int n = n0 + i % kTileN;
    if (row < a.m && n < a.n) {
      float s = 0.f;
      for (int q = 0; q < a.cluster; ++q)
        s += cluster.map_shared_rank(red, q)[i];
      out[(long long)row * a.n + n] = grove::from_f<Act>(s);
    }
  }
  cluster.sync();                  // no rank leaves while its tile is read
}

template <template <int> class Dot, int MT, int VEC, bool XS>
int run(const Int4Args& a, cudaStream_t st) {
  auto kernel = int4_matmul_kernel<Dot, MT, VEC, XS>;
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
template <template <int> class Dot, int MT>
int run_mt(const Int4Args& a, int vec, int staged, cudaStream_t st) {
  if (!staged)
    return vec == 4 ? run<Dot, MT, 4, false>(a, st)
                    : (int)cudaErrorInvalidValue;
  return vec == 16 ? run<Dot, MT, 16, true>(a, st)
                   : run<Dot, MT, 4, true>(a, st);
}

template <template <int> class Dot>
int run_dot(const Int4Args& a, int mt, int vec, int staged,
            cudaStream_t st) {
  switch (mt) {
    case 1:
      if constexpr (Dot<8>::kMinMT == 1)
        return run_mt<Dot, 1>(a, vec, staged, st);
      return (int)cudaErrorInvalidValue;
    case 2: return run_mt<Dot, 2>(a, vec, staged, st);
    case 4: return run_mt<Dot, 4>(a, vec, staged, st);
    case 8: return run_mt<Dot, 8>(a, vec, staged, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The plan's fields (ops/int4_matmul.py `_plan`): mt rows of x per CTA (1,
// 2, 4 or 8), cluster ranks splitting the super-groups, vec bytes per
// weight copy (16, or 4), staged (x copied into shared memory, 16-byte
// aligned; else read from global memory, 8-byte aligned). dtype 0 fp32
// (SIMT), 1 bf16 (tensor cores).
extern "C" int grove_int4_matmul(const void* x, const void* wp,
                                 const float* scale, void* out, int m, int k,
                                 int n, int g, int mt, int cluster, int vec,
                                 int staged, int dtype, void* stream) {
  const int xbytes = dtype == 0 ? 4 : 2;
  if (g <= 0 || g % kSlice != 0 || k <= 0 || k % (2 * g) != 0 || n <= 0 ||
      n % 4 != 0 || (vec != 4 && vec != 16) || (vec == 16 && n % 16 != 0) ||
      m <= 0 || mt < 1 || (m + mt - 1) / mt > 65535 || cluster < 1 ||
      cluster > kMaxCluster || cluster > k / (2 * g) ||
      (dtype != 0 && dtype != 1) ||
      (vec == 16 && ((uintptr_t)wp % 16 || (uintptr_t)scale % 16)) ||
      (uintptr_t)x % (staged ? 16 : 8))
    return (int)cudaErrorInvalidValue;
  Int4Args a;
  a.x = x;
  a.wp = static_cast<const int8_t*>(wp);
  a.scale = scale;
  a.out = out;
  a.m = m;
  a.k = k;
  a.n = n;
  a.g = g;
  a.supers = k / (2 * g);
  a.cluster = cluster;
  a.xstride = (a.supers + cluster - 1) / cluster * 2 * g;
  if (smem_bytes(mt, staged ? a.xstride : 0, xbytes) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_dot<SimtDot>(a, mt, vec, staged, st);
  return run_dot<TcDot>(a, mt, vec, staged, st);
}
