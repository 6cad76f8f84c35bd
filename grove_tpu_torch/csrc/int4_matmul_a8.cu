// K7b: W4A8 matmul, per-token int8 activations against group-pair packed
// int4 weights (the W4A8 LLaMA's decode projections).
//
// Replaces grove_tpu/ops/int4_matmul.py:_kernel_a8 (its pallas_call at :372,
// reached through int4_matmul_a8, :340), which Int4Dense takes for fewer
// than 64 rows with act_quant (models/layers.py:257-262): every projection
// of every decode step of the W4A8 LLaMA-7B, at M = 2 and (K, N) =
// (4096, 4096), (4096, 11008), (11008, 4096), and the fused widths.
//
//   out[m, n] = sx[m] * sum_g scale[g, n] * sum_{k in g} xq[m, k] * q4[k, n]
//
// xq (M, K) int8 with sx (M, 1) fp32; wp (K/2, N) int8 and scale (K/G, N)
// fp32 as K7a's (int4_matmul.cuh). Each group's sum of products is exact in
// int32, times the group's scale in fp32, added into an fp32 sum in group
// order; sx applies at the store, in the output's dtype (bf16 or fp32).
//
// Bound on the H100: device-memory bytes of the weights, 0.5 B per weight
// plus the group scales (8.9 MB for a 4096 x 4096 projection), read once
// per call; the activations are a few KB. The kernel is K7a's template
// (int4_matmul.cuh: one launch, no scratch; K split over a thread-block
// cluster of min(2, K / 2G) ranks by K and G alone, so a fused projection
// sums each column as its unfused part does; a ring of 4 stages of 128
// packed rows x 64 columns fed by 16-byte cp.async; the ranks' fp32 tiles
// added through distributed shared memory in rank order), instantiated over
// an int8 Dot (I8Dot) on the tensor cores:
//   * each warp takes a 32-row slice of a stage and 32 columns, and runs
//     mma.sync m16n8k32 s8 x s8 -> s32 on the transposed product: the
//     weights as the A operand (16 columns x the slice's 32 rows), up to 8
//     rows of xq as B (staged in shared memory as they come);
//   * a lane reads 4 bytes (4 columns) of 8 rows, transposes each 4 x 4
//     block of bytes with PRMT so that a register holds 4 consecutive k of
//     one column, and widens the nibbles to exact int8 by feeding 16 n, the
//     TPU kernel's own device: w & 0xF0F0F0F0 for the high plane, (w << 4)
//     & 0xF0F0F0F0 for the low one (one LOP3, or a shift and a LOP3);
//   * the 1/16 folds into the scale: (float)(16 s) * (scale / 16) is
//     exactly s * scale for |16 s| < 2^24 (G <= 512), the scale / 16 exact,
//     as grove_tpu/ops/int4_matmul.py:115-121 does. The group's int32 sums
//     are exact, so the warps of a slice may hold them in any order; each
//     is scaled and folded into the warp's fp32 totals in group order, the
//     slices' totals added in slice order, the ranks' in rank order.
// About 1.8 instructions a weight byte (8 shared loads of weights and 4 of
// x, 16 PRMT, 24 widening ops and 4 mma for 32 bytes a lane), against
// K7a's ~3.6.
//
// The design it replaces made two launches: a partial kernel over a
// grid split of K chosen from the number of column tiles, writing fp32
// (ksplit, M, N) scratch that a second kernel added, with plain 4-byte loads
// consumed at once, __dp4a after a 4-op sign extension of each nibble
// plane, and shared-memory atomics a super-group. Its split made a fused
// projection sum in another order than its unfused parts, and few bytes
// were in flight an SM.

#include "int4_matmul.cuh"

using namespace int4mm;

namespace {

// the 4 x 4 byte transpose: in r[j] byte c is (row j, column c); out[c]
// byte j is the same value
__device__ __forceinline__ void transpose4(const uint32_t r[4],
                                           uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

constexpr uint32_t kHigh = 0xF0F0F0F0u;

// the four low / high nibbles of w as 16 n, each an exact int8
__device__ __forceinline__ uint32_t lo16(uint32_t w) {
  return (w << 4) & kHigh;
}
__device__ __forceinline__ uint32_t hi16(uint32_t w) { return w & kHigh; }

__device__ __forceinline__ void mma_s8(int d[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// int8 x on the tensor cores. Warp w: columns 32 (w & 1) + [0, 32), the
// slice w >> 1; lane (g, t) = (lane / 4, lane % 4), c0 = its first column.
// D^T = W^T X^T over the slice's 32 rows: A row slots g and g + 8 are
// columns c0 + 2h and c0 + 2h + 1 (h: the two mmas of the lane's 4
// columns); k slot j is the slice's row j, so a0 / a1 hold rows 4t .. 4t + 3
// and a2 / a3 rows 16 + 4t .. 16 + 4t + 3 of the two columns; B column g is
// x row g, b0 / b1 its k 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3 (4 bytes
// each). D element i of mma h: column c0 + 2h + i / 2, x row 2t + i % 2,
// as K7a's TcDot. 4 row groups a CTA (the slices).
template <int MT>
struct I8Dot {
  using Act = int8_t;
  static constexpr int kGroups = kSlices;
  // three CTAs an SM hold the 344 of a 4096 -> 11008 decode product at
  // once (two rows of x, 16-byte copies, x staged); the edge shapes'
  // instantiations (4-byte copies, x from global memory) spilled at that
  // budget and take two
  static constexpr int min_blocks(int vec, bool xs) {
    return MT > 2 ? 1 : vec == 16 && xs ? 3 : 2;
  }
  static constexpr int kMinMT = 2;     // B holds 8 rows anyway
  static constexpr bool kRowScale = true;
  int lo[2][4], hi[2][4];              // the two groups' int32 sums of 16 s
  float tot[4][2];
  int g, t, c0;

  __device__ void init() {
    const int lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    c0 = ((threadIdx.x >> 5) & 1) * 32 + 4 * g;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) lo[h][i] = hi[h][i] = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) tot[c][0] = tot[c][1] = 0.f;
  }
  __device__ static int slice() { return threadIdx.x >> 6; }
  __device__ int group() const { return slice(); }

  // the B operands just before their mmas, the low plane's first: within
  // the 80 registers of three CTAs an SM
  template <bool XS>
  __device__ void consume(const Slice& s, const int8_t* x, int xst, int gsz,
                          int mrows) {
    const int8_t* xr = x + g * xst + (XS ? s.xlo : s.kglob) + 4 * t;
    const bool xok = g < MT && (XS || g < mrows);
    uint32_t cr[4], cu[4];     // columns c0 + j: rows 4t .., 16 + 4t ..
    {
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint32_t*>(
            s.st + swz(s.row0 + 4 * t + i, c0));
      transpose4(r, cr);
    }
    {
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        u[i] = *reinterpret_cast<const uint32_t*>(
            s.st + swz(s.row0 + 16 + 4 * t + i, c0));
      transpose4(u, cu);
    }
    {
      const uint32_t b0 = xok ? *reinterpret_cast<const uint32_t*>(xr) : 0u;
      const uint32_t b1 =
          xok ? *reinterpret_cast<const uint32_t*>(xr + 16) : 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mma_s8(lo[h], lo16(cr[2 * h]), lo16(cr[2 * h + 1]), lo16(cu[2 * h]),
               lo16(cu[2 * h + 1]), b0, b1);
    }
    const uint32_t b0 =
        xok ? *reinterpret_cast<const uint32_t*>(xr + gsz) : 0u;
    const uint32_t b1 =
        xok ? *reinterpret_cast<const uint32_t*>(xr + gsz + 16) : 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mma_s8(hi[h], hi16(cr[2 * h]), hi16(cr[2 * h + 1]), hi16(cu[2 * h]),
             hi16(cu[2 * h + 1]), b0, b1);
  }

  // the two groups' sums of 16 s, times their scales / 16 (exact), into
  // the totals, the low group first
  __device__ void fold(const float* ss) {
    const float4 sl = *reinterpret_cast<const float4*>(ss + c0);
    const float4 sh = *reinterpret_cast<const float4*>(ss + kTileN + c0);
    const float fl[4] = {sl.x * 0.0625f, sl.y * 0.0625f, sl.z * 0.0625f,
                         sl.w * 0.0625f};
    const float fh[4] = {sh.x * 0.0625f, sh.y * 0.0625f, sh.z * 0.0625f,
                         sh.w * 0.0625f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 2 * h + i / 2;
        tot[c][i % 2] = fmaf((float)hi[h][i], fh[c],
                             fmaf((float)lo[h][i], fl[c], tot[c][i % 2]));
        lo[h][i] = hi[h][i] = 0;
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

}  // namespace

// The plan's fields: int4_matmul.cuh `make_args` (ops/int4_matmul.py
// `_plan` with one byte of x). G at most 512, so that a group's sum of 16 s
// stays below 2^24. dtype: the output's, 0 fp32 or 1 bf16.
extern "C" int grove_int4_matmul_a8(const void* xq, const float* sx,
                                    const void* wp, const float* scale,
                                    void* out, int m, int k, int n, int g,
                                    int mt, int cluster, int vec, int staged,
                                    int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || g > 512) return (int)cudaErrorInvalidValue;
  Int4Args a;
  const int bad = make_args(a, xq, wp, scale, sx, out, m, k, n, g, mt,
                            cluster, vec, staged, 1);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_dot<I8Dot, float>(a, mt, vec, staged, st);
  return run_dot<I8Dot, __nv_bfloat16>(a, mt, vec, staged, st);
}
