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
// read once; x and out are a few KB. The kernel is the template of
// int4_matmul.cuh (one launch, K split over a cluster by K and G alone,
// a 4-stage cp.async ring, the ranks' tiles added through distributed shared
// memory in rank order), instantiated here over two Dots:
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
// whether x is staged.

#include "int4_matmul.cuh"

using namespace int4mm;

namespace {

// fp32 x: two warps a slice, a lane 4 columns of 8 of its 32 rows (two
// rows a load: 16 lanes a 64-byte row, neighbouring rows in other banks);
// 16 row groups a CTA, added in order at the end.
template <int MT>
struct SimtDot {
  using Act = float;
  static constexpr int kGroups = 16;
  static constexpr int min_blocks(int, bool) {   // CTAs an SM
    return MT <= 2 ? 2 : 1;
  }
  static constexpr int kMinMT = 1;
  static constexpr bool kRowScale = false;
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
  static constexpr int min_blocks(int, bool) { return MT <= 2 ? 3 : 1; }
  static constexpr int kMinMT = 2;
  static constexpr bool kRowScale = false;
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

}  // namespace

// The plan's fields: int4_matmul.cuh `make_args`. dtype 0 fp32 (SIMT),
// 1 bf16 (tensor cores).
extern "C" int grove_int4_matmul(const void* x, const void* wp,
                                 const float* scale, void* out, int m, int k,
                                 int n, int g, int mt, int cluster, int vec,
                                 int staged, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Int4Args a;
  const int bad = make_args(a, x, wp, scale, nullptr, out, m, k, n, g, mt,
                            cluster, vec, staged, dtype == 0 ? 4 : 2);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_dot<SimtDot, float>(a, mt, vec, staged, st);
  return run_dot<TcDot, __nv_bfloat16>(a, mt, vec, staged, st);
}
