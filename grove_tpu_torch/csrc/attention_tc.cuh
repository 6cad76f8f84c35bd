// Tensor-core forward body of the hand-written attention kernels of
// grove_tpu_torch, beside the SIMT body of attention_core.cuh.
//
// It serves seven TPU kernels, for bf16 inputs at head dims 64, 80 and 128:
//   * K10, grove_tpu/ops/attention.py:66 `_flash_kernel` (flash_attention.cu,
//     `grove_flash_attention_tc`): causal or not, Sq and Sk ragged;
//   * K3, grove_tpu/ops/attention.py:350 `_grouped_plain_kernel`
//     (grouped_plain_attention.cu, `grove_grouped_plain_attention_tc`):
//     non-causal self-attention at CLIP's ragged S = 577;
//   * K4, grove_tpu/ops/flash_backward.py:61 `_fwd_kernel`
//     (flash_forward_lse.cu, `grove_flash_forward_lse_tc`): causal
//     self-attention with the log-sum-exp output that K4b reads;
//   * K2, grove_tpu/ops/sam_attention.py:156 `_grouped_kernel`
//     (sam_global_attention.cu, `grove_sam_global_attention_tc`): SAM's
//     global attention at D = 80 with the decomposed rel-pos bias;
//   * K9's forward, grove_tpu/ops/sam_attention_bwd.py:243 `_fwd_kernel`
//     (relpos_flash_attention.cu, `grove_relpos_flash_fwd_lse_tc`): K2's
//     contract with K4's LSE, which K9's dq and dkv read;
//   * K1 and K1q, grove_tpu/ops/sam_attention.py:537 `_grouped_kernel_v3`
//     (sam_window_attention.cu, `grove_sam_window_attention_tc` and
//     `grove_sam_window_attention_q8_tc`): SAM's windowed attention on the
//     unsplit qkv, with the packed term table, the all-underflow contract
//     and, for K1q, the int8 output;
//   * K5, grove_tpu/ops/attention.py:197 `_prefill_kernel`
//     (prefill_attention.cu, `grove_prefill_attention_tc`): causal
//     self-attention in the raw (B, S, H D) projection layout with a
//     per-batch left pad (LLaMA's int8-cache prefill).
// fp32 inputs and the head dim 8 keep the SIMT body, and so do K11-K13 (no
// model path). The backward of K9 has its own tensor-core body
// (attention_bwd_tc.cuh).
//
// Contract, the part of AttnArgs that these entries use:
//   * q, k, v and out in the (B, S, H, D) layout with element strides, bf16,
//     every row 16-byte aligned; fp32 accumulation. The strides let K1 read
//     q, k and v in place from the unsplit (nW, S, 3C) qkv: (S 3C, 3C, D),
//     k at lane offset C and v at 2C (sam_window_attention.cu);
//   * a key count Sk that may differ from S (0 means Sk = S);
//   * an optional causal mask, top-left aligned: row i sees keys 0..i,
//     whatever Sk - S is (the TPU kernel's mask);
//   * an optional per-batch left pad (`pad`, (B,) int32 on the card, K5):
//     keys below pad[b] are masked except each row's own key, so a row
//     inside the pad attends to itself only. A tile that starts below the
//     pad takes the per-element mask; a tile wholly inside the pad that
//     holds none of a warpgroup's own keys is skipped by that warpgroup,
//     and the tiles past the pad keep the unmasked fast path;
//   * an optional LSE output (`lse`, natural log, (B, H, S) fp32):
//     lse_i = (m_i + log2(max(l_i, 1e-30))) * ln 2, with m the running max
//     in log2 units and l the row sum, as attention_core.cuh writes it;
//   * an optional decomposed rel-pos bias (the BIAS instantiations only):
//     bias_ij = rel_h[i, j / gw] + rel_w[i, j % gw] from (S, gh) and
//     (S, gw) term tables of the input dtype, read through generic strides
//     (K2's and K9's (B, H, S, g) tables, or K1's packed (nW, S, H (gh + gw))
//     one, per head [rel_h | rel_w]), added in fp32 as
//     (rel_h + rel_w) * log2(e) after the scale * log2(e) product, the
//     order of the SIMT body and of the TPU K2 (fp32 bias terms on fp32
//     scaled logits);
//   * the ragged edge in the kernel: keys at or past Sk are masked, rows at
//     or past S are not written, and no caller pads;
//   * with `zero_underflow` (K1, K1q) the TPU K1's all-underflow contract:
//     a row whose running max m (log2 units, after the scale and the bias)
//     lies below kExp2Shift - 126 is written as exact zeros, as the TPU
//     kernel's EXP2_SHIFT softmax gives there (attention_core.cuh);
//   * an int8 output (the Q8 instantiations, K1q): clip(rint(out *
//     *out_inv), -127, 127), out_inv a (1,) fp32 the kernel reads on the
//     card, so the host never waits for it; out's strides count bytes, and
//     every head row (D bytes) must start 16-byte aligned, as it does for D
//     64, 80 and 128 in a contiguous (nW, S, C) output.
//
// Bound on an H100: operations. Each (batch, head) does 4 * S * Sk * D
// flops (half of that for causal K4 and K10) on 2 bytes per element of q,
// k, v and out, so at these shapes the work lies far above the card's
// balance point and only the bf16 tensor cores (989 TFLOP/s dense, through
// wgmma) can approach the bound. The design, for that:
//   * a block is two consumer warpgroups (256 threads) over 128 query rows
//     of one (batch, head), 64 rows each; the Q tile is staged in shared
//     memory once;
//   * K and V tiles of 64 keys stream through a two-stage ring in shared
//     memory, filled by every thread with 16-byte cp.async copies (rows past
//     Sk zero-filled) into the 128-byte-swizzled layout that the wgmma
//     descriptors name; a row is cut into 64-column swizzle atoms, one at
//     D = 64 and two at D = 128 and at D = 80, whose second atom holds 16
//     columns and 48 that are never written nor read (no instruction spans
//     them: Q.K^T's fifth k16 step reads that atom's first 32 bytes, and
//     P.V's m64n80k16 its first 16 columns); each buffer is 1024-byte
//     aligned. A proxy fence after the copies makes them visible to the
//     tensor cores, which read through the async proxy;
//   * S = Q.K^T is wgmma m64n64k16 with both operands in shared memory,
//     K-major (D contiguous), D / 16 instructions per tile. The scores are
//     scaled in fp32 by scale * log2(e) after the product (a q pre-scaled
//     in bf16 would add a rounding that neither the SIMT body nor the TPU
//     kernel has), biased (K2), masked to -inf only on the tiles that cross
//     Sk, the causal diagonal or the pad, and folded into an online softmax (running
//     max and sum in registers, exp2f); a row's reductions run over the 4
//     threads that share it in the accumulator fragment;
//   * the bias: the block's 128 rows of both term tables are staged once in
//     shared memory, in the input dtype, with ordinary loads (a 14-wide grid
//     row is 28 bytes, no 16-byte copy); a row of the table is (gh + gw)
//     rounded up to 64 values, and value c of row r sits at c ^ 8 (r % 8),
//     so the 8 rows of a fragment's row group fall on distinct banks. A
//     thread's 16 keys of a tile are k0 + 2 t4 + 8 j + e; their grid row and
//     column are stepped from one division per tile, not one per score;
//   * O += P.V: P, rounded to bf16 in registers, is wgmma's A operand (the
//     m64nNk16 fp32 accumulator fragment, packed pairwise to bf16x2, is the
//     register A fragment of m64k16); V is the B operand, read from shared
//     memory MN-major (D contiguous) with the transpose bit, m64n{D}k16, 4
//     instructions per 64-key tile;
//   * a causal block stops at the key tile that holds its last row, a
//     warpgroup skips the tiles wholly above its diagonal, and the grid
//     puts the (batch, head) pairs on x and the query blocks on y, reversed
//     when causal, so every pair's heaviest block is launched before any
//     lighter one and the long diagonal blocks do not form the tail (K4's
//     S = 704 gives 6 blocks over 64 pairs, 1.45 waves);
//   * the epilogue multiplies by 1 / max(l, 1e-30) in fp32 (0 for an
//     all-underflow row), converts to bf16, or to int8 after the scale, and
//     writes whole rows with 16-byte stores, only rows < S, staged through
//     the warpgroup's own rows of the Q buffer (an int8 row of D bytes in
//     its first atom, 16 columns to a chunk, under the same swizzle); the
//     LSE, where asked, is written by one thread per row.
// Two blocks share an SM, so one block's softmax overlaps the other's
// products: shared memory is 128 x W x 2 bytes of Q plus 2 x 2 x 64 x W x 2
// of K and V, with W the row's atoms x 64 columns (64 at D = 64, 128 at
// D = 80 and 128): 48 KB at D = 64 and 96 KB at D = 80 and 128; plus, with
// the bias, 128 x 64 x 2 = 16 KB of term tables at gh + gw <= 64 (SAM's
// 32 + 32, K1's 14 + 14 rounded up to 64 too); plus 1 KB to align. K1, K2
// and K9 at D = 80 thus take 113 KB, which with the 1 KB the card reserves
// a block is half of an SM's 228 KB, the carve-out asked for at launch.
// The launch bounds hold a thread to 128 registers, which every
// instantiation fits without a spill but the biased one at D = 128 (no
// model path): that one runs a block an SM with up to 255 (chip_smoke.py
// phase 2 prints ptxas's counts). A ragged last key tile runs the full
// 64-key products: at SAM's windowed S = 196 (2 query blocks, 4 key tiles,
// the last holding 4 keys; 1.71x the useful work) a last tile cut to
// m64n16k16 and one k16 step of P.V left K1 and K9's windowed forward
// within 1%, cost K4 and K10 5-11% in registers (K10 at D = 128 spilled),
// so it is not taken (PERF.md §6). Left for the next
// redesign of this body: TMA with mbarriers, a producer warp, setmaxnreg, a
// persistent grid, and a softmax that overlaps the next tile's products
// within a block.
//
// Numerics against the SIMT body: P is rounded to bf16 before P.V, as the
// TPU K3, K2 and K5 do (`p.astype(dt)`); the TPU K10 and K4 keep P in fp32.
// The row sum l, and so the LSE, is taken over the unrounded fp32 P, as the
// TPU K5 takes its denominator.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace grove {
namespace tc {

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBQ = 64 * kWarpgroups;    // query rows per block
constexpr int kBK = 64;                  // keys per tile
constexpr int kAlign = 1024;             // swizzle-atom alignment of a buffer

// 64-column swizzle atoms in a row of D columns
template <int D>
__host__ __device__ constexpr int atoms() {
  return (D + 63) / 64;
}

// bytes of a bf16 tile of `rows` rows by D columns: atoms<D>() atoms of
// `rows` x 128 bytes
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return (uint32_t)rows * atoms<D>() * 128;
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)tile_bytes<D>(kBQ) + 4 * (size_t)tile_bytes<D>(kBK) + kAlign;
}

// values in a row of the staged rel-pos term tables: gh + gw rounded up to
// 64, so the XOR of `bias_col` stays inside the row
__host__ __device__ inline int bias_stride(int gh, int gw) {
  return (gh + gw + 63) / 64 * 64;
}

// where value c of row r of the term tables sits within its row
__device__ __forceinline__ int bias_col(int r, int c) {
  return c ^ ((r & 7) << 3);
}

inline size_t bias_bytes(const AttnArgs& a) {
  return a.rh != nullptr ? (size_t)kBQ * bias_stride(a.gh, a.gw) * 2 : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk j (columns 8j..8j+7) of row r in a tile of
// `rows` rows: the columns are cut into 64-wide atoms, each `rows` x 128
// bytes, and within an 8-row group the chunk index is XORed with r % 8 (the
// 128-byte swizzle, which the hardware applies on address bits [4, 7) by
// bits [7, 10)).
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int j) {
  return (uint32_t)((j >> 3) * rows * 128 + r * 128 +
                    (((j & 7) ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma that reads or writes them.
template <int N>
__device__ __forceinline__ void fence_operands(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

__device__ __forceinline__ void warpgroup_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// clip(rint(x), -127, 127) of two values as two int8 in one 16-bit word,
// `lo` in the low byte (the lower address)
__device__ __forceinline__ uint16_t pack_int8(float lo, float hi) {
  const int a = (int)fminf(fmaxf(rintf(lo), -127.f), 127.f);
  const int b = (int)fminf(fmaxf(rintf(hi), -127.f), 127.f);
  return (uint16_t)((a & 0xFF) | ((b & 0xFF) << 8));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B from shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}

// D[64 x 80] += A[64 x 16] . B[16 x 80], A from registers, B from shared
// memory MN-major (transposed): a full 64-column atom and the first 16
// columns of the next
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers, B from shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}


template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_n64(d, a, db, 1);
  else if constexpr (D == 80)
    wgmma_rs_n80(d, a, db, 1);
  else
    wgmma_rs_n128(d, a, db, 1);
}

// Copy rows row0..row0+rows-1 of a (row_stride)-strided bf16 matrix of D
// columns into a swizzled tile at shared address `dst`, every thread of the
// block taking 16-byte chunks in turn; rows at or past `limit` are
// zero-filled (source size 0, nothing read).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rows, int limit, int tid) {
  constexpr int C = D / 8;                 // 16-byte chunks per row
  for (int i = tid; i < rows * C; i += kThreads) {
    const int r = i / C;
    const int j = i - r * C;
    const int row = row0 + r;
    const bool ok = row < limit;
    const __nv_bfloat16* g = ok ? src + row * row_stride + j * 8 : src;
    cp_async16(dst + swizzled(rows, r, j), g, ok);
  }
}

// Stage rows q0..q0+kBQ-1 of the (S, gh) and (S, gw) term tables of one
// (batch, head) in shared memory: row r holds [rel_h | rel_w], value c at
// r * stride + bias_col(r, c); rows at or past S hold zeros.
__device__ __forceinline__ void load_bias(__nv_bfloat16* dst,
                                          const AttnArgs& a, int b, int h,
                                          int q0, int tid) {
  const int gs = a.gh + a.gw;
  const int stride = bias_stride(a.gh, a.gw);
  const __nv_bfloat16* rh = static_cast<const __nv_bfloat16*>(a.rh) +
                            b * a.rhs.b + h * a.rhs.h;
  const __nv_bfloat16* rw = static_cast<const __nv_bfloat16*>(a.rw) +
                            b * a.rws.b + h * a.rws.h;
  for (int i = tid; i < kBQ * gs; i += kThreads) {
    const int r = i / gs;
    const int c = i - r * gs;
    const int row = q0 + r;
    __nv_bfloat16 x = __float2bfloat16(0.f);
    if (row < a.S)
      x = c < a.gh ? rh[row * a.rhs.s + c] : rw[row * a.rws.s + (c - a.gh)];
    dst[r * stride + bias_col(r, c)] = x;
  }
}

// s[4j + e]: row R0 (e < 2) or R0 + 8, key key0 + 8 j + (e & 1), with
// key0 = k0 + 2 t4. Adds (rel_h[row, key / gw] + rel_w[row, key % gw]) *
// log2(e) to each score, already scaled by scale * log2(e); `row0` and
// `row1` are the two rows of the staged tables. R0 % 8 = g, so both rows
// share the XOR of `bias_col`, `sw`. The two keys of a pair share their
// rel_h value unless the first ends a grid row (never at an even gw).
// Keys past the grid (masked after this) read its last row of rel_h.
__device__ __forceinline__ void add_bias(float (&s)[32],
                                         const __nv_bfloat16* row0,
                                         const __nv_bfloat16* row1, int sw,
                                         int gh, int gw, int key0) {
  int kh = key0 / gw;                      // grid row and column of key0 + 8j
  int kw = key0 - kh * gw;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool wrap = kw + 1 == gw;        // key0 + 8j + 1 starts a grid row
    const int hA = min(kh, gh - 1) ^ sw;
    const int hB = min(kh + 1, gh - 1) ^ sw;
    const int wA = (gh + kw) ^ sw;
    const int wB = (gh + (wrap ? 0 : kw + 1)) ^ sw;
    const float a0 = __bfloat162float(row0[hA]);
    const float a1 = __bfloat162float(row1[hA]);
    const float b0 = wrap ? __bfloat162float(row0[hB]) : a0;
    const float b1 = wrap ? __bfloat162float(row1[hB]) : a1;
    s[4 * j + 0] += (a0 + __bfloat162float(row0[wA])) * kLog2e;
    s[4 * j + 1] += (b0 + __bfloat162float(row0[wB])) * kLog2e;
    s[4 * j + 2] += (a1 + __bfloat162float(row1[wA])) * kLog2e;
    s[4 * j + 3] += (b1 + __bfloat162float(row1[wB])) * kLog2e;
    kw += 8;
    while (kw >= gw) {
      kw -= gw;
      ++kh;
    }
  }
}

template <int D, bool BIAS, bool Q8>
__device__ __forceinline__ void attention_block_tc(const AttnArgs& a) {
  static_assert(D == 64 || D == 80 || D == 128,
                "the tensor-core body takes D 64, 80, 128");
  constexpr int KSTEPS = D / 16;           // k16 steps of Q.K^T
  constexpr int NO = D / 2;                // O accumulator floats a thread
  constexpr uint32_t T = tile_bytes<D>(kBK);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t sKV = sQ + tile_bytes<D>(kBQ);   // stage s: K, then V
  uint8_t* stage = smem_raw + (sQ - raw);         // sQ as a generic pointer
  __nv_bfloat16* sR = reinterpret_cast<__nv_bfloat16*>(
      stage + tile_bytes<D>(kBQ) + 4 * T);        // the term tables (BIAS)

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                 // warpgroup
  const int tw = tid & 127;                // thread in the warpgroup
  const int warp = tw >> 5;                // warp in the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2;                 // fragment row group
  const int t4 = lane & 3;                 // thread in the row group

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int qb = a.causal ? (int)(gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qb * kBQ;
  const int qw = q0 + 64 * wg;             // this warpgroup's first row
  const int Sk = a.Sk > 0 ? a.Sk : a.S;
  const int pad = a.pad != nullptr ? a.pad[b] : 0;  // K5's left pad
  const int kend = a.causal ? min(Sk, min(a.S, q0 + kBQ)) : Sk;
  const int ntiles = (kend + kBK - 1) / kBK;
  const bool active = qw < a.S;            // warpgroup-uniform

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vs.b + h * a.vs.h;

  load_tile<D>(sQ, q, a.qs.s, q0, kBQ, a.S, tid);
  if (ntiles > 0) {
    load_tile<D>(sKV, k, a.ks.s, 0, kBK, Sk, tid);
    load_tile<D>(sKV + T, v, a.vs.s, 0, kBK, Sk, tid);
  }
  cp_async_commit();
  if constexpr (BIAS) load_bias(sR, a, b, h, q0, tid);  // read after a sync

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;    // running max, log2 units
  float l0 = 0.f, l1 = 0.f;                // this thread's part of the sum
  const float sl2 = a.scale * kLog2e;
  const int r0 = qw + 16 * warp + g;       // this thread's two rows
  const int r1 = r0 + 8;
  const uint32_t qa = sQ + wg * 64 * 128;  // the warpgroup's A rows
  const int R0 = 64 * wg + 16 * warp + g;  // the same rows in the block
  const int R1 = R0 + 8;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const uint32_t next = sKV + ((t + 1) & 1) * 2 * T;
      load_tile<D>(next, k, a.ks.s, (t + 1) * kBK, kBK, Sk, tid);
      load_tile<D>(next + T, v, a.vs.s, (t + 1) * kBK, kBK, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    const int k0 = t * kBK;
    // a warpgroup skips the tiles wholly above its diagonal, and those
    // wholly inside the pad that hold none of its rows' own keys
    if (active && !(a.causal && k0 > qw + 63) &&
        !(k0 + kBK <= pad && qw >= k0 + kBK)) {
      const uint32_t sK = sKV + (t & 1) * 2 * T;
      const uint32_t sV = sK + T;
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        wgmma_ss_n64(s,
                     descriptor(qa + (kk >> 2) * tile_bytes<64>(kBQ) + col,
                                16, 1024),
                     descriptor(sK + (kk >> 2) * tile_bytes<64>(kBK) + col,
                                16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(s);

      // s[4j + e]: row r0 (e < 2) or r1, key k0 + 8j + 2 t4 + (e & 1)
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= sl2;
      if constexpr (BIAS) {
        const int stride = bias_stride(a.gh, a.gw);
        add_bias(s, sR + R0 * stride, sR + R1 * stride, g << 3, a.gh, a.gw,
                 k0 + 2 * t4);
      }
      const bool edge = k0 + kBK > Sk || (a.causal && k0 + kBK - 1 > qw) ||
                        k0 < pad;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i];
        if (edge) {
          const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const int row = (i & 2) ? r1 : r0;
          if (key >= Sk || (a.causal && key > row) ||
              (key < pad && key != row))
            x = -INFINITY;
        }
        s[i] = x;
        if (i & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float base0 = mx0 == -INFINITY ? 0.f : mx0;
      const float base1 = mx1 == -INFINITY ? 0.f : mx1;
      const float c0 = exp2f(m0 - base0);
      const float c1 = exp2f(m1 - base1);
      m0 = mx0;
      m1 = mx1;
      l0 *= c0;
      l1 *= c1;
      uint32_t p[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          e[i] = exp2f(s[8 * kk + i] - ((i & 2) ? base1 : base0));
          if (i & 2)
            l1 += e[i];
          else
            l0 += e[i];
        }
        p[kk][0] = pack_bf16(e[0], e[1]);  // row r0, keys 16kk + 2t4
        p[kk][1] = pack_bf16(e[2], e[3]);  // row r1
        p[kk][2] = pack_bf16(e[4], e[5]);  // row r0, keys 16kk + 8 + 2t4
        p[kk][3] = pack_bf16(e[6], e[7]);  // row r1
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? c1 : c0;
      fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(o, p[kk],
                    descriptor(sV + kk * 16 * 128, tile_bytes<64>(kBK),
                               1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(o);
    }
    __syncthreads();                       // the stage may be refilled
  }
  if (ntiles == 0) {                       // Q's copies, which no tile waited
    cp_async_wait<0>();
    __syncthreads();
  }
  if (!active) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float safe0 = fmaxf(l0, 1e-30f);
  const float safe1 = fmaxf(l1, 1e-30f);
  if (a.lse != nullptr && t4 == 0) {       // one thread per row
    float* lse = a.lse + (long long)bh * a.S;
    if (r0 < a.S) lse[r0] = (m0 + log2f(safe0)) * kLn2;
    if (r1 < a.S) lse[r1] = (m1 + log2f(safe1)) * kLn2;
  }
  // the TPU K1's all-underflow rows (zero_underflow) come out as zeros
  const float floor2 = kExp2Shift - 126.f;
  const float inv0 = a.zero_underflow && m0 < floor2 ? 0.f : 1.f / safe0;
  const float inv1 = a.zero_underflow && m1 < floor2 ? 0.f : 1.f / safe1;

  // stage the warpgroup's 64 rows in its own rows of the Q buffer, whose
  // last reader (this warpgroup's wgmma) has completed
  fence_proxy_async();
  const long long obase = b * a.os.b + h * a.os.h;
  if constexpr (Q8) {
    // int8 rows of D bytes in the first atom: chunk j holds columns
    // 16j..16j+15, under the swizzle of `swizzled`
    const float qs = *a.out_inv;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const uint32_t within = col & 15;
      *reinterpret_cast<uint16_t*>(stage + swizzled(kBQ, R0, col >> 4) +
                                   within) =
          pack_int8(o[4 * j] * inv0 * qs, o[4 * j + 1] * inv0 * qs);
      *reinterpret_cast<uint16_t*>(stage + swizzled(kBQ, R1, col >> 4) +
                                   within) =
          pack_int8(o[4 * j + 2] * inv1 * qs, o[4 * j + 3] * inv1 * qs);
    }
    warpgroup_barrier(wg);
    int8_t* out = static_cast<int8_t*>(a.o) + obase;
    constexpr int C = D / 16;
    for (int i = tw; i < 64 * C; i += 128) {
      const int rl = i / C;
      const int j = i - rl * C;
      const int row = qw + rl;
      if (row < a.S)
        *reinterpret_cast<uint4*>(out + row * a.os.s + j * 16) =
            *reinterpret_cast<const uint4*>(stage +
                                            swizzled(kBQ, 64 * wg + rl, j));
    }
  } else {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const uint32_t within = (col & 7) * 2;
      *reinterpret_cast<uint32_t*>(stage + swizzled(kBQ, R0, col >> 3) +
                                   within) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(stage + swizzled(kBQ, R1, col >> 3) +
                                   within) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    warpgroup_barrier(wg);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + obase;
    constexpr int C = D / 8;
    for (int i = tw; i < 64 * C; i += 128) {
      const int rl = i / C;
      const int j = i - rl * C;
      const int row = qw + rl;
      if (row < a.S)
        *reinterpret_cast<uint4*>(out + row * a.os.s + j * 8) =
            *reinterpret_cast<const uint4*>(stage +
                                            swizzled(kBQ, 64 * wg + rl, j));
    }
  }
}

// Whether every base pointer and row stride keeps the rows 16-byte aligned,
// as the 16-byte copies and stores need: bf16 inputs, and an output of
// `out_bytes` bytes an element (2, or 1 for int8), its strides counted in
// bytes.
inline bool aligned16(const AttnArgs& a, int out_bytes) {
  const void* p[] = {a.q, a.k, a.v, a.o};
  for (const void* x : p)
    if (reinterpret_cast<uintptr_t>(x) % 16) return false;
  const Strides st[] = {a.qs, a.ks, a.vs};
  for (const Strides& s : st)
    if (s.b % 8 || s.s % 8 || s.h % 8) return false;
  const Strides& o = a.os;
  return (o.b * out_bytes) % 16 == 0 && (o.s * out_bytes) % 16 == 0 &&
         (o.h * out_bytes) % 16 == 0;
}

// Launch one instantiation on `stream`, opted into its dynamic shared
// memory (with the term tables for a biased call) and into the largest
// shared-memory carve-out; returns cudaGetLastError() so a refused launch
// is reported. The grid: (batch, head) pairs on x, query blocks on y.
template <int D, typename Kernel>
inline int launch(Kernel kernel, const AttnArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>() + bias_bytes(a);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B * a.H, (a.S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace grove

// Define the __global__ instantiations of one tensor-core entry point and a
// host dispatcher `NAME_tc_dispatch` over (dtype, head_dim): bf16 (dtype 1)
// at D 64, 80 or 128, with 16-byte-aligned rows, with the rel-pos term
// tables exactly when BIAS is true and an int8 output (`out_inv` set)
// exactly when Q8 is; anything else is refused with cudaErrorInvalidValue.
// The launch bounds ask for two blocks an SM (128 registers a thread), but
// one for the biased body at D = 128, whose registers (O alone is 64 a
// thread) do not fit 128 beside the bias's; no model path runs it.
#define GROVE_ATTENTION_TC_ENTRY(NAME, BIAS, Q8)                              \
  template <int D>                                                            \
  __global__ void __launch_bounds__(grove::tc::kThreads,                      \
                                    ((BIAS) && D == 128) ? 1 : 2)             \
      NAME##_tc_kernel(const grove::AttnArgs a) {                             \
    grove::tc::attention_block_tc<D, BIAS, Q8>(a);                            \
  }                                                                           \
  static int NAME##_tc_dispatch(const grove::AttnArgs& a, int dtype, int d,   \
                                cudaStream_t st) {                            \
    if (dtype != 1 || !grove::tc::aligned16(a, (Q8) ? 1 : 2) ||               \
        (a.rh != nullptr) != (BIAS) || ((BIAS) && (a.gh < 1 || a.gw < 1)) ||  \
        (a.out_inv != nullptr) != (Q8))                                       \
      return (int)cudaErrorInvalidValue;                                      \
    if (d == 64) return grove::tc::launch<64>(NAME##_tc_kernel<64>, a, st);   \
    if (d == 80) return grove::tc::launch<80>(NAME##_tc_kernel<80>, a, st);   \
    if (d == 128) return grove::tc::launch<128>(NAME##_tc_kernel<128>, a, st);\
    return (int)cudaErrorInvalidValue;                                        \
  }

