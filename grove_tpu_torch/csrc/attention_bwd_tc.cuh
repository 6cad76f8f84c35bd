// Tensor-core backward body of the hand-written attention kernels of
// grove_tpu_torch, beside the SIMT body of attention_bwd_core.cuh.
//
// It serves four TPU kernels, for bf16 inputs at head dims 64, 80 and 128:
//   * K9's dkv, grove_tpu/ops/sam_attention_bwd.py:152 `_dkv_kernel`
//     (relpos_flash_attention.cu, `grove_relpos_flash_dkv_tc`): dk and dv of
//     SAM's decomposed rel-pos attention (`dkv_block_tc`, BIAS);
//   * K9's dq, `sam_attention_bwd.py:98` `_dq_kernel`
//     (relpos_flash_attention.cu, `grove_relpos_flash_dq_tc`): dq and the
//     per-row term gradients d_rh, d_rw (`dq_block_tc`, BIAS);
//   * K4b's dkv, grove_tpu/ops/flash_backward.py:137 `_dkv_kernel`
//     (flash_backward.cu, `grove_flash_backward_dkv_tc`): dk and dv of
//     LLaMA's causal attention, no bias (`dkv_block_tc`, CAUSAL or not);
//   * K4b's dq, `flash_backward.py:101` `_dq_kernel` (flash_backward.cu,
//     `grove_flash_backward_dq_tc`): dq of the same, no bias
//     (`dq_block_tc`, CAUSAL or not).
// All with P recomputed from the forward's LSE,
//
//   s_ij  = scale * q_i . k_j [+ rel_h[i, j / gw] + rel_w[i, j % gw]]
//   p_ij  = exp(s_ij - lse_i),   ds_ij = p_ij (dO_i . v_j - D_i)
//   dv_j  = sum_i p_ij dO_i,     dk_j = scale * sum_i ds_ij q_i
//   dq_i  = scale * sum_j ds_ij k_j,
//   d_rh[i, a] = sum_{j / gw == a} ds_ij,  d_rw[i, b] = sum_{j % gw == b} ds_ij
//
// with K9's rounding points: P rounded to bf16 before P^T.dO
// (`sam_attention_bwd.py:186`) and dS, computed from the unrounded P, before
// dS^T.Q (`:191`), dS.K and the bucket sums (`:132-139`); every product
// accumulates in fp32. The TPU K4b keeps P and dS in fp32
// (`flash_backward.py:103-170`); wgmma takes bf16 operands, so K4b's dkv
// and dq round them here too (a recorded difference, ROADMAP Queue 3).
// fp32 inputs and the head dim 8 keep the SIMT entries.
//
// Contract (BwdArgs): q, k, v, dO, dq, dk, dv in the (B, S, H, D) layout
// with element strides, bf16, every row 16-byte aligned; lse and D =
// rowsum(dO O) (B, H, S) fp32; with the bias the term tables rel_h (S, gh)
// and rel_w (S, gw) per (batch, head) in bf16 through generic strides, each
// (batch, head) block contiguous and 16-byte aligned (`tables16`, true of
// every SAM grid of the configurations; the wrappers route others to the
// SIMT entries), gh + gw <= 64 for dq; keys and queries at or past S masked
// in the kernel (no caller pads); a top-left causal mask (row i sees keys
// 0..i) only without the bias.
//
// Bound on an H100: operations, at SAM's S = 196 and 1024 and LLaMA's 704.
// dkv does 4 matmuls of 2 S^2 D flops a (batch, head) (K.Q^T, V.dO^T,
// P^T.dO, dS^T.Q; half of that causal), dq 3 (Q.K^T, dO.V^T, dS.K) and the
// bucket sums, on 2 bytes per element of q, k, v, dO and the outputs: far
// above the card's balance point, so only the bf16 tensor cores (wgmma) can
// approach it. The design, for that, shared by both loop directions:
//   * a block is two consumer warpgroups (256 threads) over 128 rows of one
//     (batch, head), 64 for each warpgroup: key rows for dkv, query rows for
//     dq. The block's own rows (K and V, or Q and dO) are staged in shared
//     memory once, in the 128-byte-swizzled layout of attention_tc.cuh;
//   * the other side streams in tiles of 64 rows through a two-stage ring
//     filled with 16-byte cp.async copies (rows past S zero-filled): Q, dO,
//     their LSE and D (4-byte cp.async) for dkv; K and V for dq;
//   * the two score products are wgmma m64n64k16 with both operands in
//     shared memory, K-major, D / 16 instructions each per tile: S^T = K.Q^T
//     and dP^T = V.dO^T for dkv (keys in the fragment's rows), S = Q.K^T and
//     dP = dO.V^T for dq (queries in its rows);
//   * in fp32 registers: x = S scale log2(e) + (rel_h + rel_w) log2(e) -
//     lse log2(e), P = exp2(x) (zero at or past S, and above the diagonal
//     when causal), dS = P (dP - D);
//   * P and dS are packed to bf16 pairs in registers, which are the register
//     A fragments of m64nNk16 (as attention_tc.cuh feeds P to P.V), so
//     nothing goes back through shared memory: dv += P^T.dO and dk +=
//     dS^T.Q, or dq += dS.K, with the B operand read MN-major (D contiguous)
//     with the transpose bit, 4 instructions each per tile;
//   * the epilogue writes dk scale and dv, or dq scale, in bf16 through the
//     warpgroup's own rows of the staged buffers, with 16-byte stores of rows
//     < S. No atomics: each output row is summed by one warpgroup in tile
//     order, so the result is deterministic.
// The bias, by loop direction:
//   * dkv (a block's keys fixed, queries streaming): each query tile's rows
//     of both term tables ride the ring raw (a table's 64 rows are one run
//     of bytes, copied in 16-byte chunks) and are converted in shared memory
//     to fp32 columns [rel_h | rel_w] of 64 queries, so a thread reads the
//     two columns of each of its two keys. Ordinary loads would wait a
//     global latency per batch of values, and at SAM's 32 x 32 grid that
//     wait outlasts the tile's products (it held this body at twice its
//     time, PERF.md §6);
//   * dq (a block's queries fixed, keys streaming): the block's 128 rows of
//     both tables are copied raw once, the same way, and converted to one
//     bf16 tile T (128 rows x 64 columns [rel_h | rel_w | 0], one swizzle
//     atom). Each key tile's stage also holds E, the tile's 64 x 64 bf16 0/1
//     selector: E[j, a] = [(k0 + j) / gw == a] for a < gh, E[j, gh + b] =
//     [(k0 + j) % gw == b], zero past gh + gw and for keys at or past S,
//     built by the threads that fill the stage. Then, as the TPU kernel
//     (`_selectors_full`, `sam_attention_bwd.py:42`) does, the tensor cores
//     gather and scatter: the bias is T.E^T (m64n64k16 from shared memory,
//     E K-major), an fp32 sum of the two bf16 terms, and the bucket sums
//     [d_rh | d_rw] += dS.E (E as the MN-major B operand, dS the same
//     register fragment as dS.K). Since E is 0/1, the sums are exact fp32
//     sums of the bf16 dS, as the TPU's `eh.astype(dt)` product gives them.
// K4b's causal contract (`flash_backward.py:114-125`, `:145`):
//   * a dkv block starts at the query tile that holds its first key; a
//     warpgroup skips the query tiles wholly before its 64 keys; the
//     diagonal tile takes the per-element mask query >= key. Block y owns
//     keys 128 y.., so the grid's launch order already puts the blocks with
//     the most query tiles first;
//   * a dq block streams the key tiles up to the one that holds its last
//     row, ceil(min(S, q0 + 128) / 64) of them; a warpgroup skips the key
//     tiles wholly past its 64 rows; the diagonal tile takes the mask
//     key <= query. Block y owns rows 128 y.. and has the most key tiles
//     last, so the kernel reverses y (heaviest first, as attention_tc.cuh's
//     causal forward does).
// At S = 704 either grid is 6 blocks x 32 heads = 192 blocks on 132 SMs,
// and the second wave holds the short ones. Query and key tiles both start
// at multiples of 64, so a warpgroup's diagonal tile starts at its own first
// row (or key), and the mask compares a compile-time offset in the fragment
// with one register per thread: a comparison of each score's query with its
// key spilled the causal dkv at D = 128 (PERF.md §6).
// Registers: dkv keeps dk and dv, D fp32 a thread, beside the 64 of S^T and
// dP^T; dq keeps dq (D / 2) and S and dP (64), and with the bias the bucket
// sums (32) and the bias scores (32). So a block runs alone on its SM
// (launch bounds 256 threads, one block: up to 255 registers);
// chip_smoke.py phase 2 prints ptxas's counts and fails on a spill. Shared
// memory, W the row's atoms x 64 columns (64 at D = 64, 128 at D = 80 and
// 128):
//   * dkv: 2 x 128 x W x 2 bytes of K and V, 2 stages x 2 x 64 x W x 2 of Q
//     and dO, 1 KB of LSE and D, with the bias 2 stages x 64 x (gh + gw) x
//     2 of raw term tables and (gh + gw) x 65 x 4 of their fp32 columns, and
//     1 KB to align: 162.3 KB at D = 80 on SAM's 32 x 32 grid, 144.1 KB on
//     14 x 14; 130 KB for K4b at D = 128;
//   * dq: 2 x 128 x W x 2 of Q and dO, 2 stages x 2 x 64 x W x 2 of K and
//     V, and 1 KB to align: 129 KB for K4b at D = 128; with the bias also
//     16 KB of T, 8 KB of E a stage and 128 x (gh + gw) x 2 of raw term
//     rows: 177 KB at D = 80 on 32 x 32, 168 KB on 14 x 14.
// Left for a later redesign: a producer warp with TMA and mbarriers, the
// next tile's scores over this tile's softmax, and two blocks an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_core.cuh"
#include "attention_tc.cuh"

namespace grove {
namespace tcb {

constexpr int kThreads = tc::kThreads;   // two consumer warpgroups
constexpr int kRows = 64 * tc::kWarpgroups;  // a block's own rows
constexpr int kKeys = kRows;             // dkv: key rows per block
constexpr int kBQ = 64;                  // rows of a streamed tile
constexpr int kRelStride = kBQ + 1;      // floats per staged table column
constexpr int kSel = 64;                 // columns of the dq selector E

template <int D>
constexpr size_t fixed_bytes() {
  return 2 * (size_t)tc::tile_bytes<D>(kKeys) +
         4 * (size_t)tc::tile_bytes<D>(kBQ) + 2 * 2 * kBQ * sizeof(float) +
         tc::kAlign;
}

// the term tables: two stages of their raw bf16 rows as copied, and one of
// fp32 columns that the products read
inline size_t rel_bytes(int gh, int gw) {
  return 2 * (size_t)kBQ * (gh + gw) * 2 +
         (size_t)(gh + gw) * kRelStride * sizeof(float);
}

// The dynamic shared memory a dkv entry's launch asks for at head dim d
// (64, 80 or 128; 0 for another), with the term tables of a gh x gw grid
// where `bias`.
inline size_t dkv_bytes(int d, bool bias, int gh, int gw) {
  const size_t tables = bias ? rel_bytes(gh, gw) : 0;
  switch (d) {
    case 64: return fixed_bytes<64>() + tables;
    case 80: return fixed_bytes<80>() + tables;
    case 128: return fixed_bytes<128>() + tables;
  }
  return 0;
}

// dq: Q and dO of the block's rows and two stages of K and V; with the
// bias also the tile T, a selector E in each stage and the raw term rows
// (one run per table)
template <int D, bool BIAS>
__host__ __device__ constexpr uint32_t dq_stage_bytes() {
  return 2 * tc::tile_bytes<D>(kBQ) + (BIAS ? tc::tile_bytes<64>(kBQ) : 0);
}

template <int D, bool BIAS>
inline size_t dq_fixed_bytes() {
  return 2 * (size_t)tc::tile_bytes<D>(kRows) +
         (BIAS ? tc::tile_bytes<64>(kRows) : 0) +
         2 * (size_t)dq_stage_bytes<D, BIAS>() + tc::kAlign;
}

// The same for a dq entry, with the term rows of a gh x gw grid where
// `bias`.
inline size_t dq_bytes(int d, bool bias, int gh, int gw) {
  const size_t rows = bias ? (size_t)kRows * (gh + gw) * 2 : 0;
  switch (d) {
    case 64: return rows + (bias ? dq_fixed_bytes<64, true>()
                                 : dq_fixed_bytes<64, false>());
    case 80: return rows + (bias ? dq_fixed_bytes<80, true>()
                                 : dq_fixed_bytes<80, false>());
    case 128: return rows + (bias ? dq_fixed_bytes<128, true>()
                                  : dq_fixed_bytes<128, false>());
  }
  return 0;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// LSE and D of queries q0..q0+kBQ-1 at `dst` (kBQ floats each, LSE first);
// rows at or past S zero-filled
__device__ __forceinline__ void load_stats(uint32_t dst, const BwdArgs& a,
                                           long long sb, int q0, int tid) {
  for (int i = tid; i < 2 * kBQ; i += kThreads) {
    const int which = i / kBQ;
    const int r = i - which * kBQ;
    const int row = q0 + r;
    const float* src = (which ? a.dcap : a.lse) + sb;
    const bool ok = row < a.S;
    cp_async4(dst + 4 * i, ok ? src + row : src, ok);
  }
}

// cp.async of the first n (<= 16) bytes of a 16-byte chunk, the rest of
// the chunk zero-filled
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// Rows q0..q0+ROWS-1 of the term tables of one (batch, head), `rh` and `rw`
// their row 0, raw as they lie in memory: rel_h's ROWS rows of gh values at
// `dst`, then rel_w's of gw. Each table's rows are contiguous and start
// 16-byte aligned (`tables16`), so they are one run of bytes, copied with
// 16-byte cp.async into the ring's current commit group and cut at row S.
template <int ROWS>
__device__ __forceinline__ void load_rel_raw(uint32_t dst, const BwdArgs& a,
                                             const uint16_t* rh,
                                             const uint16_t* rw, int q0,
                                             int tid) {
  const int rows = min(ROWS, a.S - q0);
  const int nh = rows * a.gh * 2;                  // bytes of each run
  const int nw = rows * a.gw * 2;
  const int ch = (nh + 15) / 16;
  const char* sh = reinterpret_cast<const char*>(rh + (long long)q0 * a.gh);
  const char* sw = reinterpret_cast<const char*>(rw + (long long)q0 * a.gw);
  const uint32_t dw = dst + ROWS * a.gh * 2;
  for (int j = tid; j < ch + (nw + 15) / 16; j += kThreads) {
    if (j < ch)
      cp_async_n(dst + 16 * j, sh + 16 * j, min(16, nh - 16 * j));
    else
      cp_async_n(dw + 16 * (j - ch), sw + 16 * (j - ch),
                 min(16, nw - 16 * (j - ch)));
  }
}

// The raw rows of `load_rel_raw<kBQ>` as fp32 columns: value c of query r
// at dst[c * kRelStride + r], c < gh from rel_h, then rel_w; rows at or
// past S hold zeros. The odd column stride puts a warp's 32 stores
// (consecutive c) on 32 banks.
__device__ __forceinline__ void convert_rel(float* dst, const uint16_t* raw,
                                            const BwdArgs& a, int q0,
                                            int tid) {
  const int gs = a.gh + a.gw;
  for (int i = tid; i < kBQ * gs; i += kThreads) {
    const int r = i / gs;
    const int c = i - r * gs;
    const uint16_t x =
        c < a.gh ? raw[r * a.gh + c] : raw[kBQ * a.gh + r * a.gw + (c - a.gh)];
    dst[c * kRelStride + r] =
        q0 + r < a.S ? __uint_as_float((uint32_t)x << 16) : 0.f;
  }
}

// The raw rows of `load_rel_raw<kRows>` as the bias tile T at `dst` (a
// generic pointer to a swizzled tile of kRows rows and one 64-column atom):
// row r holds rel_h's gh values, rel_w's gw, then zeros; rows at or past S
// are zero. One 16-byte chunk (8 columns) a step.
__device__ __forceinline__ void convert_rel_tile(uint8_t* dst,
                                                 const uint16_t* raw,
                                                 const BwdArgs& a, int q0,
                                                 int tid) {
  const int gs = a.gh + a.gw;
  for (int i = tid; i < kRows * 8; i += kThreads) {
    const int r = i >> 3;
    const int j = i & 7;
    const bool live = q0 + r < a.S;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      uint32_t x[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = 8 * j + e + u;
        x[u] = !live || c >= gs ? 0u
               : c < a.gh       ? raw[r * a.gh + c]
                                : raw[kRows * a.gh + r * a.gw + (c - a.gh)];
      }
      w[e / 2] = x[0] | (x[1] << 16);
    }
    *reinterpret_cast<uint4*>(dst + tc::swizzled(kRows, r, j)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The selector E of keys k0..k0+63 at `dst` (a generic pointer to a
// swizzled tile of 64 rows and one 64-column atom): row j holds bf16 1.0 at
// column (k0 + j) / gw and at gh + (k0 + j) % gw, zeros elsewhere and in
// rows of keys at or past S.
__device__ __forceinline__ void build_selector(uint8_t* dst, int k0,
                                               const BwdArgs& a, int tid) {
  constexpr uint32_t kOne = 0x3F80u;       // bf16 1.0
  for (int i = tid; i < kBQ * 8; i += kThreads) {
    const int r = i >> 3;
    const int j = i & 7;
    const int key = k0 + r;
    const int kh = key < a.S ? key / a.gw : -1;
    const int kw = key < a.S ? a.gh + (key - kh * a.gw) : -1;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * e;
      w[e] = (c == kh || c == kw ? kOne : 0u) |
             (c + 1 == kh || c + 1 == kw ? kOne << 16 : 0u);
    }
    *reinterpret_cast<uint4*>(dst + tc::swizzled(kBQ, r, j)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int D, bool BIAS, bool CAUSAL>
__device__ __forceinline__ void dkv_block_tc(const BwdArgs& a) {
  static_assert(D == 64 || D == 80 || D == 128,
                "the tensor-core body takes D 64, 80, 128");
  static_assert(!(BIAS && CAUSAL), "K9 is not causal");
  constexpr int KSTEPS = D / 16;           // k16 steps of K.Q^T and V.dO^T
  constexpr int NO = D / 2;                // dk, dv accumulator floats
  constexpr uint32_t TK = tc::tile_bytes<D>(kKeys);
  constexpr uint32_t TQ = tc::tile_bytes<D>(kBQ);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t sK = (raw + tc::kAlign - 1) & ~(uint32_t)(tc::kAlign - 1);
  const uint32_t sV = sK + TK;
  const uint32_t sRing = sV + TK;          // stage st: Q, then dO
  const uint32_t sStats = sRing + 4 * TQ;  // stage st: LSE, then D
  const uint32_t sRaw = sStats + 2 * 2 * kBQ * 4;  // stage st: raw tables
  const int raw_bytes = kBQ * (a.gh + a.gw) * 2;    // one stage
  uint8_t* stage = smem_raw + (sK - raw);  // sK as a generic pointer
  const float* stats = reinterpret_cast<const float*>(stage + 2 * TK + 4 * TQ);
  uint16_t* raws = reinterpret_cast<uint16_t*>(stage + (sRaw - sK));
  float* sR = reinterpret_cast<float*>(stage + (sRaw - sK) + 2 * raw_bytes);

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
  const int j0 = blockIdx.y * kKeys;
  const int kw0 = j0 + 64 * wg;            // this warpgroup's first key
  const bool active = kw0 < a.S;           // warpgroup-uniform
  const int nq = (a.S + kBQ - 1) / kBQ;
  // causal: the first query tile that sees one of the block's keys
  const int t0 = CAUSAL ? j0 / kBQ : 0;

  const long long xb = b * a.xs.b + h * a.xs.h;
  const long long sb = ((long long)b * a.H + h) * a.S;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + xb;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + xb;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + xb;
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(a.dout) + xb;
  const uint16_t* rh = nullptr;
  const uint16_t* rw = nullptr;
  if constexpr (BIAS) {
    rh = static_cast<const uint16_t*>(a.rh) + b * a.rhs.b + h * a.rhs.h;
    rw = static_cast<const uint16_t*>(a.rw) + b * a.rws.b + h * a.rws.h;
  }

  tc::load_tile<D>(sK, k, a.xs.s, j0, kKeys, a.S, tid);
  tc::load_tile<D>(sV, v, a.xs.s, j0, kKeys, a.S, tid);
  tc::load_tile<D>(sRing, q, a.xs.s, t0 * kBQ, kBQ, a.S, tid);
  tc::load_tile<D>(sRing + TQ, dout, a.xs.s, t0 * kBQ, kBQ, a.S, tid);
  load_stats(sStats, a, sb, t0 * kBQ, tid);
  if constexpr (BIAS)
    load_rel_raw<kBQ>(sRaw, a, rh, rw, t0 * kBQ, tid);  // read after a sync
  tc::cp_async_commit();

  // this thread's two keys (fragment rows R0 and R0 + 8 of the block) and
  // their columns of the staged tables; keys past the grid read its last
  // row of rel_h (their dk and dv rows are never written)
  const int R0 = 64 * wg + 16 * warp + g;
  const int key0 = j0 + R0;
  const int key1 = key0 + 8;
  // causal: key0 less kw0, less 2 t4, to compare with query offsets
  const int diag_lim = 16 * warp + g - 2 * t4;
  int ch0 = 0, ch1 = 0, cw0 = 0, cw1 = 0;
  if constexpr (BIAS) {
    ch0 = min(key0 / a.gw, a.gh - 1) * kRelStride;
    ch1 = min(key1 / a.gw, a.gh - 1) * kRelStride;
    cw0 = (a.gh + key0 % a.gw) * kRelStride;
    cw1 = (a.gh + key1 % a.gw) * kRelStride;
  }

  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const uint32_t ka = sK + wg * 64 * 128;  // the warpgroup's A rows
  const uint32_t va = sV + wg * 64 * 128;

  for (int t = t0; t < nq; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < nq) {
      const int q1 = (t + 1) * kBQ;
      const uint32_t next = sRing + (st ^ 1) * 2 * TQ;
      tc::load_tile<D>(next, q, a.xs.s, q1, kBQ, a.S, tid);
      tc::load_tile<D>(next + TQ, dout, a.xs.s, q1, kBQ, a.S, tid);
      load_stats(sStats + (st ^ 1) * 2 * kBQ * 4, a, sb, q1, tid);
      // the other stage's raw tables were last read before the last sync
      if constexpr (BIAS)
        load_rel_raw<kBQ>(sRaw + (st ^ 1) * raw_bytes, a, rh, rw, q1, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();
    if constexpr (BIAS) {
      convert_rel(sR, raws + st * raw_bytes / 2, a, t * kBQ, tid);
      __syncthreads();
    }

    const int q0 = t * kBQ;
    // causal: a warpgroup skips the query tiles wholly before its keys
    if (active && !(CAUSAL && q0 + kBQ <= kw0)) {
      const uint32_t sQ = sRing + st * 2 * TQ;
      const uint32_t sG = sQ + TQ;
      tc::fence_operands(s);
      tc::fence_operands(dp);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        tc::wgmma_ss_n64(
            s,
            tc::descriptor(ka + (kk >> 2) * tc::tile_bytes<64>(kKeys) + col,
                           16, 1024),
            tc::descriptor(sQ + (kk >> 2) * tc::tile_bytes<64>(kBQ) + col,
                           16, 1024),
            kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        tc::wgmma_ss_n64(
            dp,
            tc::descriptor(va + (kk >> 2) * tc::tile_bytes<64>(kKeys) + col,
                           16, 1024),
            tc::descriptor(sG + (kk >> 2) * tc::tile_bytes<64>(kBQ) + col,
                           16, 1024),
            kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_operands(s);
      tc::fence_operands(dp);

      // s[4j + e]: key key0 (e < 2) or key1, query q0 + 8j + 2 t4 + (e & 1)
      const float* lse = stats + st * 2 * kBQ;
      const float* dcap = lse + kBQ;
      const float* rel = sR;
      // the ragged last tile masks the queries at or past S, and causal
      // the diagonal tile (q0 == kw0: both are 64-aligned) those before
      // the key: each a compile-time query offset c = qc - 2 t4 against one
      // register (`lim`, and `diag_lim` + 8 for key1)
      const int lim = a.S - q0 - 2 * t4;
      const bool diag = CAUSAL && q0 == kw0;
      const bool edge = q0 + kBQ > a.S || diag;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float e[8], f[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = 8 * kk + i;
          const int qc = 16 * kk + 8 * (i >> 2) + 2 * t4 + (i & 1);
          float x = s[idx] * sl2;
          if constexpr (BIAS) {
            const int chh = (i & 2) ? ch1 : ch0;
            const int cww = (i & 2) ? cw1 : cw0;
            x += (rel[chh + qc] + rel[cww + qc]) * kLog2e;
          }
          x -= lse[qc] * kLog2e;
          float p = exp2f(x);
          if (edge) {
            const int c = 16 * kk + 8 * (i >> 2) + (i & 1);
            if (c >= lim || (diag && c < diag_lim + ((i & 2) ? 8 : 0)))
              p = 0.f;
          }
          e[i] = p;
          f[i] = p * (dp[idx] - dcap[qc]);
        }
        pa[kk][0] = tc::pack_bf16(e[0], e[1]);  // key0, queries 16kk + 2t4
        pa[kk][1] = tc::pack_bf16(e[2], e[3]);  // key1
        pa[kk][2] = tc::pack_bf16(e[4], e[5]);  // key0, queries + 8
        pa[kk][3] = tc::pack_bf16(e[6], e[7]);  // key1
        da[kk][0] = tc::pack_bf16(f[0], f[1]);
        da[kk][1] = tc::pack_bf16(f[2], f[3]);
        da[kk][2] = tc::pack_bf16(f[4], f[5]);
        da[kk][3] = tc::pack_bf16(f[6], f[7]);
      }
      tc::fence_operands(dv);
      tc::fence_operands(dk);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_rs<D>(dv, pa[kk],
                        tc::descriptor(sG + kk * 16 * 128,
                                       tc::tile_bytes<64>(kBQ), 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_rs<D>(dk, da[kk],
                        tc::descriptor(sQ + kk * 16 * 128,
                                       tc::tile_bytes<64>(kBQ), 1024));
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_operands(dv);
      tc::fence_operands(dk);
    }
    __syncthreads();                       // the stage may be refilled
  }
  if (!active) return;

  // stage dk * scale in the warpgroup's own rows of the K buffer and dv in
  // those of the V buffer, whose last reader (this warpgroup's wgmma) has
  // completed; then whole rows of keys < S with 16-byte stores
  tc::fence_proxy_async();
  const int R1 = R0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const uint32_t within = (col & 7) * 2;
    const uint32_t o0 = tc::swizzled(kKeys, R0, col >> 3) + within;
    const uint32_t o1 = tc::swizzled(kKeys, R1, col >> 3) + within;
    *reinterpret_cast<uint32_t*>(stage + o0) =
        tc::pack_bf16(dk[4 * j] * a.scale, dk[4 * j + 1] * a.scale);
    *reinterpret_cast<uint32_t*>(stage + o1) =
        tc::pack_bf16(dk[4 * j + 2] * a.scale, dk[4 * j + 3] * a.scale);
    *reinterpret_cast<uint32_t*>(stage + TK + o0) =
        tc::pack_bf16(dv[4 * j], dv[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(stage + TK + o1) =
        tc::pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
  }
  tc::warpgroup_barrier(wg);
  __nv_bfloat16* dko = static_cast<__nv_bfloat16*>(a.dk) + xb;
  __nv_bfloat16* dvo = static_cast<__nv_bfloat16*>(a.dv) + xb;
  constexpr int C = D / 8;
  for (int i = tw; i < 64 * C; i += 128) {
    const int rl = i / C;
    const int j = i - rl * C;
    const int key = kw0 + rl;
    if (key < a.S) {
      const uint32_t o = tc::swizzled(kKeys, 64 * wg + rl, j);
      *reinterpret_cast<uint4*>(dko + key * a.xs.s + j * 8) =
          *reinterpret_cast<const uint4*>(stage + o);
      *reinterpret_cast<uint4*>(dvo + key * a.xs.s + j * 8) =
          *reinterpret_cast<const uint4*>(stage + TK + o);
    }
  }
}

template <int D, bool BIAS, bool CAUSAL>
__device__ __forceinline__ void dq_block_tc(const BwdArgs& a) {
  static_assert(D == 64 || D == 80 || D == 128,
                "the tensor-core body takes D 64, 80, 128");
  static_assert(!(BIAS && CAUSAL), "K9 is not causal");
  constexpr int KSTEPS = D / 16;           // k16 steps of Q.K^T and dO.V^T
  constexpr int NO = D / 2;                // dq accumulator floats
  constexpr int NB = BIAS ? 32 : 1;        // bias and bucket-sum floats
  constexpr uint32_t TQ = tc::tile_bytes<D>(kRows);   // Q, dO
  constexpr uint32_t TK = tc::tile_bytes<D>(kBQ);     // K, V of a stage
  constexpr uint32_t TT = BIAS ? tc::tile_bytes<64>(kRows) : 0;  // T
  constexpr uint32_t ST = dq_stage_bytes<D, BIAS>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t sQ = (raw + tc::kAlign - 1) & ~(uint32_t)(tc::kAlign - 1);
  const uint32_t sG = sQ + TQ;             // dO
  const uint32_t sT = sG + TQ;             // the bias tile T
  const uint32_t sRing = sT + TT;          // stage st: K, V[, then E]
  const uint32_t sRaw = sRing + 2 * ST;    // the raw term rows
  uint8_t* stage = smem_raw + (sQ - raw);  // sQ as a generic pointer

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
  // causal: the last rows stream the most key tiles, so they launch first
  const int qb = CAUSAL ? (int)(gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qb * kRows;
  const int qw = q0 + 64 * wg;             // this warpgroup's first row
  const bool active = qw < a.S;            // warpgroup-uniform
  // causal: the key tiles up to the one that holds the block's last row
  const int nk = ((CAUSAL ? min(a.S, q0 + kRows) : a.S) + kBQ - 1) / kBQ;

  const long long xb = b * a.xs.b + h * a.xs.h;
  const long long sb = ((long long)b * a.H + h) * a.S;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + xb;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + xb;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + xb;
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(a.dout) + xb;
  const uint16_t* rh = nullptr;
  const uint16_t* rw = nullptr;
  if constexpr (BIAS) {
    rh = static_cast<const uint16_t*>(a.rh) + b * a.rhs.b + h * a.rhs.h;
    rw = static_cast<const uint16_t*>(a.rw) + b * a.rws.b + h * a.rws.h;
  }

  tc::load_tile<D>(sQ, q, a.xs.s, q0, kRows, a.S, tid);
  tc::load_tile<D>(sG, dout, a.xs.s, q0, kRows, a.S, tid);
  if constexpr (BIAS)
    load_rel_raw<kRows>(sRaw, a, rh, rw, q0, tid);  // converted after a sync
  tc::load_tile<D>(sRing, k, a.xs.s, 0, kBQ, a.S, tid);
  tc::load_tile<D>(sRing + TK, v, a.xs.s, 0, kBQ, a.S, tid);
  tc::cp_async_commit();
  if constexpr (BIAS) build_selector(stage + (sRing + 2 * TK - sQ), 0, a, tid);

  // this thread's two rows (fragment rows R0 and R0 + 8 of the block):
  // their LSE in log2 units and D
  const int R0 = 64 * wg + 16 * warp + g;
  const int r0 = q0 + R0;
  const int r1 = r0 + 8;
  const float l0 = r0 < a.S ? a.lse[sb + r0] * kLog2e : 0.f;
  const float l1 = r1 < a.S ? a.lse[sb + r1] * kLog2e : 0.f;
  const float d0 = r0 < a.S ? a.dcap[sb + r0] : 0.f;
  const float d1 = r1 < a.S ? a.dcap[sb + r1] : 0.f;
  // causal: row r0 less qw, less 2 t4, to compare with key offsets
  const int diag_lim = 16 * warp + g - 2 * t4;

  float dq[NO], drel[NB];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
  float s[32], bias[NB], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if constexpr (BIAS)
      drel[i] = s[i] = bias[i] = dp[i] = 0.f;
    else
      s[i] = dp[i] = 0.f;
  }
  const float sl2 = a.scale * kLog2e;
  const uint32_t qa = sQ + wg * 64 * 128;  // the warpgroup's A rows
  const uint32_t ga = sG + wg * 64 * 128;
  const uint32_t ta = sT + wg * 64 * 128;

  for (int t = 0; t < nk; ++t) {
    const int st = t & 1;
    if (t + 1 < nk) {
      const int k1 = (t + 1) * kBQ;
      const uint32_t next = sRing + (st ^ 1) * ST;
      tc::load_tile<D>(next, k, a.xs.s, k1, kBQ, a.S, tid);
      tc::load_tile<D>(next + TK, v, a.xs.s, k1, kBQ, a.S, tid);
      tc::cp_async_commit();
      // the other stage's E was last read before the last sync
      if constexpr (BIAS)
        build_selector(stage + (next + 2 * TK - sQ), k1, a, tid);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();
    if constexpr (BIAS) {
      if (t == 0) {                        // T, once the raw rows landed
        convert_rel_tile(
            stage + (sT - sQ),
            reinterpret_cast<const uint16_t*>(stage + (sRaw - sQ)), a, q0,
            tid);
        tc::fence_proxy_async();
        __syncthreads();
      }
    }

    // causal: a warpgroup skips the key tiles wholly past its rows
    if (active && !(CAUSAL && t * kBQ > qw)) {
      const uint32_t sK = sRing + st * ST;
      const uint32_t sV = sK + TK;
      const uint32_t sE = sV + TK;
      tc::fence_operands(s);
      if constexpr (BIAS) tc::fence_operands(bias);
      tc::fence_operands(dp);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        tc::wgmma_ss_n64(
            s,
            tc::descriptor(qa + (kk >> 2) * tc::tile_bytes<64>(kRows) + col,
                           16, 1024),
            tc::descriptor(sK + (kk >> 2) * tc::tile_bytes<64>(kBQ) + col,
                           16, 1024),
            kk > 0);
      }
      if constexpr (BIAS) {
#pragma unroll
        for (int kk = 0; kk < kSel / 16; ++kk)
          tc::wgmma_ss_n64(bias, tc::descriptor(ta + kk * 32, 16, 1024),
                           tc::descriptor(sE + kk * 32, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        tc::wgmma_ss_n64(
            dp,
            tc::descriptor(ga + (kk >> 2) * tc::tile_bytes<64>(kRows) + col,
                           16, 1024),
            tc::descriptor(sV + (kk >> 2) * tc::tile_bytes<64>(kBQ) + col,
                           16, 1024),
            kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_operands(s);
      if constexpr (BIAS) tc::fence_operands(bias);
      tc::fence_operands(dp);

      // s[4j + e]: row r0 (e < 2) or r1, key k0 + 8j + 2 t4 + (e & 1)
      const int k0 = t * kBQ;
      // the ragged last tile masks the keys at or past S, and causal the
      // diagonal tile (k0 == qw: both are 64-aligned) those past the row;
      // without the bias each a compile-time key offset c = kc - 2 t4
      // against one register (`lim`, and `diag_lim` + 8 for r1)
      const int lim = a.S - k0 - 2 * t4;
      const bool diag = CAUSAL && k0 == qw;
      const bool edge = k0 + kBQ > a.S || diag;
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float f[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = 8 * kk + i;
          float x;
          if constexpr (BIAS)
            x = s[idx] * sl2 + bias[idx] * kLog2e - ((i & 2) ? l1 : l0);
          else
            x = s[idx] * sl2 - ((i & 2) ? l1 : l0);
          float p = exp2f(x);
          if constexpr (BIAS) {
            if (edge && k0 + 16 * kk + 8 * (i >> 2) + 2 * t4 + (i & 1) >= a.S)
              p = 0.f;
          } else if (edge) {
            const int c = 16 * kk + 8 * (i >> 2) + (i & 1);
            if (c >= lim || (diag && c > diag_lim + ((i & 2) ? 8 : 0)))
              p = 0.f;
          }
          f[i] = p * (dp[idx] - ((i & 2) ? d1 : d0));
        }
        da[kk][0] = tc::pack_bf16(f[0], f[1]);  // row r0, keys 16kk + 2t4
        da[kk][1] = tc::pack_bf16(f[2], f[3]);  // row r1
        da[kk][2] = tc::pack_bf16(f[4], f[5]);  // row r0, keys + 8
        da[kk][3] = tc::pack_bf16(f[6], f[7]);  // row r1
      }
      tc::fence_operands(dq);
      if constexpr (BIAS) tc::fence_operands(drel);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma_rs<D>(dq, da[kk],
                        tc::descriptor(sK + kk * 16 * 128,
                                       tc::tile_bytes<64>(kBQ), 1024));
      if constexpr (BIAS) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          tc::wgmma_rs_n64(drel, da[kk],
                           tc::descriptor(sE + kk * 16 * 128,
                                          tc::tile_bytes<64>(kBQ), 1024),
                           1);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_operands(dq);
      if constexpr (BIAS) tc::fence_operands(drel);
    }
    __syncthreads();                       // the stage may be refilled
  }
  if (!active) return;

  if constexpr (BIAS) {
    // the bucket sums: drel[4j + e] is row r0 (e < 2) or r1, column
    // 8j + 2 t4 + (e & 1) of [d_rh | d_rw]
    const int gs = a.gh + a.gw;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = (i & 2) ? r1 : r0;
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (row < a.S && c < gs) {
        if (c < a.gh)
          a.drh[(sb + row) * a.gh + c] = drel[i];
        else
          a.drw[(sb + row) * a.gw + (c - a.gh)] = drel[i];
      }
    }
  }

  // stage dq * scale in the warpgroup's own rows of the Q buffer, whose
  // last reader (this warpgroup's wgmma) has completed; then whole rows
  // < S with 16-byte stores
  tc::fence_proxy_async();
  const int R1 = R0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const uint32_t within = (col & 7) * 2;
    *reinterpret_cast<uint32_t*>(stage + tc::swizzled(kRows, R0, col >> 3) +
                                 within) =
        tc::pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    *reinterpret_cast<uint32_t*>(stage + tc::swizzled(kRows, R1, col >> 3) +
                                 within) =
        tc::pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
  }
  tc::warpgroup_barrier(wg);
  __nv_bfloat16* dqo = static_cast<__nv_bfloat16*>(a.dq) + xb;
  constexpr int C = D / 8;
  for (int i = tw; i < 64 * C; i += 128) {
    const int rl = i / C;
    const int j = i - rl * C;
    const int row = qw + rl;
    if (row < a.S)
      *reinterpret_cast<uint4*>(dqo + row * a.xs.s + j * 8) =
          *reinterpret_cast<const uint4*>(
              stage + tc::swizzled(kRows, 64 * wg + rl, j));
  }
}

// Whether the base pointers and row strides keep every row of q, k, v, dO,
// dq, dk and dv 16-byte aligned, as the 16-byte copies and stores need.
inline bool rows16(const BwdArgs& a) {
  const void* p[] = {a.q, a.k, a.v, a.dout, a.dq, a.dk, a.dv};
  for (const void* x : p)
    if (reinterpret_cast<uintptr_t>(x) % 16) return false;
  return a.xs.b % 8 == 0 && a.xs.s % 8 == 0 && a.xs.h % 8 == 0;
}

// Whether each (batch, head) block of the term tables is contiguous and
// starts 16-byte aligned, as their 16-byte copies need (an odd grid, as
// 7 x 7, leaves the blocks unaligned).
inline bool tables16(const BwdArgs& a) {
  return a.rh != nullptr && reinterpret_cast<uintptr_t>(a.rh) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.rw) % 16 == 0 && a.rhs.s == a.gh &&
         a.rws.s == a.gw && a.rhs.b % 8 == 0 && a.rhs.h % 8 == 0 &&
         a.rws.b % 8 == 0 && a.rws.h % 8 == 0;
}

// Opt `kernel` into `bytes` of dynamic shared memory and the largest
// carve-out, then launch it on `grid`; returns cudaGetLastError().
template <typename Kernel>
inline int launch(Kernel kernel, dim3 grid, size_t bytes, const BwdArgs& a,
                  cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The grid of either body: (batch, head) pairs on x, blocks of kRows rows
// (keys for dkv, queries for dq) on y.
inline dim3 grid_of(const BwdArgs& a) {
  return dim3(a.B * a.H, (a.S + kRows - 1) / kRows);
}

}  // namespace tcb
}  // namespace grove

// Define the __global__ instantiations of a tensor-core dkv entry and a
// host dispatcher `NAME_tc_dispatch` over (dtype, head_dim): bf16 (dtype 1)
// at D 64, 80 or 128, 16-byte-aligned rows; with BIAS the rel-pos term
// tables (`tables16`) and no causal mask, without it no tables and a causal
// mask or none; anything else is refused with cudaErrorInvalidValue. One
// block an SM (up to 255 registers a thread). `NAME_tc_launch` picks the
// causal instantiation only where BIAS is false, so none with both exists.
// `grove_NAME_tc_smem(d, gh, gw)` returns the dynamic shared memory the
// dispatcher asks for (chip_smoke.py prints it).
#define GROVE_DKV_TC_ENTRY(NAME, BIAS)                                        \
  template <int D, bool CAUSAL>                                               \
  __global__ void __launch_bounds__(grove::tcb::kThreads, 1)                  \
      NAME##_tc_kernel(const grove::BwdArgs a) {                              \
    grove::tcb::dkv_block_tc<D, BIAS, CAUSAL>(a);                             \
  }                                                                           \
  template <int D, bool B = (BIAS)>                                           \
  static int NAME##_tc_launch(const grove::BwdArgs& a, cudaStream_t st) {     \
    const size_t bytes = grove::tcb::dkv_bytes(D, B, a.gh, a.gw);             \
    if constexpr (!B) {                                                       \
      if (a.causal)                                                           \
        return grove::tcb::launch(NAME##_tc_kernel<D, true>,                  \
                                  grove::tcb::grid_of(a), bytes, a, st);      \
    }                                                                         \
    return grove::tcb::launch(NAME##_tc_kernel<D, false>,                     \
                              grove::tcb::grid_of(a), bytes, a, st);          \
  }                                                                           \
  extern "C" long long grove_##NAME##_tc_smem(int d, int gh, int gw) {       \
    return (long long)grove::tcb::dkv_bytes(d, (BIAS), gh, gw);               \
  }                                                                           \
  static int NAME##_tc_dispatch(const grove::BwdArgs& a, int dtype, int d,    \
                                cudaStream_t st) {                            \
    if (dtype != 1 || !grove::tcb::rows16(a) || a.S < 1 ||                    \
        ((BIAS) ? !grove::tcb::tables16(a) || a.gh < 1 || a.gw < 1 ||         \
                      a.causal                                                \
                : a.rh != nullptr))                                           \
      return (int)cudaErrorInvalidValue;                                      \
    if (d == 64) return NAME##_tc_launch<64>(a, st);                          \
    if (d == 80) return NAME##_tc_launch<80>(a, st);                          \
    if (d == 128) return NAME##_tc_launch<128>(a, st);                        \
    return (int)cudaErrorInvalidValue;                                        \
  }

// The same for a tensor-core dq entry: bf16 at D 64, 80 or 128,
// 16-byte-aligned rows; with BIAS (K9) the term tables (`tables16`) with
// gh + gw <= 64 on a grid of S = gh gw keys and no causal mask, without it
// (K4b) no tables and a causal mask or none, any S.
#define GROVE_DQ_TC_ENTRY(NAME, BIAS)                                         \
  template <int D, bool CAUSAL>                                               \
  __global__ void __launch_bounds__(grove::tcb::kThreads, 1)                  \
      NAME##_tc_kernel(const grove::BwdArgs a) {                              \
    grove::tcb::dq_block_tc<D, BIAS, CAUSAL>(a);                              \
  }                                                                           \
  template <int D, bool B = (BIAS)>                                           \
  static int NAME##_tc_launch(const grove::BwdArgs& a, cudaStream_t st) {     \
    const size_t bytes = grove::tcb::dq_bytes(D, B, a.gh, a.gw);              \
    if constexpr (!B) {                                                       \
      if (a.causal)                                                           \
        return grove::tcb::launch(NAME##_tc_kernel<D, true>,                  \
                                  grove::tcb::grid_of(a), bytes, a, st);      \
    }                                                                         \
    return grove::tcb::launch(NAME##_tc_kernel<D, false>,                     \
                              grove::tcb::grid_of(a), bytes, a, st);          \
  }                                                                           \
  extern "C" long long grove_##NAME##_tc_smem(int d, int gh, int gw) {       \
    return (long long)grove::tcb::dq_bytes(d, (BIAS), gh, gw);                \
  }                                                                           \
  static int NAME##_tc_dispatch(const grove::BwdArgs& a, int dtype, int d,    \
                                cudaStream_t st) {                            \
    if (dtype != 1 || !grove::tcb::rows16(a) || a.S < 1 ||                    \
        ((BIAS) ? !grove::tcb::tables16(a) || a.gh < 1 || a.gw < 1 ||         \
                      a.gh + a.gw > grove::tcb::kSel ||                       \
                      a.S != a.gh * a.gw || a.causal                          \
                : a.rh != nullptr))                                           \
      return (int)cudaErrorInvalidValue;                                      \
    if (d == 64) return NAME##_tc_launch<64>(a, st);                          \
    if (d == 80) return NAME##_tc_launch<80>(a, st);                          \
    if (d == 128) return NAME##_tc_launch<128>(a, st);                        \
    return (int)cudaErrorInvalidValue;                                        \
  }
