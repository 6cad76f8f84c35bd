// Tensor-core backward body of the hand-written attention kernels of
// grove_tpu_torch, beside the SIMT body of attention_bwd_core.cuh.
//
// It serves K9's dkv, grove_tpu/ops/sam_attention_bwd.py:152 `_dkv_kernel`
// (relpos_flash_attention.cu, `grove_relpos_flash_dkv_tc`), for bf16 inputs
// at head dims 64, 80 and 128: dk and dv of SAM's decomposed rel-pos
// attention, P recomputed from the forward's LSE,
//
//   s_ij  = scale * q_i . k_j + rel_h[i, j / gw] + rel_w[i, j % gw]
//   p_ij  = exp(s_ij - lse_i),   ds_ij = p_ij (dO_i . v_j - D_i)
//   dv_j  = sum_i p_ij dO_i,     dk_j = scale * sum_i ds_ij q_i
//
// with the TPU kernel's rounding points: P rounded to bf16 before P^T.dO
// (`sam_attention_bwd.py:186`) and dS, computed from the unrounded P, before
// dS^T.Q (`:191`); both products accumulate in fp32. fp32 inputs and the
// head dim 8 keep the SIMT entry `grove_relpos_flash_dkv`, and so do K9's dq
// and K4b (their contracts come to this body next).
//
// Contract (BwdArgs): q, k, v, dO, dk, dv in the (B, S, H, D) layout with
// element strides, bf16, every row 16-byte aligned; lse and D = rowsum(dO O)
// (B, H, S) fp32; the term tables rel_h (S, gh) and rel_w (S, gw) per
// (batch, head) in bf16 through generic strides; keys and queries at or past
// S masked in the kernel (no caller pads); no causal mask.
//
// Bound on an H100: operations. Each (batch, head) does 4 matmuls of
// 2 S^2 D flops (K.Q^T, V.dO^T, P^T.dO, dS^T.Q) on 2 bytes per element of
// q, k, v, dO, dk and dv, far above the card's balance point at SAM's S =
// 196 and 1024, so only the bf16 tensor cores (wgmma) can approach it. The
// design, for that:
//   * a block owns 128 key rows of one (batch, head), 64 for each of its
//     two consumer warpgroups (256 threads); K and V are staged in shared
//     memory once, in the 128-byte-swizzled layout of attention_tc.cuh;
//   * Q and dO tiles of 64 queries stream through a two-stage ring filled
//     with 16-byte cp.async copies (rows past S zero-filled); the same ring
//     carries each tile's LSE and D (4-byte cp.async) and the tile's rows of
//     both term tables, raw: a table's 64 rows are one run of bytes in
//     memory, copied in 16-byte chunks (the entry takes only tables whose
//     (batch, head) blocks start 16-byte aligned, as every grid of SAM's
//     configurations gives; the wrapper routes others to the SIMT entry).
//     Once a tile's copies land, the block converts its rows to fp32
//     columns [rel_h | rel_w] of 64 queries, so a thread reads the two
//     columns of each of its two keys. Copies in the ring cost the tile no
//     wait:
//     ordinary loads would wait a global latency per batch of values, and
//     at SAM's 32 x 32 grid that wait outlasts the tile's products;
//   * S^T = K.Q^T and dP^T = V.dO^T are wgmma m64n64k16 with both operands
//     in shared memory, K-major, D / 16 instructions each per tile: the
//     fragment holds keys in its rows and queries in its columns;
//   * in fp32 registers: x = S^T scale log2(e) + (rel_h + rel_w) log2(e) -
//     lse log2(e), P^T = exp2(x) (zero for queries at or past S), dS^T =
//     P^T (dP^T - D);
//   * P^T and dS^T are packed to bf16 pairs in registers, which are the
//     register A fragments of m64nDk16 (as attention_tc.cuh feeds P to
//     P.V), so nothing goes back through shared memory: dv += P^T.dO and
//     dk += dS^T.Q with dO and Q as the B operand read MN-major (D
//     contiguous) with the transpose bit, 4 instructions each per tile;
//   * the epilogue writes dk scale and dv in bf16 through the warpgroup's
//     own rows of the K and V buffers, with 16-byte stores of rows < S. No
//     atomics: each key row is summed by one warpgroup in query order, so
//     the result is deterministic.
// Registers: dk and dv take D fp32 a thread (80 at D = 80, 128 at D = 128)
// beside the 64 of S^T and dP^T, so a block runs alone on its SM (launch
// bounds 256 threads, one block: up to 255 registers); chip_smoke.py
// phase 2 prints ptxas's counts and fails on a spill. Shared memory: 2 x
// 128 x W x 2 bytes of K and V, 2 stages x 2 x 64 x W x 2 of Q and dO (W
// the row's atoms x 64 columns: 64 at D = 64, 128 at D = 80 and 128),
// 1 KB of LSE and D, 2 stages x 64 x (gh + gw) x 2 of raw term tables and
// (gh + gw) x 65 x 4 of their fp32 columns, and 1 KB to align: 162.3 KB at
// D = 80 on SAM's 32 x 32 grid, 144.1 KB on 14 x 14.
// Left for a later redesign: a producer warp with TMA and mbarriers, the
// next tile's S^T over this tile's softmax, and two blocks an SM.

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
constexpr int kKeys = 64 * tc::kWarpgroups;  // key rows per block
constexpr int kBQ = 64;                  // queries per streamed tile
constexpr int kRelStride = kBQ + 1;      // floats per staged table column

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

template <int D>
inline size_t smem_bytes(int gh, int gw) {
  return fixed_bytes<D>() + rel_bytes(gh, gw);
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

// Rows q0..q0+kBQ-1 of the term tables of one (batch, head), `rh` and `rw`
// their row 0, raw as they lie in memory: rel_h's kBQ rows of gh values at
// `dst`, then rel_w's of gw. Each table's rows are contiguous and start
// 16-byte aligned (`aligned16`), so they are one run of bytes, copied with
// 16-byte cp.async into the ring's current commit group and cut at row S.
__device__ __forceinline__ void load_rel_raw(uint32_t dst, const BwdArgs& a,
                                             const uint16_t* rh,
                                             const uint16_t* rw, int q0,
                                             int tid) {
  const int rows = min(kBQ, a.S - q0);
  const int nh = rows * a.gh * 2;                  // bytes of each run
  const int nw = rows * a.gw * 2;
  const int ch = (nh + 15) / 16;
  const char* sh = reinterpret_cast<const char*>(rh + (long long)q0 * a.gh);
  const char* sw = reinterpret_cast<const char*>(rw + (long long)q0 * a.gw);
  const uint32_t dw = dst + kBQ * a.gh * 2;
  for (int j = tid; j < ch + (nw + 15) / 16; j += kThreads) {
    if (j < ch)
      cp_async_n(dst + 16 * j, sh + 16 * j, min(16, nh - 16 * j));
    else
      cp_async_n(dw + 16 * (j - ch), sw + 16 * (j - ch),
                 min(16, nw - 16 * (j - ch)));
  }
}

// The raw rows of `load_rel_raw` as fp32 columns: value c of query r at
// dst[c * kRelStride + r], c < gh from rel_h, then rel_w; rows at or past S
// hold zeros. The odd column stride puts a warp's 32 stores (consecutive
// c) on 32 banks.
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

template <int D>
__device__ __forceinline__ void dkv_block_tc(const BwdArgs& a) {
  static_assert(D == 64 || D == 80 || D == 128,
                "the tensor-core body takes D 64, 80, 128");
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

  const long long xb = b * a.xs.b + h * a.xs.h;
  const long long sb = ((long long)b * a.H + h) * a.S;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + xb;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + xb;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + xb;
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(a.dout) + xb;
  const uint16_t* rh = static_cast<const uint16_t*>(a.rh) + b * a.rhs.b +
                       h * a.rhs.h;
  const uint16_t* rw = static_cast<const uint16_t*>(a.rw) + b * a.rws.b +
                       h * a.rws.h;

  tc::load_tile<D>(sK, k, a.xs.s, j0, kKeys, a.S, tid);
  tc::load_tile<D>(sV, v, a.xs.s, j0, kKeys, a.S, tid);
  tc::load_tile<D>(sRing, q, a.xs.s, 0, kBQ, a.S, tid);
  tc::load_tile<D>(sRing + TQ, dout, a.xs.s, 0, kBQ, a.S, tid);
  load_stats(sStats, a, sb, 0, tid);
  load_rel_raw(sRaw, a, rh, rw, 0, tid);   // read after a sync
  tc::cp_async_commit();

  // this thread's two keys (fragment rows R0 and R0 + 8 of the block) and
  // their columns of the staged tables; keys past the grid read its last
  // row of rel_h (their dk and dv rows are never written)
  const int R0 = 64 * wg + 16 * warp + g;
  const int key0 = j0 + R0;
  const int key1 = key0 + 8;
  const int ch0 = min(key0 / a.gw, a.gh - 1) * kRelStride;
  const int ch1 = min(key1 / a.gw, a.gh - 1) * kRelStride;
  const int cw0 = (a.gh + key0 % a.gw) * kRelStride;
  const int cw1 = (a.gh + key1 % a.gw) * kRelStride;

  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const uint32_t ka = sK + wg * 64 * 128;  // the warpgroup's A rows
  const uint32_t va = sV + wg * 64 * 128;

  for (int t = 0; t < nq; ++t) {
    const int st = t & 1;
    if (t + 1 < nq) {
      const int q1 = (t + 1) * kBQ;
      const uint32_t next = sRing + (st ^ 1) * 2 * TQ;
      tc::load_tile<D>(next, q, a.xs.s, q1, kBQ, a.S, tid);
      tc::load_tile<D>(next + TQ, dout, a.xs.s, q1, kBQ, a.S, tid);
      load_stats(sStats + (st ^ 1) * 2 * kBQ * 4, a, sb, q1, tid);
      // the other stage's raw tables were last read before the last sync
      load_rel_raw(sRaw + (st ^ 1) * raw_bytes, a, rh, rw, q1, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_proxy_async();
    __syncthreads();
    convert_rel(sR, raws + st * raw_bytes / 2, a, t * kBQ, tid);
    __syncthreads();

    if (active) {
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
      const int q0 = t * kBQ;
      const bool edge = q0 + kBQ > a.S;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float e[8], f[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = 8 * kk + i;
          const int qc = 16 * kk + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const int chh = (i & 2) ? ch1 : ch0;
          const int cww = (i & 2) ? cw1 : cw0;
          const float x = s[idx] * sl2 +
                          (rel[chh + qc] + rel[cww + qc]) * kLog2e -
                          lse[qc] * kLog2e;
          float p = exp2f(x);
          if (edge && q0 + qc >= a.S) p = 0.f;
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

// Whether the base pointers and row strides keep every row of q, k, v, dO,
// dk and dv 16-byte aligned, and each (batch, head) block of the term
// tables contiguous and 16-byte aligned, as the 16-byte copies and stores
// need (an odd grid, as 7 x 7, leaves the tables' blocks unaligned).
inline bool aligned16(const BwdArgs& a) {
  const void* p[] = {a.q, a.k, a.v, a.dout, a.dk, a.dv, a.rh, a.rw};
  for (const void* x : p)
    if (reinterpret_cast<uintptr_t>(x) % 16) return false;
  return a.xs.b % 8 == 0 && a.xs.s % 8 == 0 && a.xs.h % 8 == 0 &&
         a.rhs.s == a.gh && a.rws.s == a.gw && a.rhs.b % 8 == 0 &&
         a.rhs.h % 8 == 0 && a.rws.b % 8 == 0 && a.rws.h % 8 == 0;
}

// Launch one instantiation on `stream`, opted into its dynamic shared
// memory and the largest carve-out; returns cudaGetLastError(). The grid:
// (batch, head) pairs on x, blocks of kKeys keys on y.
template <int D, typename Kernel>
inline int launch_dkv(Kernel kernel, const BwdArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(a.gh, a.gw);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B * a.H, (a.S + kKeys - 1) / kKeys);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tcb
}  // namespace grove

// Define the __global__ instantiations of the tensor-core dkv entry and a
// host dispatcher `NAME_tc_dispatch` over (dtype, head_dim): bf16 (dtype 1)
// at D 64, 80 or 128, 16-byte-aligned rows, the rel-pos term tables, no
// causal mask; anything else is refused with cudaErrorInvalidValue. One
// block an SM (up to 255 registers a thread).
#define GROVE_DKV_TC_ENTRY(NAME)                                              \
  template <int D>                                                            \
  __global__ void __launch_bounds__(grove::tcb::kThreads, 1)                  \
      NAME##_tc_kernel(const grove::BwdArgs a) {                              \
    grove::tcb::dkv_block_tc<D>(a);                                           \
  }                                                                           \
  static int NAME##_tc_dispatch(const grove::BwdArgs& a, int dtype, int d,    \
                                cudaStream_t st) {                            \
    if (dtype != 1 || !grove::tcb::aligned16(a) || a.rh == nullptr ||         \
        a.gh < 1 || a.gw < 1 || a.causal || a.S < 1)                          \
      return (int)cudaErrorInvalidValue;                                      \
    if (d == 64) return grove::tcb::launch_dkv<64>(NAME##_tc_kernel<64>, a, st); \
    if (d == 80) return grove::tcb::launch_dkv<80>(NAME##_tc_kernel<80>, a, st); \
    if (d == 128)                                                             \
      return grove::tcb::launch_dkv<128>(NAME##_tc_kernel<128>, a, st);      \
    return (int)cudaErrorInvalidValue;                                        \
  }
