// K9: SAM rel-pos flash attention for training: the forward with its LSE,
// dq with the per-row bias-term gradients, and (dk, dv).
//
// Replaces grove_tpu/ops/sam_attention_bwd.py:_fwd_kernel (pallas_call at
// :243, relpos_flash_fwd_lse), _dq_kernel (:294) and _dkv_kernel (:333,
// both relpos_flash_bwd), reached through relpos_flash_attention (:400), the
// backward of the windowed (K1, sam_attention.py:714) and global (K2, :961)
// SAM blocks: at full width 21 windowed blocks at (72, 196, 16, 80) on a
// 14 x 14 grid and 3 global ones at (8, 1024, 16, 80) on 32 x 32 (8 frames,
// the blocks after the first trainable adapter).
//
//   s_ij    = scale * q_i . k_j + rel_h[i, j / gw] + rel_w[i, j % gw]
//   out, lse of softmax_j(s_ij)                       (forward entry)
//   ds_ij   = p_ij (dO_i . v_j - D_i),  p_ij = exp(s_ij - lse_i)
//   dq_i    = scale * sum_j ds_ij k_j                 (dq entry)
//   d_rh[i, a] = sum_{j / gw == a} ds_ij,  d_rw[i, b] = sum_{j % gw == b} ds_ij
//   dk_j    = scale * sum_i ds_ij q_i,  dv_j = sum_i p_ij dO_i   (dkv entry)
//
// q, k, v, dO and the outputs are (B, S, H, D); the term tables rel_h
// (B, H, S, gh), rel_w (B, H, S, gw) as K2 takes them; lse, D (B, H, S) and
// d_rh, d_rw (B, H, S, gh | gw) fp32.
//
// The forward has two entries, chosen by the wrapper
// (ops/sam_attention_bwd.py through ops/attention.py `_tc_takes`, by dtype
// and head dim only):
//   * `grove_relpos_flash_fwd_lse_tc` runs bf16 at head dims 64, 80 and 128
//     on the tensor-core body (attention_tc.cuh), K2's contract with K4's
//     LSE output: the LSE over the unrounded fp32 P, which dq and dkv read
//     back as p = exp(s - lse). Bound on the H100, at the two full-width
//     shapes: (72, 196, 16, 80) moves q, k, v (108.4 MB), the tables (12.6
//     MB), out (36.1 MB) and the LSE (0.9 MB) once, 0.0470 ms at 3.35 TB/s
//     (bytes; 14.2 GFLOP take 0.0143 ms at 989 TFLOP/s bf16), padded in the
//     kernel to 2 query blocks of 128 and 4 key tiles of 64 (1.71x the
//     useful work); (8, 1024, 16, 80) does 42.9 GFLOP, 0.0434 ms
//     (operations; its 101.2 MB take 0.0302 ms);
//   * `grove_relpos_flash_fwd_lse` runs fp32 and the head dim 8 on the SIMT
//     body (attention_core.cuh), far from either bound.
// dkv has two entries too, chosen the same way:
//   * `grove_relpos_flash_dkv_tc` runs bf16 at head dims 64, 80 and 128 on
//     the tensor-core backward body (attention_bwd_tc.cuh): S^T = K.Q^T and
//     dP^T = V.dO^T on wgmma from shared memory, P^T and dS^T rounded to
//     bf16 in registers (the TPU kernel's rounding points, `:186`, `:191`)
//     and fed as wgmma's register A operand to dv += P^T.dO and dk +=
//     dS^T.Q. Bound on the H100, at the two full-width shapes: operations,
//     4 matmuls of 2 S^2 D flops: (72, 196, 16, 80) does 28.3 GFLOP, 0.0286
//     ms at 989 TFLOP/s bf16 (its q, k, v, dO, dk, dv, tables, LSE and D,
//     231.2 MB, take 0.0690 ms at 3.35 TB/s, so bytes bound that shape);
//     (8, 1024, 16, 80) does 85.9 GFLOP, 0.0869 ms (its 143.7 MB take
//     0.0429 ms);
//   * `grove_relpos_flash_dkv` runs fp32, the head dim 8 and an odd grid on
//     the SIMT body (attention_bwd_core.cuh).
// dq has two entries too, chosen the same way:
//   * `grove_relpos_flash_dq_tc` runs bf16 at head dims 64, 80 and 128 on
//     the tensor-core backward body (attention_bwd_tc.cuh, `dq_block_tc`):
//     a block owns 128 query rows and streams K and V, S = Q.K^T and dP =
//     dO.V^T on wgmma from shared memory, dS rounded to bf16 in registers
//     (the TPU kernel's rounding point, `:132`) and fed as the register A
//     operand to dq += dS.K and to the bucket sums [d_rh | d_rw] += dS.E,
//     with the bias T.E^T gathered on the tensor cores too: E is the key
//     tile's 0/1 selector, as the TPU kernel's `_selectors_full` (`:42`).
//     Bound on the H100, at the two full-width shapes: (72, 196, 16, 80)
//     moves q, k, v, dO, the tables, LSE, D, dq and the fp32 d_rh, d_rw
//     (220.4 MB) once, 0.0658 ms at 3.35 TB/s (bytes; its 3 matmuls of 2
//     S^2 D flops, 21.2 GFLOP, take 0.0215 ms at 989 TFLOP/s bf16);
//     (8, 1024, 16, 80) does 64.4 GFLOP, 0.0651 ms (operations; its 156.2
//     MB take 0.0466 ms). It takes gh + gw <= 64 and the term tables'
//     (batch, head) blocks 16-byte aligned, as every SAM grid of the
//     configurations gives;
//   * `grove_relpos_flash_dq` runs fp32, the head dim 8 and an odd grid on
//     the SIMT body (attention_bwd_core.cuh), the bias rebuilt per (row,
//     key) from the term tables as K1 and K2 rebuild it, the buckets summed
//     in registers (fp32 FMA issue and shared-memory reads).
// The host-side contractions (dq += d_rh . Rh + d_rw . Rw, the table
// gradients) stay torch ops, as they are XLA in the JAX package.

#include "attention_bwd_core.cuh"
#include "attention_bwd_tc.cuh"
#include "attention_tc.cuh"

GROVE_ATTENTION_ENTRY(relpos_flash_fwd_lse)
GROVE_ATTENTION_TC_ENTRY(relpos_flash_fwd_lse, true, false)
GROVE_BWD_ENTRY(relpos_flash_dq, dq)
GROVE_DQ_TC_ENTRY(relpos_flash_dq, true)
GROVE_BWD_ENTRY(relpos_flash_dkv, dkv)
GROVE_DKV_TC_ENTRY(relpos_flash_dkv, true)

namespace {

grove::Strides term_strides(int s, int heads, int g) {
  return {(long long)heads * s * g, g, (long long)s * g};
}

grove::BwdArgs relpos_args(const void* q, const void* k, const void* v,
                           const void* rel_h, const void* rel_w,
                           const void* g, const float* lse,
                           const float* dcap, int b, int s, int heads,
                           int head_dim, int gh, int gw, float scale) {
  const long long hd = (long long)heads * head_dim;
  grove::BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = g;
  a.lse = lse;
  a.dcap = dcap;
  a.rh = rel_h;
  a.rw = rel_w;
  a.xs = {s * hd, hd, head_dim};
  a.rhs = term_strides(s, heads, gh);
  a.rws = term_strides(s, heads, gw);
  a.B = b;
  a.H = heads;
  a.S = s;
  a.gh = gh;
  a.gw = gw;
  a.scale = scale;
  a.causal = 0;
  return a;
}

grove::AttnArgs fwd_args(const void* q, const void* k, const void* v,
                         const void* rel_h, const void* rel_w, void* out,
                         float* lse, int b, int s, int heads, int head_dim,
                         int gh, int gw, float scale) {
  const long long hd = (long long)heads * head_dim;
  grove::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = lse;
  a.rh = rel_h;
  a.rw = rel_w;
  a.qs = {s * hd, hd, head_dim};
  a.ks = a.qs;
  a.vs = a.qs;
  a.os = a.qs;
  a.rhs = term_strides(s, heads, gh);
  a.rws = term_strides(s, heads, gw);
  a.B = b;
  a.H = heads;
  a.S = s;
  a.gh = gh;
  a.gw = gw;
  a.scale = scale;
  a.causal = 0;
  return a;
}

}  // namespace

// The SIMT body: fp32 or bf16, head dims 8, 64, 80, 128.
extern "C" int grove_relpos_flash_fwd_lse(const void* q, const void* k,
                                          const void* v, const void* rel_h,
                                          const void* rel_w, void* out,
                                          float* lse, int b, int s, int heads,
                                          int head_dim, int gh, int gw,
                                          float scale, int dtype,
                                          void* stream) {
  return relpos_flash_fwd_lse_dispatch(
      fwd_args(q, k, v, rel_h, rel_w, out, lse, b, s, heads, head_dim, gh,
               gw, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_tc.cuh): bf16, head dims 64, 80, 128.
extern "C" int grove_relpos_flash_fwd_lse_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* out, float* lse, int b, int s, int heads,
    int head_dim, int gh, int gw, float scale, int dtype, void* stream) {
  return relpos_flash_fwd_lse_tc_dispatch(
      fwd_args(q, k, v, rel_h, rel_w, out, lse, b, s, heads, head_dim, gh,
               gw, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}

extern "C" int grove_relpos_flash_dq(const void* q, const void* k,
                                     const void* v, const void* rel_h,
                                     const void* rel_w, const void* g,
                                     const float* lse, const float* dcap,
                                     void* dq, float* d_rh, float* d_rw,
                                     int b, int s, int heads, int head_dim,
                                     int gh, int gw, float scale, int dtype,
                                     void* stream) {
  if (gh + gw > grove::kMaxRel) return (int)cudaErrorInvalidValue;
  grove::BwdArgs a = relpos_args(q, k, v, rel_h, rel_w, g, lse, dcap, b, s,
                                 heads, head_dim, gh, gw, scale);
  a.dq = dq;
  a.drh = d_rh;
  a.drw = d_rw;
  return relpos_flash_dq_dispatch(a, dtype, head_dim,
                                  static_cast<cudaStream_t>(stream));
}

// The tensor-core backward body (attention_bwd_tc.cuh): bf16, head dims 64,
// 80, 128.
extern "C" int grove_relpos_flash_dq_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, const void* g, const float* lse, const float* dcap,
    void* dq, float* d_rh, float* d_rw, int b, int s, int heads,
    int head_dim, int gh, int gw, float scale, int dtype, void* stream) {
  grove::BwdArgs a = relpos_args(q, k, v, rel_h, rel_w, g, lse, dcap, b, s,
                                 heads, head_dim, gh, gw, scale);
  a.dq = dq;
  a.drh = d_rh;
  a.drw = d_rw;
  return relpos_flash_dq_tc_dispatch(a, dtype, head_dim,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int grove_relpos_flash_dkv(const void* q, const void* k,
                                      const void* v, const void* rel_h,
                                      const void* rel_w, const void* g,
                                      const float* lse, const float* dcap,
                                      void* dk, void* dv, int b, int s,
                                      int heads, int head_dim, int gh, int gw,
                                      float scale, int dtype, void* stream) {
  grove::BwdArgs a = relpos_args(q, k, v, rel_h, rel_w, g, lse, dcap, b, s,
                                 heads, head_dim, gh, gw, scale);
  a.dk = dk;
  a.dv = dv;
  return relpos_flash_dkv_dispatch(a, dtype, head_dim,
                                   static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_bwd_tc.cuh): bf16, head dims 64, 80, 128.
extern "C" int grove_relpos_flash_dkv_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, const void* g, const float* lse, const float* dcap,
    void* dk, void* dv, int b, int s, int heads, int head_dim, int gh, int gw,
    float scale, int dtype, void* stream) {
  grove::BwdArgs a = relpos_args(q, k, v, rel_h, rel_w, g, lse, dcap, b, s,
                                 heads, head_dim, gh, gw, scale);
  a.dk = dk;
  a.dv = dv;
  return relpos_flash_dkv_tc_dispatch(a, dtype, head_dim,
                                      static_cast<cudaStream_t>(stream));
}
