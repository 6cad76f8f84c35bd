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
// d_rh, d_rw (B, H, S, gh | gw) fp32. The forward is the shared forward body
// (attention_core.cuh) with K2's contract and K4's LSE output; the backward
// bodies are attention_bwd_core.cuh's, with the bias rebuilt per (row, key)
// from the term tables as K1 and K2 rebuild it. The TPU kernels multiplied
// the tables by 0/1 expansion matrices instead (sam_attention_bwd.py:42-52).
// The host-side contractions (dq += d_rh . Rh + d_rw . Rw, the table
// gradients) stay torch ops, as they are XLA in the JAX package.
//
// Bound on the H100: fp32 FMA issue and shared-memory reads (see
// attention_bwd_core.cuh).

#include "attention_bwd_core.cuh"

GROVE_ATTENTION_ENTRY(relpos_flash_fwd_lse)
GROVE_BWD_ENTRY(relpos_flash_dq, dq)
GROVE_BWD_ENTRY(relpos_flash_dkv, dkv)

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

}  // namespace

extern "C" int grove_relpos_flash_fwd_lse(const void* q, const void* k,
                                          const void* v, const void* rel_h,
                                          const void* rel_w, void* out,
                                          float* lse, int b, int s, int heads,
                                          int head_dim, int gh, int gw,
                                          float scale, int dtype,
                                          void* stream) {
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
  return relpos_flash_fwd_lse_dispatch(a, dtype, head_dim,
                                       static_cast<cudaStream_t>(stream));
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
