// K12 and K12q8: windowed SAM attention with decomposed rel-pos bias, reading
// SPLIT raw q, k and v projections.
//
// Replaces grove_tpu/ops/sam_attention.py:_grouped_kernel_v2 (pallas_calls
// at :598, through grouped_window_attention_relpos_v2 and
// sam_window_attention_raw, and at :640 with quantize=True, through
// grouped_window_attention_relpos_v2_q8 and sam_window_attention_raw_q8).
// No model path of the JAX package calls it: the fused-qkv v3 kernel (K1,
// sam_window_attention.cu) replaced it in SamAttention.
//
//   out[w, i, h] = softmax_j(q_h[i] . k_h[j] * scale
//                            + rel_h[w, i, h, j / gw] + rel_w[w, i, h, j % gw])
//                  . v_h[j]
//
// q, k and v are three (nW, S, C) tensors with C = heads * head_dim, head h
// at lane offset h*D of each row; rel is (nW, S, heads*(gh + gw)), per head
// [rel_h | rel_w], as grove_tpu_torch.ops.sam_attention.relpos_terms_raw
// packs it. out is (nW, S, C) in q's dtype (K12), or int8 (K12q8):
//
//   out_q8 = clip(rint(out * inv_scale), -127, 127),
//
// inv_scale a (1,) fp32 tensor on the card, as K1q reads it.
//
// This is K1's function and contract (the all-underflow rows are 0,
// zero_underflow) with the row stride C instead of 3C: K12 is K1 on split
// inputs, K12q8 K1q. Two entries each, chosen by the wrapper
// (ops/sam_attention.py through ops/attention.py `_tc_takes`, by dtype and
// head dim only):
//   * `grove_sam_window_attention_v2_tc` (K12) and
//     `grove_sam_window_attention_v2_q8_tc` (K12q8) run bf16 at head dims
//     64, 80 and 128 on the tensor-core body (attention_tc.cuh, K1's and
//     K1q's packed-table instantiations, which read q, k and v through
//     strides: wgmma, 64-key tiles, the packed term table staged in shared
//     memory, P rounded to bf16 before P.V; K12q8's int8 rows leave in
//     16-byte stores as K1q's). At the full-width shape (nW = 144, S = 196,
//     16 heads, D = 80) each (window, head) runs 2 blocks of 128 rows over
//     4 key tiles, the last holding 4 keys, as K1;
//   * `grove_sam_window_attention_v2` and `grove_sam_window_attention_v2_q8`
//     run fp32 and the head dim 8 on the SIMT body (attention_core.cuh:
//     fp32 FMA issue and shared-memory reads, far from either bound).
//
// Numerics against the TPU kernel, K1's recorded differences: the TPU
// kernel folds scale * log2(e) into a bf16 q and log2(e) into the bf16
// terms in its wrapper (:590-593), runs exp2 at a fixed EXP2_SHIFT instead
// of subtracting the row max, and takes its denominator from the rounded
// probabilities through a dot (:418-429). Both bodies take scale * log2(e)
// and log2(e) in fp32, subtract a running max and sum the fp32
// probabilities; the tensor-core body rounds them to bf16 before P.V, as
// the TPU kernel does, the SIMT body keeps them in fp32 (see kExp2Shift in
// attention_core.cuh and sam_window_attention.cu's note).
//
// Bound on the H100: bytes (q, k, v 217 MB, rel 25 MB, out 72 MB in bf16 or
// 36 MB in int8 at the full-width (144, 196, 1280) on 14 x 14, 0.0938 ms
// (K12q8 0.0830) over 3.35 TB/s, against 28.3 GFLOP, 0.0286 ms at
// 989 TFLOP/s bf16), as K1 and K1q.

#include "attention_core.cuh"
#include "attention_tc.cuh"

GROVE_ATTENTION_ENTRY(sam_window_attention_v2)
GROVE_ATTENTION_TC_ENTRY(sam_window_attention_v2, true, false)
GROVE_ATTENTION_TC_ENTRY(sam_window_attention_v2_q8, true, true)

namespace {

grove::AttnArgs split_args(const void* q, const void* k, const void* v,
                           const void* rel, void* out, int nw, int s,
                           int heads, int head_dim, int gh, int gw,
                           float scale, int dtype) {
  const long long esize = dtype == 0 ? 4 : 2;
  const long long c = (long long)heads * head_dim;
  const long long gs = gh + gw;
  grove::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = nullptr;
  a.rh = rel;
  a.rw = static_cast<const char*>(rel) + gh * esize;
  a.qs = {s * c, c, head_dim};
  a.ks = a.qs;
  a.vs = a.qs;
  a.os = a.qs;
  a.rhs = {s * heads * gs, heads * gs, gs};
  a.rws = a.rhs;
  a.B = nw;
  a.H = heads;
  a.S = s;
  a.gh = gh;
  a.gw = gw;
  a.scale = scale;
  a.causal = 0;
  a.zero_underflow = 1;
  return a;
}

}  // namespace

// The SIMT body: fp32 or bf16, head dims 8, 64, 80, 128.
extern "C" int grove_sam_window_attention_v2(const void* q, const void* k,
                                             const void* v, const void* rel,
                                             void* out, int nw, int s,
                                             int heads, int head_dim, int gh,
                                             int gw, float scale, int dtype,
                                             void* stream) {
  const grove::AttnArgs a = split_args(q, k, v, rel, out, nw, s, heads,
                                       head_dim, gh, gw, scale, dtype);
  return sam_window_attention_v2_dispatch(a, dtype, head_dim,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" int grove_sam_window_attention_v2_q8(
    const void* q, const void* k, const void* v, const void* rel,
    const void* inv_scale, void* out, int nw, int s, int heads, int head_dim,
    int gh, int gw, float scale, int dtype, void* stream) {
  grove::AttnArgs a = split_args(q, k, v, rel, out, nw, s, heads, head_dim,
                                 gh, gw, scale, dtype);
  a.out_inv = static_cast<const float*>(inv_scale);
  return sam_window_attention_v2_dispatch(a, dtype, head_dim,
                                          static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_tc.cuh): bf16, head dims 64, 80, 128.
extern "C" int grove_sam_window_attention_v2_tc(
    const void* q, const void* k, const void* v, const void* rel, void* out,
    int nw, int s, int heads, int head_dim, int gh, int gw, float scale,
    int dtype, void* stream) {
  return sam_window_attention_v2_tc_dispatch(
      split_args(q, k, v, rel, out, nw, s, heads, head_dim, gh, gw, scale,
                 dtype),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}

extern "C" int grove_sam_window_attention_v2_q8_tc(
    const void* q, const void* k, const void* v, const void* rel,
    const void* inv_scale, void* out, int nw, int s, int heads, int head_dim,
    int gh, int gw, float scale, int dtype, void* stream) {
  grove::AttnArgs a = split_args(q, k, v, rel, out, nw, s, heads, head_dim,
                                 gh, gw, scale, dtype);
  a.out_inv = static_cast<const float*>(inv_scale);
  return sam_window_attention_v2_q8_tc_dispatch(
      a, dtype, head_dim, static_cast<cudaStream_t>(stream));
}
