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
// This is K1's body and contract (EXP2_SHIFT all-underflow rows are 0,
// zero_underflow) with the row stride C instead of 3C: the TPU kernel
// folded scale * log2(e) into q and log2(e) into rel in its wrapper
// (:590-593) and ran exp2 with a constant shift; the shared body takes
// scale * log2(e) and log2(e) in fp32 and subtracts a running max (see
// kExp2Shift in attention_core.cuh and sam_window_attention.cu's note).
//
// Bound on the H100: bytes (q, k, v 217 MB, rel 25 MB, out 72 MB in bf16 at
// the full-width (144, 196, 1280) on 14 x 14) over 3.35 TB/s, as K1; the
// kernel runs on the fp32 CUDA cores (see attention_core.cuh).

#include "attention_core.cuh"

GROVE_ATTENTION_ENTRY(sam_window_attention_v2)

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
  a.zero_underflow = 1;
  return a;
}

}  // namespace

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
