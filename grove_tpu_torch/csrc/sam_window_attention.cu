// K1 and K1q: windowed SAM attention with decomposed rel-pos bias, reading
// the UNSPLIT qkv projection.
//
// Replaces grove_tpu/ops/sam_attention.py:_grouped_kernel_v3 (its
// pallas_call is at :537, reached through sam_window_attention_fused, :692,
// and with quantize=True through sam_window_attention_fused_q8, :675), used
// by the 28 windowed blocks of the SAM ViT-H encoder: K1 in the bf16 tower,
// K1q in the W8A8-static one, where it writes the int8 input of the proj
// linear directly,
//
//   out_q8 = clip(rint(out * inv_scale), -127, 127),
//   inv_scale = 1 / max(proj_act_scale, 1e-12)
//
// (an all-underflow row is 0 before and after). inv_scale is a (1,) fp32
// tensor on the card, read by the kernel, so the host never syncs on it.
//
//   out[w, i, h] = softmax_j(q_h[i] . k_h[j] * scale
//                            + rel_h[w, i, h, j / gw] + rel_w[w, i, h, j % gw])
//                  . v_h[j]
//
// qkv is (nW, S, 3C) with C = heads * head_dim: q, k and v of head h are
// read in place at lane offsets h*D, C + h*D and 2C + h*D, so the three-way
// split is never materialized. rel is (nW, S, heads*(gh + gw)), per head
// [rel_h | rel_w], as grove_tpu_torch.ops.sam_attention.relpos_terms_raw
// packs it. out is (nW, S, C), in qkv's dtype (K1) or int8 (K1q).
//
// Two entries each, chosen by the wrapper (ops/sam_attention.py through
// ops/attention.py `_tc_takes`, by dtype and head dim only):
//   * `grove_sam_window_attention_tc` and `grove_sam_window_attention_q8_tc`
//     run bf16 at head dims 64, 80 and 128 on the tensor-core body
//     (attention_tc.cuh: wgmma, the packed term table staged in shared
//     memory, the all-underflow rows, K1q's int8 rows written with 16-byte
//     stores). At the full-width shape (nW = 144 for 16 frames, S = 196, 16
//     heads, D = 80) each (window, head) runs 2 blocks of 128 rows over 4
//     key tiles of 64, the last holding 4 keys: (256 x 256) / (196 x 196) =
//     1.71x the useful work of Q.K^T and P.V. Bound on the H100: bytes. The
//     call moves qkv (216.8 MB), the term table (25.3 MB) and out (72.3 MB
//     in bf16, 36.1 MB in int8) once, 0.0938 ms (K1q 0.0830) at 3.35 TB/s,
//     against 28.3 GFLOP, 0.0286 ms at 989 TFLOP/s bf16;
//   * `grove_sam_window_attention` and `grove_sam_window_attention_q8` run
//     fp32 and the head dim 8 on the SIMT body (attention_core.cuh: fp32
//     FMA issue and shared-memory reads, far from either bound; blocks of
//     32 rows, the S x S logits never leave registers).
//
// Numerics against the TPU kernel: the TPU kernel uses exp2 with a constant
// shift (EXP2_SHIFT = 32) instead of subtracting the row max, rounds
// q * scale * log2(e), rel * log2(e) and the probabilities to the input
// dtype, and takes the denominator from the rounded probabilities. Both
// bodies subtract a running max and take the denominator from the fp32
// probabilities; the tensor-core body rounds them to bf16 before P.V, as
// the TPU kernel does, the SIMT body keeps them in fp32. The results agree
// to bf16 rounding. A row whose largest logit (log2 units) lies below
// EXP2_SHIFT - 126 underflows everywhere on the TPU and comes out as 0
// there; both bodies return 0 for it too (zero_underflow, see kExp2Shift in
// attention_core.cuh).

#include "attention_core.cuh"
#include "attention_tc.cuh"

GROVE_ATTENTION_ENTRY(sam_window_attention)
GROVE_ATTENTION_TC_ENTRY(sam_window_attention, true, false)
GROVE_ATTENTION_TC_ENTRY(sam_window_attention_q8, true, true)

namespace {

grove::AttnArgs window_args(const void* qkv, const void* rel, void* out,
                            int nw, int s, int heads, int head_dim, int gh,
                            int gw, float scale, int dtype) {
  const long long esize = dtype == 0 ? 4 : 2;
  const long long c = (long long)heads * head_dim;
  const long long gs = gh + gw;
  const char* base = static_cast<const char*>(qkv);
  grove::AttnArgs a{};
  a.q = base;
  a.k = base + c * esize;
  a.v = base + 2 * c * esize;
  a.o = out;
  a.lse = nullptr;
  a.rh = rel;
  a.rw = static_cast<const char*>(rel) + gh * esize;
  a.qs = {s * 3 * c, 3 * c, head_dim};
  a.ks = a.qs;
  a.vs = a.qs;
  a.os = {s * c, c, head_dim};
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
extern "C" int grove_sam_window_attention(const void* qkv, const void* rel,
                                          void* out, int nw, int s,
                                          int heads, int head_dim, int gh,
                                          int gw, float scale, int dtype,
                                          void* stream) {
  const grove::AttnArgs a = window_args(qkv, rel, out, nw, s, heads,
                                        head_dim, gh, gw, scale, dtype);
  return sam_window_attention_dispatch(a, dtype, head_dim,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int grove_sam_window_attention_q8(
    const void* qkv, const void* rel, const void* inv_scale, void* out,
    int nw, int s, int heads, int head_dim, int gh, int gw, float scale,
    int dtype, void* stream) {
  grove::AttnArgs a = window_args(qkv, rel, out, nw, s, heads, head_dim, gh,
                                  gw, scale, dtype);
  a.out_inv = static_cast<const float*>(inv_scale);
  return sam_window_attention_dispatch(a, dtype, head_dim,
                                       static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_tc.cuh): bf16, head dims 64, 80, 128.
extern "C" int grove_sam_window_attention_tc(const void* qkv, const void* rel,
                                             void* out, int nw, int s,
                                             int heads, int head_dim, int gh,
                                             int gw, float scale, int dtype,
                                             void* stream) {
  return sam_window_attention_tc_dispatch(
      window_args(qkv, rel, out, nw, s, heads, head_dim, gh, gw, scale,
                  dtype),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}

extern "C" int grove_sam_window_attention_q8_tc(
    const void* qkv, const void* rel, const void* inv_scale, void* out,
    int nw, int s, int heads, int head_dim, int gh, int gw, float scale,
    int dtype, void* stream) {
  grove::AttnArgs a = window_args(qkv, rel, out, nw, s, heads, head_dim, gh,
                                  gw, scale, dtype);
  a.out_inv = static_cast<const float*>(inv_scale);
  return sam_window_attention_q8_tc_dispatch(
      a, dtype, head_dim, static_cast<cudaStream_t>(stream));
}
