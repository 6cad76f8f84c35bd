// K13: SAM rel-pos attention, the TPU's "bias folded into the contraction"
// experiments, in head layout (v1) and raw projection layout (v2).
//
// Replaces grove_tpu/ops/sam_attention.py:_folded_kernel (its pallas_call is
// at :327, reached through folded_window_attention_relpos, :306) and
// _folded_kernel_v2 (pallas_call :818, through
// folded_window_attention_relpos_v2, :800). Both are documented experiments
// there (:272-276, :752-754); no model path calls them.
//
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] * scale
//                            + rel_h[b, h, i, j / gw] + rel_w[b, h, i, j % gw])
//                  . v[b, j, h]                      (max-subtracted)
//
// The TPU kernels compute the logits as ONE contraction,
// [q * scale | rel_h | rel_w] @ [k | onehot(j / gw) | onehot(j % gw)]^T,
// a device for the TPU's matrix unit (one K = D + gh + gw pass instead of
// three dots and two (S, S) adds). The one-hot columns select exactly the
// bias terms, so the function is the decomposed rel-pos attention of K2;
// the fold is not carried over. Both layouts give K2's arguments
// (grove::grid_args): v1's q, k, v, out (B, S, H, D) and v2's raw
// (B, S, H * D), head h at lane offset h * D, are the same memory, and both
// take the term tables rel_h (B, H, S, gh), rel_w (B, H, S, gw), K2's
// layout (the TPU v2 wrapper transposes them to (B, S, H * g) for its lane
// slices). The entries:
//   * grove_folded_window_attention_tc (v1) and
//     grove_folded_window_attention_v2_tc (v2): bf16 at head dims 64, 80
//     and 128, chosen by the wrappers (ops/sam_attention.py through
//     ops/attention.py `_tc_takes`), on the tensor-core body
//     (attention_tc.cuh, K2's BIAS instantiation, as K11 runs it: wgmma,
//     64-key tiles, the bias added in fp32 after the scaled product, P
//     rounded to bf16 before P.V). Both run the one instantiation,
//     folded_window_attention_tc_kernel, since the two layouts are the same
//     memory. At the windowed (144, 196, 16, 80) shape each (window, head)
//     runs 2 blocks of 128 rows over 4 key tiles, the last holding 4 keys;
//   * grove_folded_window_attention (v1) and grove_folded_window_attention_v2
//     (v2), in fp32 and at the head dim 8, on the SIMT body
//     (attention_core.cuh: fp32 FMA issue and shared-memory reads, far from
//     either bound).
//
// Bound on the H100: bytes at the windowed (144, 196, 16, 80) bf16 shape
// (q, k, v, out 289 MB, terms 25 MB over 3.35 TB/s, 0.0938 ms, against
// 28.3 GFLOP, 0.0286 ms at 989 TFLOP/s bf16).
//
// Numerics against the TPU kernels: all subtract the row max and take the
// denominator from the unrounded fp32 probabilities. The TPU kernels round
// q * scale to the input dtype before the contraction (`:288`, `:777`) and the
// probabilities before P.V; the tensor-core body scales the fp32 product
// of the unscaled bf16 q (a recorded difference) and rounds the
// probabilities to bf16 as the TPU does; the SIMT body keeps fp32
// throughout.

#include "attention_core.cuh"
#include "attention_tc.cuh"

GROVE_ATTENTION_ENTRY(folded_window_attention)
GROVE_ATTENTION_TC_ENTRY(folded_window_attention, true, false)

// The SIMT body: fp32 or bf16, head dims 8, 64, 80, 128.
extern "C" int grove_folded_window_attention(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* out, int b, int s, int heads, int head_dim,
    int gh, int gw, float scale, int dtype, void* stream) {
  const grove::AttnArgs a = grove::grid_args(q, k, v, rel_h, rel_w, out, b,
                                             s, heads, head_dim, gh, gw,
                                             scale);
  return folded_window_attention_dispatch(a, dtype, head_dim,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" int grove_folded_window_attention_v2(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* out, int b, int s, int heads, int head_dim,
    int gh, int gw, float scale, int dtype, void* stream) {
  const grove::AttnArgs a = grove::grid_args(q, k, v, rel_h, rel_w, out, b,
                                             s, heads, head_dim, gh, gw,
                                             scale);
  return folded_window_attention_dispatch(a, dtype, head_dim,
                                          static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_tc.cuh): bf16, head dims 64, 80, 128.
// v1's (B, S, H, D) and v2's raw (B, S, H * D) are the same memory, so both
// entries run the one instantiation.
extern "C" int grove_folded_window_attention_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* out, int b, int s, int heads, int head_dim,
    int gh, int gw, float scale, int dtype, void* stream) {
  return folded_window_attention_tc_dispatch(
      grove::grid_args(q, k, v, rel_h, rel_w, out, b, s, heads, head_dim, gh,
                       gw, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}

extern "C" int grove_folded_window_attention_v2_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* out, int b, int s, int heads, int head_dim,
    int gh, int gw, float scale, int dtype, void* stream) {
  return folded_window_attention_tc_dispatch(
      grove::grid_args(q, k, v, rel_h, rel_w, out, b, s, heads, head_dim, gh,
                       gw, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}
