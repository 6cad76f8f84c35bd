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
// the fold is not carried over. Both entries are contracts of the shared
// body (attention_core.cuh), which rebuilds the bias per (row, key) from
// the term tables in shared memory:
//   * grove_folded_window_attention (v1): q, k, v, out (B, S, H, D); rel_h
//     (B, H, S, gh), rel_w (B, H, S, gw): K2's layout;
//   * grove_folded_window_attention_v2: q, k, v, out raw (B, S, H * D), head
//     h at lane offset h * D; the same (B, H, S, g) term tables (the TPU
//     wrapper transposes them to (B, S, H * g) for its lane slices).
//
// Bound on the H100: bytes at the windowed (144, 196, 16, 80) bf16 shape
// (q, k, v, out 289 MB, terms 25 MB over 3.35 TB/s); the kernel runs on the
// fp32 CUDA cores (see attention_core.cuh).
//
// Numerics against the TPU kernels: both subtract the row max; the TPU
// kernels round q * scale and the probabilities to the input dtype, this
// kernel keeps fp32 throughout.

#include "attention_core.cuh"

GROVE_ATTENTION_ENTRY(folded_window_attention)

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
