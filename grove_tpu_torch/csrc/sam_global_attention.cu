// K2: SAM global attention with decomposed rel-pos bias over the full grid.
//
// Replaces grove_tpu/ops/sam_attention.py:_grouped_kernel (its pallas_call is
// at :235, reached through grouped_window_attention_relpos and
// _grouped_with_vjp, :947), used by the 4 global blocks of the SAM ViT-H
// encoder (indexes 7, 15, 23, 31) at S = 32 x 32 = 1024.
//
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] * scale
//                            + rel_h[b, h, i, j / gw] + rel_w[b, h, i, j % gw])
//                  . v[b, j, h]
//
// q, k, v, out are (B, S, H, D); rel_h is (B, H, S, gh) and rel_w
// (B, H, S, gw), as grove_tpu_torch.ops.sam_attention.relpos_terms makes
// them. A full 1024-wide row does not fit one block's shared memory next to
// its K/V tiles, so the kernel runs an online softmax over key tiles and
// rebuilds each bias tile from the two small term tables in shared memory,
// where the TPU kernel multiplied them by 0/1 expansion matrices
// (sam_attention.py:168-193).
//
// Bound on the H100: fp32 FMA issue and shared-memory reads (see
// attention_core.cuh); the kernel reads q, k, v once per 32-row block and
// writes no S x S intermediate.
//
// Numerics against the TPU kernel: both subtract the row max. The TPU kernel
// rounds the probabilities to the input dtype before P.V; this kernel keeps
// them in fp32.

#include "attention_core.cuh"

GROVE_ATTENTION_ENTRY(sam_global_attention)

extern "C" int grove_sam_global_attention(const void* q, const void* k,
                                          const void* v, const void* rel_h,
                                          const void* rel_w, void* out, int b,
                                          int s, int heads, int head_dim,
                                          int gh, int gw, float scale,
                                          int dtype, void* stream) {
  const long long hd = (long long)heads * head_dim;
  grove::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = nullptr;
  a.rh = rel_h;
  a.rw = rel_w;
  a.qs = {s * hd, hd, head_dim};
  a.ks = a.qs;
  a.vs = a.qs;
  a.os = a.qs;
  a.rhs = {(long long)heads * s * gh, gh, (long long)s * gh};
  a.rws = {(long long)heads * s * gw, gw, (long long)s * gw};
  a.B = b;
  a.H = heads;
  a.S = s;
  a.gh = gh;
  a.gw = gw;
  a.scale = scale;
  a.causal = 0;
  return sam_global_attention_dispatch(a, dtype, head_dim,
                                       static_cast<cudaStream_t>(stream));
}
