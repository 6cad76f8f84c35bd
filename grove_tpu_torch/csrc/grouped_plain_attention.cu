// K3: non-causal self-attention over a ragged sequence (CLIP ViT-L).
//
// Replaces grove_tpu/ops/attention.py:_grouped_plain_kernel (its pallas_call
// is at :404, reached through grouped_plain_attention and
// multi_head_attention(impl="grouped")), used by the 24 CLIP layers at
// S = 577 (576 patches + cls), 16 heads, D = 64.
//
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] * scale) . v[b, j, h]
//
// q, k, v, out are (B, S, H, D). The TPU wrapper padded S to a multiple of 8
// and masked the pad keys; here the last key tile masks keys at or past S
// and the last row block skips rows past S, so no padded copy is made.
//
// Bound on the H100: fp32 FMA issue and shared-memory reads (see
// attention_core.cuh); the (B, H, S, S) logits of the plain version are
// never written to device memory.
//
// Numerics against the TPU kernel: both subtract the row max. The TPU kernel
// normalizes before P.V and rounds the probabilities to the input dtype;
// this kernel normalizes after P.V and keeps them in fp32.

#include "attention_core.cuh"

GROVE_ATTENTION_ENTRY(grouped_plain_attention)

extern "C" int grove_grouped_plain_attention(const void* q, const void* k,
                                             const void* v, void* out, int b,
                                             int s, int heads, int head_dim,
                                             float scale, int dtype,
                                             void* stream) {
  const long long hd = (long long)heads * head_dim;
  grove::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = nullptr;
  a.rh = nullptr;
  a.rw = nullptr;
  a.qs = {s * hd, hd, head_dim};
  a.ks = a.qs;
  a.vs = a.qs;
  a.os = a.qs;
  a.B = b;
  a.H = heads;
  a.S = s;
  a.gh = 0;
  a.gw = 1;
  a.scale = scale;
  a.causal = 0;
  return grouped_plain_attention_dispatch(a, dtype, head_dim,
                                          static_cast<cudaStream_t>(stream));
}
