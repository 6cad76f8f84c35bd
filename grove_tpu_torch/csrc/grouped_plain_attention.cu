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
// Two entries, chosen by the wrapper (ops/attention.py `_tc_takes`):
// `grove_grouped_plain_attention_tc` runs bf16 at head dims 64, 80 and 128
// on the tensor-core body (attention_tc.cuh: wgmma, bounded by the bf16 tensor
// rate; S = 577 is 4 x 128 + 65 rows and 9 x 64 + 1 keys, so about a tenth
// of its tiles is padding); `grove_grouped_plain_attention` runs fp32 and
// the head dim 8 on the SIMT body (attention_core.cuh: fp32 FMA
// issue and shared-memory reads). Neither writes the (B, H, S, S) logits of
// the plain version to device memory.
//
// Numerics against the TPU kernel: both subtract the row max. The TPU kernel
// normalizes before P.V and rounds the probabilities to the input dtype;
// both bodies here normalize after P.V, the SIMT body keeping P in fp32, the
// tensor-core body rounding it to bf16 as the TPU kernel does.

#include "attention_core.cuh"
#include "attention_tc.cuh"

GROVE_ATTENTION_ENTRY(grouped_plain_attention)
GROVE_ATTENTION_TC_ENTRY(grouped_plain_attention, false, false)

static grove::AttnArgs grouped_args(const void* q, const void* k,
                                    const void* v, void* out, int b, int s,
                                    int heads, int head_dim, float scale) {
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
  return a;
}

// The SIMT body: fp32 or bf16, head dims 8, 64, 80, 128.
extern "C" int grove_grouped_plain_attention(const void* q, const void* k,
                                             const void* v, void* out, int b,
                                             int s, int heads, int head_dim,
                                             float scale, int dtype,
                                             void* stream) {
  return grouped_plain_attention_dispatch(
      grouped_args(q, k, v, out, b, s, heads, head_dim, scale), dtype,
      head_dim, static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_tc.cuh): bf16, head dims 64, 80, 128.
extern "C" int grove_grouped_plain_attention_tc(const void* q, const void* k,
                                                const void* v, void* out,
                                                int b, int s, int heads,
                                                int head_dim, float scale,
                                                int dtype, void* stream) {
  return grouped_plain_attention_tc_dispatch(
      grouped_args(q, k, v, out, b, s, heads, head_dim, scale), dtype,
      head_dim, static_cast<cudaStream_t>(stream));
}
