// K11: streamed rel-pos flash attention over a full grid, max-subtracted.
//
// Replaces grove_tpu/ops/sam_attention.py:_kernel (its pallas_call is at
// :133, reached through flash_attention_relpos, :111, and from
// _fused_relpos_attention / _fused_with_vjp, :901-943). No model path of the
// JAX package calls it: it was the first SAM attention kernel, replaced by
// K2 (global) and K1 (windowed).
//
//   out[b, i, h] = sum_j p_ij v[b, j, h] / max(sum_j p_ij, 1e-30),
//   p_ij = exp(s_ij - max_j s_ij),
//   s_ij = q[b, i, h] . k[b, j, h] * scale
//          + rel_h[b, h, i, j / gw] + rel_w[b, h, i, j % gw]
//
// q, k, v, out are (B, S, H, D); rel_h is (B, H, S, gh) and rel_w
// (B, H, S, gw), as grove_tpu_torch.ops.sam_attention.relpos_terms makes
// them: K2's layout. The TPU kernel streams kv blocks of block_k keys
// (block_k a multiple of gw) with an online softmax, and rebuilds each bias
// block with 0/1 expansion matmuls because Mosaic could not slice lanes;
// here the shared body (attention_core.cuh) streams key tiles of 32 and
// rebuilds the bias per (row, key) from the term tables staged in shared
// memory. Its block sizes do not change the function, so the wrapper keeps
// JAX's checks on them and the kernel ignores them.
//
// Bound on the H100: at the global shape (16, 1024, 16, 80) the operations
// (~86 GFLOP against 989 TFLOP/s bf16); the kernel runs on the fp32 CUDA
// cores (see attention_core.cuh).
//
// Numerics against the TPU kernel: both subtract a running max; the TPU
// kernel rounds the probabilities to the input dtype before P.V, this
// kernel keeps them in fp32.

#include "attention_core.cuh"

GROVE_ATTENTION_ENTRY(streamed_relpos_attention)

extern "C" int grove_relpos_flash_attention(const void* q, const void* k,
                                            const void* v, const void* rel_h,
                                            const void* rel_w, void* out,
                                            int b, int s, int heads,
                                            int head_dim, int gh, int gw,
                                            float scale, int dtype,
                                            void* stream) {
  const long long hd = (long long)heads * head_dim;
  grove::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
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
  return streamed_relpos_attention_dispatch(
      a, dtype, head_dim, static_cast<cudaStream_t>(stream));
}
