// K5: causal prefill attention with left-pad masking, in the RAW
// (B, S, H*D) layout of the q/k/v projections (LLaMA prefill over the int8
// KV cache, and the cache-free pass at a ragged S).
//
// Replaces grove_tpu/ops/attention.py:_prefill_kernel (its pallas_call is at
// :248, reached through prefill_attention_raw, :230, and
// prefill_attention_trainable), used by models/llama.py:249-262 at the
// full-width shape (2, 640, 4096): 32 heads, D = 128.
//
//   out[b, i, h] = softmax_j(q_h[i] . k_h[j] * scale) . v_h[j]
//   over j with (j <= i) && ((j >= pad[b]) || (j == i))
//
// q, k, v, out are (B, S, H*D): head h of row i sits at i*H*D + h*D, so the
// kernel reads the projections in place and no head-major copy exists. pad
// is a (B,) int32 device array (0 = pure causal). A row inside the pad
// attends to itself only, as on the TPU (a fully masked row would give NaN
// and poison later layers through its k/v).
//
// Bound on the H100: fp32 FMA issue and shared-memory reads (see
// attention_core.cuh); a causal block stops at the key tile holding its last
// row, so the masked upper triangle costs nothing, where the TPU kernel took
// one full-S softmax per (batch, head group).
//
// Numerics against the TPU kernel: the TPU kernel masks to -1e30, takes one
// softmax over the whole row, rounds the probabilities to the input dtype
// before P.V and divides by the fp32 sum of the unrounded ones. This kernel
// takes an online softmax over key tiles in fp32 (exp2 in log2 units) and
// keeps the probabilities in fp32; the two agree to bf16 rounding.

#include "attention_core.cuh"

GROVE_ATTENTION_ENTRY(prefill_attention)

extern "C" int grove_prefill_attention(const void* q, const void* k,
                                       const void* v, const int* pad,
                                       void* out, int b, int s, int heads,
                                       int head_dim, float scale, int dtype,
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
  a.pad = pad;
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
  a.causal = 1;
  a.zero_underflow = 0;
  return prefill_attention_dispatch(a, dtype, head_dim,
                                    static_cast<cudaStream_t>(stream));
}
