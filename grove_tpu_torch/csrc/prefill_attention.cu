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
// Two entries, chosen by the wrapper (ops/attention.py `_tc_takes`):
//   * `grove_prefill_attention_tc` runs bf16 at head dims 64, 80 and 128 on
//     the tensor-core body (attention_tc.cuh: wgmma, the pad as a
//     per-element mask on the key tiles that start below it, the tiles past
//     it unmasked). Bound on the H100 at (2, 640, 4096), 32 heads, pads
//     (0, 37): bytes, its 41.9 MB of q, k, v and out in 0.0125 ms at 3.35
//     TB/s (4 D flops for each of the 12.4 M valid (row, key) pairs, 6.3
//     GFLOP, take 0.0064 ms at 989 TFLOP/s bf16); a causal block stops at
//     the key tile holding its last row and the heaviest blocks launch
//     first, as for K4;
//   * `grove_prefill_attention` runs fp32 and the head dim 8 on the SIMT
//     body (attention_core.cuh: fp32 FMA issue and shared-memory reads, far
//     from either bound).
//
// Numerics against the TPU kernel: the TPU kernel masks to -1e30, takes one
// softmax over the whole row, rounds the probabilities to the input dtype
// before P.V and divides by the fp32 sum of the unrounded ones. The
// tensor-core body takes an online softmax over 64-key tiles (exp2 in log2
// units) with those same two rounding points; the SIMT body keeps the
// probabilities in fp32. Both agree with the TPU kernel to bf16 rounding.

#include "attention_core.cuh"
#include "attention_tc.cuh"

GROVE_ATTENTION_ENTRY(prefill_attention)
GROVE_ATTENTION_TC_ENTRY(prefill_attention, false, false)

static grove::AttnArgs prefill_args(const void* q, const void* k,
                                    const void* v, const int* pad, void* out,
                                    int b, int s, int heads, int head_dim,
                                    float scale) {
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
  return a;
}

// The SIMT body: fp32 or bf16, head dims 8, 64, 80, 128.
extern "C" int grove_prefill_attention(const void* q, const void* k,
                                       const void* v, const int* pad,
                                       void* out, int b, int s, int heads,
                                       int head_dim, float scale, int dtype,
                                       void* stream) {
  return prefill_attention_dispatch(
      prefill_args(q, k, v, pad, out, b, s, heads, head_dim, scale), dtype,
      head_dim, static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_tc.cuh): bf16, head dims 64, 80, 128.
extern "C" int grove_prefill_attention_tc(const void* q, const void* k,
                                          const void* v, const int* pad,
                                          void* out, int b, int s, int heads,
                                          int head_dim, float scale,
                                          int dtype, void* stream) {
  return prefill_attention_tc_dispatch(
      prefill_args(q, k, v, pad, out, b, s, heads, head_dim, scale), dtype,
      head_dim, static_cast<cudaStream_t>(stream));
}
