// K10: online-softmax flash attention forward, causal or not, over query and
// key lengths that may differ and need not be multiples of any block (the
// LLaMA cache-free pass at a ragged S, e.g. the training driver's
// 1536 + 575 = 2111 tokens).
//
// Replaces grove_tpu/ops/attention.py:_flash_kernel (its pallas_call is at
// :154, reached through flash_attention, :109, and _flash_with_vjp, :306),
// used at the full-width shape (1, 2111, 32, 128) bf16, causal.
//
//   out[b, i, h] = sum_j p_ij v[b, j, h] / sum_j p_ij
//   p_ij = exp(q[b, i, h] . k[b, j, h] * scale - m_i)
//
// over j < Sk, and with `causal` over j <= i: the TPU kernel's mask is top
// left aligned (its qpos is the query's own index, with no Sk - Sq offset).
// q and out are (B, Sq, H, D), k and v (B, Sk, H, D), read and written in
// place: the TPU wrapper's zero-padded copies and its (B*H, S, D) fold
// exist nowhere here, and the ragged tail of the keys is masked in the
// kernel (attention_core.cuh).
//
// Two entries, chosen by the wrapper (ops/attention.py `_tc_takes`):
// `grove_flash_attention_tc` runs bf16 at head dims 64, 80 and 128 on the
// tensor-core body (attention_tc.cuh: wgmma, bounded by the bf16 tensor
// rate); `grove_flash_attention` runs fp32 and the head dim 8 on the
// SIMT body (attention_core.cuh: fp32 FMA issue and shared-memory reads, far
// from that rate). In both a causal block stops at the key tile holding its
// last row, so the masked upper triangle costs nothing.
//
// Numerics against the TPU kernel: both scale q in fp32 before the dot and
// keep an online softmax in fp32; the TPU kernel masks to -1e30 and floors
// the denominator at 1e-30, this body masks to -inf and floors at 1e-30.
// Every row sees key 0, so no row is fully masked and the two agree. Both
// bodies work in log2 units (exp2f), so results differ in the last bits;
// the tensor-core body also rounds P to bf16 before P.V, where the TPU
// kernel keeps it in fp32.

#include "attention_core.cuh"
#include "attention_tc.cuh"

GROVE_ATTENTION_ENTRY(flash_attention)
GROVE_ATTENTION_TC_ENTRY(flash_attention, false, false)

static grove::AttnArgs flash_args(const void* q, const void* k, const void* v,
                                  void* out, int b, int sq, int sk, int heads,
                                  int head_dim, int causal, float scale) {
  const long long hd = (long long)heads * head_dim;
  grove::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = nullptr;
  a.rh = nullptr;
  a.rw = nullptr;
  a.pad = nullptr;
  a.qs = {sq * hd, hd, head_dim};
  a.ks = {sk * hd, hd, head_dim};
  a.vs = a.ks;
  a.os = a.qs;
  a.B = b;
  a.H = heads;
  a.S = sq;
  a.Sk = sk;
  a.gh = 0;
  a.gw = 1;
  a.scale = scale;
  a.causal = causal;
  a.zero_underflow = 0;
  return a;
}

// The SIMT body: fp32 or bf16, head dims 8, 64, 80, 128.
extern "C" int grove_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int sq,
                                     int sk, int heads, int head_dim,
                                     int causal, float scale, int dtype,
                                     void* stream) {
  return flash_attention_dispatch(
      flash_args(q, k, v, out, b, sq, sk, heads, head_dim, causal, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_tc.cuh): bf16, head dims 64, 80, 128.
extern "C" int grove_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* out, int b,
                                        int sq, int sk, int heads,
                                        int head_dim, int causal, float scale,
                                        int dtype, void* stream) {
  return flash_attention_tc_dispatch(
      flash_args(q, k, v, out, b, sq, sk, heads, head_dim, causal, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}
