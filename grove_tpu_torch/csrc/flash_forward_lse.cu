// K4: flash attention forward with log-sum-exp output (LLaMA teacher-forced
// pass).
//
// Replaces grove_tpu/ops/flash_backward.py:_fwd_kernel (its pallas_call is
// at :210, reached through flash_forward_lse, :196, and
// flash_attention_trainable), used by the cache-free LLaMA-7B pass over the
// sliding windows (S a multiple of 64, about 640-704; 32 heads, D = 128).
//
//   out[b, i, h] = sum_j p_ij v[b, j, h],  p_ij = exp(q.k * scale - lse_i)
//   lse[b, h, i] = log sum_j exp(q[b, i, h] . k[b, j, h] * scale)
//
// with j <= i when causal. q, k, v, out are (B, S, H, D); lse is (B, H, S)
// fp32 (the TPU kernel's (B*H, n_blocks, block) layout was a lane-tiling
// artifact). A causal block stops at the key tile holding its last row.
//
// Bound on the H100: fp32 FMA issue and shared-memory reads (see
// attention_core.cuh). Any S is taken; the TPU kernel needed S to be a
// multiple of its block.
//
// Numerics against the TPU kernel: both compute in fp32 from the input
// values with a running max; this kernel works in log2 units (exp2f), so
// results differ in the last bits.

#include "attention_core.cuh"

GROVE_ATTENTION_ENTRY(flash_forward_lse)

extern "C" int grove_flash_forward_lse(const void* q, const void* k,
                                       const void* v, void* out, float* lse,
                                       int b, int s, int heads, int head_dim,
                                       int causal, float scale, int dtype,
                                       void* stream) {
  const long long hd = (long long)heads * head_dim;
  grove::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = lse;
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
  a.causal = causal;
  return flash_forward_lse_dispatch(a, dtype, head_dim,
                                    static_cast<cudaStream_t>(stream));
}
