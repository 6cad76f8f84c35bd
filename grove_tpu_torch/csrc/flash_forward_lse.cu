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
// Any S is taken; the TPU kernel needed S to be a multiple of its block.
//
// Two entries, chosen by the wrapper (ops/flash_backward.py through
// ops/attention.py `_tc_takes`): `grove_flash_forward_lse_tc` runs bf16 at
// head dims 64, 80 and 128 on the tensor-core body (attention_tc.cuh:
// wgmma, bounded by the bf16 tensor rate; the LSE written by one thread per
// row after the key loop; at S = 704 the grid is 6 query blocks over the
// (batch, head) pairs, launched heaviest first); `grove_flash_forward_lse`
// runs fp32 and the head dim 8 on the SIMT body (attention_core.cuh: fp32
// FMA throughput and shared-memory reads, far from that rate).
//
// Numerics against the TPU kernel: both compute the scores and the softmax
// statistics in fp32 from the input values with a running max; both bodies
// here work in log2 units (exp2f), so results differ in the last bits. The
// LSE is m + log(l) in both, l summed over the unrounded fp32 P, so K4b's
// exp(s - lse) sees the same statistics from either body. The tensor-core
// body rounds P to bf16 before P.V, where the TPU kernel (and the SIMT
// body) keep it in fp32.

#include "attention_core.cuh"
#include "attention_tc.cuh"

GROVE_ATTENTION_ENTRY(flash_forward_lse)
GROVE_ATTENTION_TC_ENTRY(flash_forward_lse, false, false)

static grove::AttnArgs lse_args(const void* q, const void* k, const void* v,
                                void* out, float* lse, int b, int s,
                                int heads, int head_dim, int causal,
                                float scale) {
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
  return a;
}

// The SIMT body: fp32 or bf16, head dims 8, 64, 80, 128.
extern "C" int grove_flash_forward_lse(const void* q, const void* k,
                                       const void* v, void* out, float* lse,
                                       int b, int s, int heads, int head_dim,
                                       int causal, float scale, int dtype,
                                       void* stream) {
  return flash_forward_lse_dispatch(
      lse_args(q, k, v, out, lse, b, s, heads, head_dim, causal, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_tc.cuh): bf16, head dims 64, 80, 128.
extern "C" int grove_flash_forward_lse_tc(const void* q, const void* k,
                                          const void* v, void* out,
                                          float* lse, int b, int s,
                                          int heads, int head_dim,
                                          int causal, float scale, int dtype,
                                          void* stream) {
  return flash_forward_lse_tc_dispatch(
      lse_args(q, k, v, out, lse, b, s, heads, head_dim, causal, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}
