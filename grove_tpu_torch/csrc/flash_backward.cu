// K4b: flash attention backward, dq and (dk, dv), for the LLaMA backward of
// the training step.
//
// Replaces grove_tpu/ops/flash_backward.py:_dq_kernel (pallas_call at :253)
// and _dkv_kernel (pallas_call at :278), reached through flash_backward
// (:236) as the backward of flash_attention_trainable, whose forward is K4
// (flash_forward_lse.cu). Used by the 32 decoder layers of LLaMA-7B in the
// teacher-forced training pass (B = 1, S = 704, 32 heads, D = 128, causal).
//
//   dq[b, i, h]  = scale * sum_j ds_ij k[b, j, h]
//   dk[b, j, h]  = scale * sum_i ds_ij q[b, i, h]
//   dv[b, j, h]  = sum_i p_ij dO[b, i, h]
//   p_ij = exp(q.k * scale - lse_i),  ds_ij = p_ij (dO_i . v_j - D_i)
//
// q, k, v, dO and the outputs are (B, S, H, D); lse and D = rowsum(dO * O)
// are (B, H, S) fp32 (the wrapper computes D in torch ops, as the JAX
// package computes it in XLA, flash_backward.py:247). Any S is taken.
//
// The S x S probabilities are recomputed per tile from the LSE and never
// reach device memory. dq and dkv have two entries each, chosen by the
// wrapper (ops/flash_backward.py through ops/attention.py `_tc_takes`, by
// dtype and head dim only):
//   * `grove_flash_backward_dkv_tc` runs bf16 at head dims 64, 80 and 128
//     on the tensor-core backward body (attention_bwd_tc.cuh,
//     `dkv_block_tc` without the bias, causal or not): a block owns 128 keys
//     and streams the query tiles from the one that holds its first key;
//     P^T and dS^T are rounded to bf16 as wgmma's register A operand, where
//     the TPU kernel keeps them in fp32 (a recorded difference). Bound on
//     the H100 at (1, 704, 32, 128) causal: bytes, q, k, v, dO, dk and dv
//     (34.6 MB) and LSE and D once, 0.0104 ms at 3.35 TB/s (its 4 matmuls
//     over the 248,160 causal pairs, 8.1 GFLOP, take 0.0082 ms at 989
//     TFLOP/s bf16);
//   * `grove_flash_backward_dq_tc` runs the same cases on the same body
//     (`dq_block_tc` without the bias, causal or not): a block owns 128
//     query rows and streams the key tiles up to the one that holds its
//     last row, heaviest block first; S = Q.K^T and dP = dO.V^T on wgmma
//     from shared memory, dS rounded to bf16 as the register A operand of
//     dq += dS.K, where the TPU kernel keeps it in fp32 (the same recorded
//     difference). Bound on the H100 at (1, 704, 32, 128) causal: bytes,
//     q, k, v, dO and dq (28.8 MB) and LSE and D once, 0.0087 ms at 3.35
//     TB/s (its 3 matmuls over the causal pairs, 6.1 GFLOP, take 0.0062
//     ms);
//   * `grove_flash_backward_dq` and `grove_flash_backward_dkv` run fp32
//     and the head dim 8 on the SIMT body (attention_bwd_core.cuh: fp32 FMA
//     issue and shared-memory reads, far from either bound).

#include "attention_bwd_core.cuh"
#include "attention_bwd_tc.cuh"

GROVE_BWD_ENTRY(flash_backward_dq, dq)
GROVE_BWD_ENTRY(flash_backward_dkv, dkv)
GROVE_DQ_TC_ENTRY(flash_backward_dq, false)
GROVE_DKV_TC_ENTRY(flash_backward_dkv, false)

namespace {

grove::BwdArgs causal_args(const void* q, const void* k, const void* v,
                           const void* g, const float* lse, const float* dcap,
                           int b, int s, int heads, int head_dim, int causal,
                           float scale) {
  const long long hd = (long long)heads * head_dim;
  grove::BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = g;
  a.lse = lse;
  a.dcap = dcap;
  a.rh = nullptr;
  a.rw = nullptr;
  a.xs = {s * hd, hd, head_dim};
  a.B = b;
  a.H = heads;
  a.S = s;
  a.gh = 0;
  a.gw = 1;
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace

extern "C" int grove_flash_backward_dq(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const float* lse, const float* dcap,
                                       void* dq, int b, int s, int heads,
                                       int head_dim, int causal, float scale,
                                       int dtype, void* stream) {
  grove::BwdArgs a = causal_args(q, k, v, g, lse, dcap, b, s, heads,
                                 head_dim, causal, scale);
  a.dq = dq;
  return flash_backward_dq_dispatch(a, dtype, head_dim,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int grove_flash_backward_dkv(const void* q, const void* k,
                                        const void* v, const void* g,
                                        const float* lse, const float* dcap,
                                        void* dk, void* dv, int b, int s,
                                        int heads, int head_dim, int causal,
                                        float scale, int dtype,
                                        void* stream) {
  grove::BwdArgs a = causal_args(q, k, v, g, lse, dcap, b, s, heads,
                                 head_dim, causal, scale);
  a.dk = dk;
  a.dv = dv;
  return flash_backward_dkv_dispatch(a, dtype, head_dim,
                                     static_cast<cudaStream_t>(stream));
}

// The tensor-core backward body (attention_bwd_tc.cuh): bf16, head dims 64,
// 80, 128.
extern "C" int grove_flash_backward_dq_tc(const void* q, const void* k,
                                          const void* v, const void* g,
                                          const float* lse, const float* dcap,
                                          void* dq, int b, int s, int heads,
                                          int head_dim, int causal,
                                          float scale, int dtype,
                                          void* stream) {
  grove::BwdArgs a = causal_args(q, k, v, g, lse, dcap, b, s, heads,
                                 head_dim, causal, scale);
  a.dq = dq;
  return flash_backward_dq_tc_dispatch(a, dtype, head_dim,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int grove_flash_backward_dkv_tc(const void* q, const void* k,
                                           const void* v, const void* g,
                                           const float* lse,
                                           const float* dcap, void* dk,
                                           void* dv, int b, int s, int heads,
                                           int head_dim, int causal,
                                           float scale, int dtype,
                                           void* stream) {
  grove::BwdArgs a = causal_args(q, k, v, g, lse, dcap, b, s, heads,
                                 head_dim, causal, scale);
  a.dk = dk;
  a.dv = dv;
  return flash_backward_dkv_tc_dispatch(a, dtype, head_dim,
                                        static_cast<cudaStream_t>(stream));
}
