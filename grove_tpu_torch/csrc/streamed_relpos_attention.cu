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
// them: K2's layout. This is K2's function in K2's layout, without an LSE,
// so K11 runs K2's bodies. The TPU kernel streams kv blocks of block_k keys
// (block_k a multiple of gw) with an online softmax, and rebuilds each bias
// block with 0/1 expansion matmuls because Mosaic could not slice lanes;
// both bodies here stream key tiles and rebuild the bias per (row, key)
// from the block's rows of the term tables staged in shared memory. Block
// sizes do not change the function, so the wrapper keeps JAX's checks on
// them and the kernels ignore them.
//
// Two entries, chosen by the wrapper (ops/sam_attention.py through
// ops/attention.py `_tc_takes`, by dtype and head dim only):
//   * `grove_relpos_flash_attention_tc` runs bf16 at head dims 64, 80 and
//     128 on the tensor-core body (attention_tc.cuh, K2's BIAS
//     instantiation: wgmma, 64-key tiles, the bias added in fp32 after the
//     scaled product, P rounded to bf16 before P.V). Bound on the H100, at
//     the shapes SAM ViT-H would give it (16 frames): (16, 1024, 16, 80) on
//     32 x 32 does 85.9 GFLOP, 0.0869 ms at 989 TFLOP/s bf16 (operations;
//     q, k, v, out and the tables, 201.3 MB, take 0.0601 ms at 3.35 TB/s);
//     (144, 196, 16, 80) on 14 x 14 moves 289.0 MB of q, k, v and out and
//     25.3 MB of tables once, 0.0938 ms (bytes; its 28.3 GFLOP take 0.0286
//     ms); 0.1807 ms for the two;
//   * `grove_relpos_flash_attention` runs fp32 and the head dim 8 on the
//     SIMT body (attention_core.cuh: fp32 FMA issue and shared-memory
//     reads, far from either bound).
//
// Numerics against the TPU kernel: all subtract a running max and add the
// bias terms in fp32 to the fp32 scaled logits (the TPU builds the terms
// through 0/1 products of bf16 values with an fp32 sum, which is exact).
// The TPU kernel rounds the probabilities to the input dtype before P.V
// (`:102`), and so does the tensor-core body: the bf16 entry has the TPU's
// rounding points. The SIMT body keeps P in fp32, further from the TPU in
// bf16 (the same in fp32).

#include "attention_core.cuh"
#include "attention_tc.cuh"

GROVE_ATTENTION_ENTRY(relpos_flash_attention)
GROVE_ATTENTION_TC_ENTRY(relpos_flash_attention, true, false)

// The SIMT body: fp32 or bf16, head dims 8, 64, 80, 128.
extern "C" int grove_relpos_flash_attention(const void* q, const void* k,
                                            const void* v, const void* rel_h,
                                            const void* rel_w, void* out,
                                            int b, int s, int heads,
                                            int head_dim, int gh, int gw,
                                            float scale, int dtype,
                                            void* stream) {
  return relpos_flash_attention_dispatch(
      grove::grid_args(q, k, v, rel_h, rel_w, out, b, s, heads, head_dim, gh,
                       gw, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_tc.cuh): bf16, head dims 64, 80, 128.
extern "C" int grove_relpos_flash_attention_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* out, int b, int s, int heads, int head_dim,
    int gh, int gw, float scale, int dtype, void* stream) {
  return relpos_flash_attention_tc_dispatch(
      grove::grid_args(q, k, v, rel_h, rel_w, out, b, s, heads, head_dim, gh,
                       gw, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}
