// K2: SAM global attention with decomposed rel-pos bias over the full grid.
//
// Replaces grove_tpu/ops/sam_attention.py:_grouped_kernel (its pallas_call is
// at :235, reached through grouped_window_attention_relpos and
// _grouped_with_vjp, :947), used by the 4 global blocks of the SAM ViT-H
// encoder (indexes 7, 15, 23, 31) at S = 32 x 32 = 1024, 16 heads, D = 80.
//
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] * scale
//                            + rel_h[b, h, i, j / gw] + rel_w[b, h, i, j % gw])
//                  . v[b, j, h]
//
// q, k, v, out are (B, S, H, D); rel_h is (B, H, S, gh) and rel_w
// (B, H, S, gw), in the input dtype, as
// grove_tpu_torch.ops.sam_attention.relpos_terms makes them. A full
// 1024-wide row does not fit one block's shared memory next to its K/V
// tiles, so both bodies run an online softmax over key tiles and rebuild
// each score's bias from the block's rows of the two small term tables,
// staged in shared memory, where the TPU kernel multiplied them by 0/1
// expansion matrices (sam_attention.py:168-193). Neither writes an S x S
// intermediate to device memory.
//
// Two entries, chosen by the wrapper (ops/sam_attention.py through
// ops/attention.py `_tc_takes`): `grove_sam_global_attention_tc` runs bf16
// at head dims 64, 80 and 128 on the tensor-core body (attention_tc.cuh:
// wgmma, bounded by the bf16 tensor rate; D = 80 is a full 64-column
// swizzle atom and 16 columns of a second, P.V one m64n80k16; the term
// tables staged in bf16, 16 KB a block at SAM's 32 + 32, so two blocks
// share an SM); `grove_sam_global_attention` runs fp32 and the head dim 8
// on the SIMT body (attention_core.cuh: fp32 FMA throughput and
// shared-memory reads, far from that rate). Any grid is taken: a 64-key
// tile may cover several grid rows or part of one.
//
// Numerics against the TPU kernel: all subtract the row max and add the
// bias terms in fp32 to the fp32 scaled logits. The TPU kernel rounds the
// probabilities to the input dtype before P.V, as the tensor-core body does;
// the SIMT body keeps them in fp32.

#include "attention_core.cuh"
#include "attention_tc.cuh"

GROVE_ATTENTION_ENTRY(sam_global_attention)
GROVE_ATTENTION_TC_ENTRY(sam_global_attention, true, false)

// The SIMT body: fp32 or bf16, head dims 8, 64, 80, 128.
extern "C" int grove_sam_global_attention(const void* q, const void* k,
                                          const void* v, const void* rel_h,
                                          const void* rel_w, void* out, int b,
                                          int s, int heads, int head_dim,
                                          int gh, int gw, float scale,
                                          int dtype, void* stream) {
  return sam_global_attention_dispatch(
      grove::grid_args(q, k, v, rel_h, rel_w, out, b, s, heads, head_dim, gh,
                       gw, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}

// The tensor-core body (attention_tc.cuh): bf16, head dims 64, 80, 128.
extern "C" int grove_sam_global_attention_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, void* out, int b, int s, int heads, int head_dim,
    int gh, int gw, float scale, int dtype, void* stream) {
  return sam_global_attention_tc_dispatch(
      grove::grid_args(q, k, v, rel_h, rel_w, out, b, s, heads, head_dim, gh,
                       gw, scale),
      dtype, head_dim, static_cast<cudaStream_t>(stream));
}
