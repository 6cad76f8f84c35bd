// K6: one greedy decode step of attention over the int8 KV cache.
//
// Replaces grove_tpu/ops/decode_attention.py:_decode_kernel (its pallas_call
// is at :122, reached through int8_cache_decode_attention, :89), used by
// every decode step of LLaMA-7B over the int8 cache (models/llama.py
// :229-242) at the full-width shape (B = 2, H = Hkv = 32, Cpad = 768,
// D = 128).
//
//   q (B, H, D) float or bf16, kt/vt (B, Hkv, C, D) int8,
//   k_s/v_s (B, Hkv, C) bf16, bias (B, C) fp32 (0 or -1e9) -> out (B, H, D)
//
// One block per (batch, query head); query head h reads kv head
// h / (H / Hkv) (the jnp.repeat semantics of the reference; the TPU
// kernel's head permutation was a layout device). The steps and their
// numerics are the TPU kernel's:
//   1. q is quantised per head: qs = max(|q| / 127, 1e-8),
//      qi = clip(rint(q / qs), -127, 127);
//   2. logit[c] = ((float)(qi . k[c]) * qs) * k_s[c] * inv_sqrt_d + bias[c],
//      the int8 dot taken exactly in int32 with __dp4a;
//   3. fp32 softmax over the C slots: e = exp(l - max), w = e / sum(e);
//   4. w' = bf16(w * v_s[c]), out[d] = sum_c w' * (float)v[c, d] in fp32.
//
// Bound on the H100: device-memory bytes, 2 * C * D int8 per (batch, kv
// head) per step, and at B * H = 64 blocks the latency of those reads. The
// design keeps them coalesced: in steps 2 and 4 a warp takes one cache slot
// at a time and each lane reads 4 bytes of its D-byte row (D = 128: one
// 128-byte line per warp); the logits and weights stay in shared memory
// (C floats), and nothing is dequantised into device memory, where the plain
// version writes fp32 copies of the cache.

#include <stdint.h>

#include "attention_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Max (kMax) or sum over the block; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  x = kMax ? grove::warp_max(x) : grove::warp_sum(x);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                        // scratch free from its last use
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = lane < kWarps ? scratch[lane] : (kMax ? -INFINITY : 0.f);
  return kMax ? grove::warp_max(x) : grove::warp_sum(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kt,
    const int8_t* __restrict__ vt, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const float* __restrict__ bias,
    T* __restrict__ out, int H, int Hkv, int C, int D, float inv_sqrt_d) {
  extern __shared__ __align__(16) float smem[];
  float* sl = smem;                       // [C] logits, then weights
  float* spv = sl + C;                    // [kWarps][D] P.V partial sums
  __shared__ int sq[kMaxD / 4];           // quantised q, 4 int8 per word
  __shared__ float sred[kWarps];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = D / 4;

  // 1. per-head int8 quantisation of q (D <= kMaxD <= kThreads)
  const float qv = tid < D ? grove::to_f(q[(long long)bh * D + tid]) : 0.f;
  const float amax = block_reduce<true>(fabsf(qv), sred);
  const float qs = fmaxf(amax / 127.f, 1e-8f);
  if (tid < D)
    reinterpret_cast<int8_t*>(sq)[tid] =
        (int8_t)fminf(fmaxf(rintf(qv / qs), -127.f), 127.f);
  __syncthreads();

  const long long slab = ((long long)b * Hkv + kvh) * C;
  const int8_t* krow = kt + slab * D;
  const int8_t* vrow = vt + slab * D;
  const __nv_bfloat16* ksr = ks + slab;
  const __nv_bfloat16* vsr = vs + slab;
  const float* br = bias + (long long)b * C;

  // 2. logits: one slot per warp iteration, one 4-byte word per lane
  const int qw = lane < words ? sq[lane] : 0;
  for (int c = warp; c < C; c += kWarps) {
    const int kw = lane < words
        ? *reinterpret_cast<const int*>(krow + (long long)c * D + 4 * lane)
        : 0;
    const int dot = warp_sum_int(__dp4a(kw, qw, 0));
    if (lane == 0)
      sl[c] = ((float)dot * qs) * __bfloat162float(ksr[c]) * inv_sqrt_d +
              br[c];
  }
  __syncthreads();

  // 3. fp32 softmax, then the v scale folded in and rounded to bf16
  float mx = -INFINITY;
  for (int c = tid; c < C; c += kThreads) mx = fmaxf(mx, sl[c]);
  mx = block_reduce<true>(mx, sred);
  float sum = 0.f;
  for (int c = tid; c < C; c += kThreads) {
    const float e = expf(sl[c] - mx);
    sl[c] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, sred);
  for (int c = tid; c < C; c += kThreads)
    sl[c] = __bfloat162float(
        __float2bfloat16(sl[c] / sum * __bfloat162float(vsr[c])));
  __syncthreads();

  // 4. P.V: each warp sums its slots, lanes own 4 columns each
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane < words) {
    for (int c = warp; c < C; c += kWarps) {
      const char4 v4 =
          *reinterpret_cast<const char4*>(vrow + (long long)c * D + 4 * lane);
      const float w = sl[c];
      acc[0] = fmaf(w, (float)v4.x, acc[0]);
      acc[1] = fmaf(w, (float)v4.y, acc[1]);
      acc[2] = fmaf(w, (float)v4.z, acc[2]);
      acc[3] = fmaf(w, (float)v4.w, acc[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) spv[warp * D + 4 * lane + j] = acc[j];
  }
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += spv[w * D + tid];
    out[(long long)bh * D + tid] = grove::from_f<T>(o);
  }
}

template <typename T>
int launch(const void* q, const void* kt, const void* vt, const void* ks,
           const void* vs, const float* bias, void* out, int b, int h,
           int hkv, int c, int d, float inv_sqrt_d, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * ((size_t)c + (size_t)kWarps * d);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  decode_kernel<T><<<b * h, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kt),
      static_cast<const int8_t*>(vt), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), bias, static_cast<T*>(out), h,
      hkv, c, d, inv_sqrt_d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int grove_int8_decode_attention(const void* q, const void* kt,
                                           const void* vt, const void* ks,
                                           const void* vs, const float* bias,
                                           void* out, int b, int h, int hkv,
                                           int c, int d, float inv_sqrt_d,
                                           int dtype, void* stream) {
  if (d % 4 != 0 || d > kMaxD || hkv <= 0 || h % hkv != 0 || c <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kt, vt, ks, vs, bias, out, b, h, hkv, c, d,
                         inv_sqrt_d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kt, vt, ks, vs, bias, out, b, h, hkv, c,
                                 d, inv_sqrt_d, st);
  return (int)cudaErrorInvalidValue;
}
