// K8a + K8b: LayerNorm -> static int8 quantize, alone or after a residual
// add, one pass over the activation.
//
// Replaces grove_tpu/ops/fused_ln.py:_kernel (K8a, its pallas_call at :213,
// reached through layernorm_quant with use_kernel) and :_add_kernel (K8b,
// pallas_call at :68, reached through add_layernorm_quant), the norm sites
// of the W8A8-static CLIP and SAM towers (models/layers.py LayerNormQuant).
//
//   resid = a + b                                  (K8b only, a's dtype)
//   q = clip(rint((x - mu) * rsqrt(var + eps) * gs + bs), -127, 127)
//
// x = resid (K8b) or the input (K8a), rows of C elements, fp32 or bf16.
// gs = gamma / act_scale and bs = beta / act_scale arrive folded in fp32
// (the wrapper folds them, as the JAX package does outside its kernel).
// Statistics are two-pass fp32: the mean, then the mean of d * d. The
// normalize-and-scale chain uses _rn intrinsics so that nvcc does not
// contract it into FMAs, which would round differently from the plain twin;
// rintf rounds half to even.
//
// Bound on the H100: device-memory bytes. A bf16 row reads 2C (K8a) or 4C
// (K8b) bytes and writes C (+ 2C) and does ~10 flops per element, far below
// the card's compute. The design: one warp per row, 8 rows per block, the
// row held in registers (C <= 2048, so each lane keeps at most 64 values);
// each lane reads 4 consecutive elements per chunk (16 bytes fp32, 8 bytes
// bf16), so a warp reads 512 contiguous elements per step, and writes the
// 4 int8 results as one 32-bit word. The sums are warp shuffles; no shared
// memory and no second pass over device memory.

#include <stdint.h>

#include "attention_core.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunks = 16;            // C <= kMaxChunks * 128

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) =
      __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) =
      __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

// a + b rounded to T, as torch and XLA add two values of T
__device__ __forceinline__ float add_in(float, float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ float add_in(__nv_bfloat16, float x, float y) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(x, y)));
}

__device__ __forceinline__ int8_t quant(float d, float r, float g, float b) {
  const float y = __fadd_rn(__fmul_rn(__fmul_rn(d, r), g), b);
  return (int8_t)fminf(fmaxf(rintf(y), -127.f), 127.f);
}

template <typename T, bool kAdd>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) layernorm_quant_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ gs, const float* __restrict__ bs,
    T* __restrict__ resid, int8_t* __restrict__ q, int rows, int C,
    float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nch = C >> 7;
  const long long base = (long long)row * C;

  float x[kMaxChunks][4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    if (i < nch) {
      const int col = (i * 32 + lane) * 4;
      load4(a + base + col, x[i]);
      if (kAdd) {
        float y[4];
        load4(b + base + col, y);
#pragma unroll
        for (int j = 0; j < 4; ++j) x[i][j] = add_in(T(), x[i][j], y[j]);
        store4(resid + base + col, x[i]);
      }
      sum += (x[i][0] + x[i][1]) + (x[i][2] + x[i][3]);
    }
  }
  const float mu = grove::warp_sum(sum) / (float)C;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    if (i < nch) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] = x[i][j] - mu;
        ss = fmaf(x[i][j], x[i][j], ss);
      }
    }
  }
  const float var = grove::warp_sum(ss) / (float)C;
  const float r = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    if (i < nch) {
      const int col = (i * 32 + lane) * 4;
      const float4 g = *reinterpret_cast<const float4*>(gs + col);
      const float4 bb = *reinterpret_cast<const float4*>(bs + col);
      char4 out;
      out.x = quant(x[i][0], r, g.x, bb.x);
      out.y = quant(x[i][1], r, g.y, bb.y);
      out.z = quant(x[i][2], r, g.z, bb.z);
      out.w = quant(x[i][3], r, g.w, bb.w);
      *reinterpret_cast<char4*>(q + base + col) = out;
    }
  }
}

template <typename T, bool kAdd>
int launch_ln(const void* a, const void* b, const void* gs, const void* bs,
              void* resid, void* q, int rows, int C, float eps,
              cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layernorm_quant_kernel<T, kAdd><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(gs), static_cast<const float*>(bs),
      static_cast<T*>(resid), static_cast<int8_t*>(q), rows, C, eps);
  return (int)cudaGetLastError();
}

bool shape_ok(int rows, int C) {
  return rows > 0 && C > 0 && C % 128 == 0 && C <= kMaxChunks * 128;
}

}  // namespace

extern "C" int grove_layernorm_quant(const void* x, const void* gs,
                                     const void* bs, void* q, int rows, int C,
                                     float eps, int dtype, void* stream) {
  if (!shape_ok(rows, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ln<float, false>(x, nullptr, gs, bs, nullptr, q, rows, C,
                                   eps, st);
  if (dtype == 1)
    return launch_ln<__nv_bfloat16, false>(x, nullptr, gs, bs, nullptr, q,
                                           rows, C, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int grove_add_layernorm_quant(const void* a, const void* b,
                                         const void* gs, const void* bs,
                                         void* resid, void* q, int rows,
                                         int C, float eps, int dtype,
                                         void* stream) {
  if (!shape_ok(rows, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ln<float, true>(a, b, gs, bs, resid, q, rows, C, eps, st);
  if (dtype == 1)
    return launch_ln<__nv_bfloat16, true>(a, b, gs, bs, resid, q, rows, C,
                                          eps, st);
  return (int)cudaErrorInvalidValue;
}
