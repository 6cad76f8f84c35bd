// Four-element row access shared by the normalisation kernels (K8a/K8b in
// layernorm_quant.cu, K8c in rmsnorm_quant.cu): fp32 or bf16 values moved
// as one 16-byte (fp32) or 8-byte (bf16) access and held as fp32.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace grove {

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

// clip(rint(y), -127, 127) as int8, rint rounding half to even
__device__ __forceinline__ int8_t to_int8(float y) {
  return (int8_t)fminf(fmaxf(rintf(y), -127.f), 127.f);
}

}  // namespace grove
