// K8c: [residual add +] RMSNorm -> dynamic per-token int8, one pass over the
// activation, in two entries (with and without the residual branch).
//
// Replaces grove_tpu/ops/fused_ln.py:_rms_kernel (its pallas_call at :155)
// and :_add_rms_kernel (pallas_call at :162), both reached through
// add_rmsnorm_quant_dyn: the norm sites of the W4A8 LLaMA's fused-norm carry
// (models/llama.py, LlamaBlock with fuse_ln), where each norm hands its
// projections int8 activations with one scale per token.
//
//   resid = a + b                                   (add entry, a's dtype)
//   y     = resid * rsqrt(mean(resid^2) + eps) * w  (fp32)
//   sx    = max(max|y|, 1e-9) * (1/127)
//   q     = clip(rint(y * (1/sx)), -127, 127)
//
// as the TPU kernel's _rms_quant_body (fused_ln.py:108-116) computes it: the
// reciprocal of the scale is taken once in fp32 and the row multiplied by
// it. The chain uses _rn intrinsics so that nvcc does not contract it into
// FMAs the plain twin lacks; rintf rounds half to even.
//
// Bound on the H100: device-memory bytes. A bf16 row of the add entry reads
// 4C bytes (a, b) and writes 3C + 4 (resid, q, sx), at a few flops per
// element. The LLaMA row (C = 4096) is above the one-warp-per-row design of
// K8a/K8b, which keeps a row in one warp's registers only up to C = 2048.
// The design: one block of 128 threads per row, each thread holding up to 16
// chunks of 4 consecutive elements (one 16-byte fp32 or 8-byte bf16 access;
// the 128 threads read 512 contiguous elements per chunk), so C <= 8192
// stays in registers and the row is read from device memory once. Two block
// reductions run in turn, the sum of squares and then max|y|: warp shuffles,
// then one word per warp in shared memory added in a fixed order.

#include <stdint.h>

#include "attention_core.cuh"
#include "vec4.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 16;            // C <= kMaxChunks * 4 * kThreads

// the block's sum (kMax = false) or max (kMax = true) of one value per
// thread, the same in every thread
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? grove::warp_max(v) : grove::warp_sum(v);
  __syncthreads();                        // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T, bool kAdd>
__global__ void __launch_bounds__(kThreads) rmsnorm_quant_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ w, T* __restrict__ resid,
    int8_t* __restrict__ q, float* __restrict__ sx, int C, float eps) {
  __shared__ float red[kWarps];
  const long long base = (long long)blockIdx.x * C;
  float x[kMaxChunks][4];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int col = (i * kThreads + threadIdx.x) * 4;
    if (col < C) {
      grove::load4(a + base + col, x[i]);
      if (kAdd) {
        float y[4];
        grove::load4(b + base + col, y);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[i][j] = grove::add_in(T(), x[i][j], y[j]);
        grove::store4(resid + base + col, x[i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) ss = fmaf(x[i][j], x[i][j], ss);
    }
  }
  const float var = block_reduce<false>(ss, red) / (float)C;
  const float r = rsqrtf(var + eps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int col = (i * kThreads + threadIdx.x) * 4;
    if (col < C) {
      const float4 g = *reinterpret_cast<const float4*>(w + col);
      x[i][0] = __fmul_rn(__fmul_rn(x[i][0], r), g.x);
      x[i][1] = __fmul_rn(__fmul_rn(x[i][1], r), g.y);
      x[i][2] = __fmul_rn(__fmul_rn(x[i][2], r), g.z);
      x[i][3] = __fmul_rn(__fmul_rn(x[i][3], r), g.w);
#pragma unroll
      for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(x[i][j]));
    }
  }
  amax = block_reduce<true>(amax, red);
  const float scale = __fmul_rn(fmaxf(amax, 1e-9f), (float)(1.0 / 127.0));
  const float inv = __fdiv_rn(1.f, scale);
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int col = (i * kThreads + threadIdx.x) * 4;
    if (col < C) {
      char4 out;
      out.x = grove::to_int8(__fmul_rn(x[i][0], inv));
      out.y = grove::to_int8(__fmul_rn(x[i][1], inv));
      out.z = grove::to_int8(__fmul_rn(x[i][2], inv));
      out.w = grove::to_int8(__fmul_rn(x[i][3], inv));
      *reinterpret_cast<char4*>(q + base + col) = out;
    }
  }
  if (threadIdx.x == 0) sx[blockIdx.x] = scale;
}

template <typename T, bool kAdd>
int launch_rms(const void* a, const void* b, const void* w, void* resid,
               void* q, void* sx, int rows, int C, float eps,
               cudaStream_t stream) {
  rmsnorm_quant_kernel<T, kAdd><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(w), static_cast<T*>(resid),
      static_cast<int8_t*>(q), static_cast<float*>(sx), C, eps);
  return (int)cudaGetLastError();
}

bool shape_ok(int rows, int C) {
  return rows > 0 && C > 0 && C % 128 == 0 &&
         C <= kMaxChunks * 4 * kThreads;
}

}  // namespace

// x, q: (rows, C); w: (C,) fp32; sx: (rows,) fp32. dtype 0 fp32, 1 bf16.
extern "C" int grove_rmsnorm_quant(const void* x, const void* w, void* q,
                                   void* sx, int rows, int C, float eps,
                                   int dtype, void* stream) {
  if (!shape_ok(rows, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rms<float, false>(x, nullptr, w, nullptr, q, sx, rows, C,
                                    eps, st);
  if (dtype == 1)
    return launch_rms<__nv_bfloat16, false>(x, nullptr, w, nullptr, q, sx,
                                            rows, C, eps, st);
  return (int)cudaErrorInvalidValue;
}

// a, b, resid, q: (rows, C); resid = a + b in a's dtype.
extern "C" int grove_add_rmsnorm_quant(const void* a, const void* b,
                                       const void* w, void* resid, void* q,
                                       void* sx, int rows, int C, float eps,
                                       int dtype, void* stream) {
  if (!shape_ok(rows, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rms<float, true>(a, b, w, resid, q, sx, rows, C, eps, st);
  if (dtype == 1)
    return launch_rms<__nv_bfloat16, true>(a, b, w, resid, q, sx, rows, C,
                                           eps, st);
  return (int)cudaErrorInvalidValue;
}
