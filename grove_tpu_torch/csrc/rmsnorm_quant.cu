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
// it. Every step rounds where the plain twin's torch ops round (each square
// before it is added, the mean as a division, rsqrt as 1 / sqrt: _rn
// intrinsics, which nvcc does not contract into FMAs; rintf rounds half to
// even), so the two differ only in the order of the sum of squares. An int8
// output one LSB off moves a W4A8 model's later layers, so the fewer the
// better.
//
// Bound on the H100: device-memory bytes. A bf16 row of the add entry reads
// 4C bytes (a, b) and writes 3C + 4 (resid, q, sx), at a few flops per
// element: 36.7 MB at (1280, 4096), 0.0110 ms at 3.35 TB/s (the plain
// entry 15.7 MB, 0.0047 ms). The design:
//   * Persistent CTAs of 256 threads, up to 3 an SM (the C = 4096
//     instantiation's register cap; 2 for any other C; fewer where shared
//     memory says so), CTA b walking rows b, b + grid, ...
//     (ops/fused_ln.py `_rms_plan` mirrors `plan` below).
//   * A ring of 2 row slots in shared memory: one thread brings a row of a
//     (and of b) with one 1-D bulk copy each (cp.async.bulk, 8 KB a bf16
//     row at C = 4096) completing on the slot's mbarrier, and refills a
//     slot with the row 2 further on as soon as every thread has read it
//     (the row's first block barrier), so the next row lands while this
//     one reduces and stores (3 slots were slower on an H100 for bf16
//     rows).
//   * A thread owns 16-byte pieces k * 256 + tid of the row (8 bf16 or 4
//     fp32 elements each; 2 or 4 pieces at C = 4096, the compile-time
//     instantiation; up to 32 elements for any other C <= 8192), so a
//     warp's reads of the slot and its 16-byte stores of resid are 512
//     contiguous bytes; q leaves in 8- (bf16) or 4-byte (fp32) stores, 256
//     or 128 contiguous bytes a warp. Its weights are read once a CTA into
//     registers. (A thread owning 16 consecutive elements, for one 16-byte
//     q store, was slower on an H100 in both dtypes, slower than the design
//     it replaces in fp32: its warps' accesses spanned 1-2 KB.)
//   * A fixed reduction order, so that sx is a function of the row alone:
//     each thread's sum of squares over its pieces in element order,
//     a warp's by a butterfly of shuffles, the 8 warps' added in warp order;
//     max|y| the same way (exact in any order). Two block barriers a row.
//
// The design it replaces ran one 128-thread block a row (1280 blocks, two
// waves), 8-byte bf16 loads into x[16][4] sized for C = 8192 behind runtime
// guards, w re-read from L2 for every row, and load, two reductions (four
// barriers) and stores strictly in turn, with nothing of the next row in
// flight.

#include <stdint.h>

#include "async_copy.cuh"
#include "attention_core.cuh"
#include "vec4.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 8192;
constexpr int kExactC = 4096;             // the compile-time row (LLaMA-7B)
constexpr int kMaxSlots = 2;
constexpr int kSmemLimit = 232448;        // dynamic shared bytes a block
constexpr int kSmemSm = 233472;           // shared bytes an SM
constexpr int kReserved = 1024;           // the runtime's a block
constexpr int kStatic = 2 * kWarps * 4;   // red[2][kWarps]

// CTAs an SM the register budget allows (__launch_bounds__' minimum)
constexpr int blocks_for(bool exact) { return exact ? 3 : 2; }

// The launch (ops/fused_ln.py `_rms_plan` computes the same): ring slots,
// dynamic shared bytes, CTAs an SM and in all.
struct Plan {
  int slots, smem, per_sm, ctas;
};

Plan plan(int rows, int c, int elem, bool add, int sms) {
  Plan p;
  const int slot = (add ? 2 : 1) * c * elem;
  p.slots = (kSmemLimit - 8 * kMaxSlots) / slot;
  if (p.slots > kMaxSlots) p.slots = kMaxSlots;
  p.smem = p.slots * slot + 8 * p.slots;
  p.per_sm = kSmemSm / (p.smem + kStatic + kReserved);
  const int cap = blocks_for(c == kExactC);
  if (p.per_sm > cap) p.per_sm = cap;
  p.ctas = rows < p.per_sm * sms ? rows : p.per_sm * sms;
  return p;
}

using grove::bulk_copy;
using grove::mbar_expect;
using grove::mbar_init;
using grove::mbar_wait;

// a 16-byte piece of T (4 fp32 or 8 bf16) as fp32, and back (the values
// already rounded to T)
template <typename T>
__device__ __forceinline__ void unpack(uint4 v, float* x);

template <>
__device__ __forceinline__ void unpack<float>(uint4 v, float* x) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 v, float* x) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* x);

template <>
__device__ __forceinline__ uint4 pack<float>(const float* x) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                    __float_as_uint(x[2]), __float_as_uint(x[3]));
}

template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// kE int8 of y * inv, stored at p (8 bytes for bf16 rows, 4 for fp32)
template <int kE>
__device__ __forceinline__ void store_q(int8_t* p, const float* y,
                                        float inv) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < kE; ++e)
    w[e / 4] |= (uint32_t)(uint8_t)grove::to_int8(__fmul_rn(y[e], inv))
                << (8 * (e % 4));
  if (kE == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// kC: the row's length at compile time (kExactC), or 0 for any C <= 8192
// given at run time (pieces past C idle)
template <typename T, bool kAdd, int kC>
__global__ void __launch_bounds__(kThreads, blocks_for(kC == kExactC))
    rmsnorm_quant_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         const float* __restrict__ w, T* __restrict__ resid,
                         int8_t* __restrict__ q, float* __restrict__ sx,
                         int rows, int C, float eps, int slots) {
  constexpr int kE = 16 / (int)sizeof(T);            // elements a piece
  constexpr int kPieces = (kC ? kC : kMaxC) / (kE * kThreads);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][kWarps];
  const int c = kC ? kC : C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t row_bytes = (uint32_t)c * sizeof(T);
  const int slot_bytes = (kAdd ? 2 : 1) * (int)row_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + slots * slot_bytes);
  const int mine = (rows - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;

  // by thread 0: this CTA's i-th row into slot i % slots
  auto issue = [&](int i) {
    const long long row = blockIdx.x + (long long)i * gridDim.x;
    unsigned char* s = smem + (i % slots) * slot_bytes;
    uint64_t* bar = bars + i % slots;
    mbar_expect(bar, (kAdd ? 2 : 1) * row_bytes);
    bulk_copy(s, a + row * c, row_bytes, bar);
    if (kAdd) bulk_copy(s + row_bytes, b + row * c, row_bytes, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < slots; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < slots && i < mine; ++i) issue(i);
  }
  // this thread's weights, once: piece k holds elements
  // (k * kThreads + tid) * kE .. + kE - 1
  float g[kPieces][kE];
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    const int e0 = (k * kThreads + tid) * kE;
    if (kC || e0 < c) {
#pragma unroll
      for (int j = 0; j < kE; j += 4)
        unpack<float>(*reinterpret_cast<const uint4*>(w + e0 + j),
                      &g[k][j]);
    }
  }
  __syncthreads();                        // the barriers are initialised

  for (int i = 0; i < mine; ++i) {
    const long long row = blockIdx.x + (long long)i * gridDim.x;
    const unsigned char* s = smem + (i % slots) * slot_bytes;
    mbar_wait(bars + i % slots, (i / slots) & 1);
    float x[kPieces][kE];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int e0 = (k * kThreads + tid) * kE;
      if (kC || e0 < c) {
        unpack<T>(*reinterpret_cast<const uint4*>(s + e0 * sizeof(T)), x[k]);
        if (kAdd) {
          float y[kE];
          unpack<T>(*reinterpret_cast<const uint4*>(s + row_bytes +
                                                    e0 * sizeof(T)),
                    y);
#pragma unroll
          for (int e = 0; e < kE; ++e)
            x[k][e] = grove::add_in(T(), x[k][e], y[e]);
          *reinterpret_cast<uint4*>(resid + row * c + e0) = pack<T>(x[k]);
        }
#pragma unroll
        for (int e = 0; e < kE; ++e)
          ss = __fadd_rn(ss, __fmul_rn(x[k][e], x[k][e]));
      }
    }
    ss = grove::warp_sum(ss);
    if (lane == 0) red[0][warp] = ss;
    __syncthreads();              // every thread has read slot i % slots
    if (tid == 0 && i + slots < mine) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + slots);
    }
    float tot = red[0][0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) tot += red[0][k];
    const float r = __fdiv_rn(
        1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(tot, (float)c), eps)));
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int e0 = (k * kThreads + tid) * kE;
      if (kC || e0 < c) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          x[k][e] = __fmul_rn(__fmul_rn(x[k][e], r), g[k][e]);
          amax = fmaxf(amax, fabsf(x[k][e]));
        }
      }
    }
    amax = grove::warp_max(amax);
    if (lane == 0) red[1][warp] = amax;
    __syncthreads();
    amax = red[1][0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) amax = fmaxf(amax, red[1][k]);
    const float scale = __fmul_rn(fmaxf(amax, 1e-9f), (float)(1.0 / 127.0));
    const float inv = __fdiv_rn(1.f, scale);
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int e0 = (k * kThreads + tid) * kE;
      if (kC || e0 < c) store_q<kE>(q + row * c + e0, x[k], inv);
    }
    if (tid == 0) sx[row] = scale;
  }
}

template <typename T, bool kAdd, int kC>
int launch_rms(const Plan& p, const void* a, const void* b, const void* w,
               void* resid, void* q, void* sx, int rows, int C, float eps,
               cudaStream_t stream) {
  auto kernel = rmsnorm_quant_kernel<T, kAdd, kC>;
  static int allowed[64] = {0};          // the attribute is set per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (p.smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = p.smem;
  }
  kernel<<<p.ctas, kThreads, p.smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(w), static_cast<T*>(resid),
      static_cast<int8_t*>(q), static_cast<float*>(sx), rows, C, eps,
      p.slots);
  return (int)cudaGetLastError();
}

bool shape_ok(int rows, int C) {
  return rows > 0 && C > 0 && C % 128 == 0 && C <= kMaxC;
}

// the current device's SMs (0 where it cannot be read), cached
int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cache[dev])
    cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  return cache[dev];
}

template <typename T, bool kAdd>
int dispatch(const void* a, const void* b, const void* w, void* resid,
             void* q, void* sx, int rows, int C, float eps, int sms,
             cudaStream_t st) {
  const Plan p = plan(rows, C, (int)sizeof(T), kAdd, sms);
  if (C == kExactC)
    return launch_rms<T, kAdd, kExactC>(p, a, b, w, resid, q, sx, rows, C,
                                        eps, st);
  return launch_rms<T, kAdd, 0>(p, a, b, w, resid, q, sx, rows, C, eps, st);
}

template <bool kAdd>
int run(const void* a, const void* b, const void* w, void* resid, void* q,
        void* sx, int rows, int C, float eps, int dtype, void* stream) {
  const int sms = sm_count();
  if (!shape_ok(rows, C) || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, kAdd>(a, b, w, resid, q, sx, rows, C, eps, sms,
                                 st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, kAdd>(a, b, w, resid, q, sx, rows, C,
                                         eps, sms, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, q: (rows, C); w: (C,) fp32; sx: (rows,) fp32. dtype 0 fp32, 1 bf16.
extern "C" int grove_rmsnorm_quant(const void* x, const void* w, void* q,
                                   void* sx, int rows, int C, float eps,
                                   int dtype, void* stream) {
  return run<false>(x, nullptr, w, nullptr, q, sx, rows, C, eps, dtype,
                    stream);
}

// a, b, resid, q: (rows, C); resid = a + b in a's dtype.
extern "C" int grove_add_rmsnorm_quant(const void* a, const void* b,
                                       const void* w, void* resid, void* q,
                                       void* sx, int rows, int C, float eps,
                                       int dtype, void* stream) {
  return run<true>(a, b, w, resid, q, sx, rows, C, eps, dtype, stream);
}

// The launch either entry makes on a card of `sms` SMs, for ops/fused_ln.py
// `_rms_plan` to be checked against: plan[0..3] = ring slots, dynamic
// shared bytes, CTAs an SM, CTAs.
extern "C" int grove_rmsnorm_quant_plan(int rows, int C, int dtype, int add,
                                        int sms, int* out) {
  if (!shape_ok(rows, C) || sms <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(rows, C, dtype == 0 ? 4 : 2, add != 0, sms);
  out[0] = p.slots;
  out[1] = p.smem;
  out[2] = p.per_sm;
  out[3] = p.ctas;
  return 0;
}
