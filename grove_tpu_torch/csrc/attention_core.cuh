// Shared body of the hand-written attention forward kernels of
// grove_tpu_torch (K1-K5, K9's forward, K10-K13).
//
// One thread block owns kBQ = kWarps * kRows query rows of one
// (batch, head) pair and streams the keys of that pair through shared memory
// in tiles of kBK = 32 keys, one key per lane. Each warp keeps kRows query
// rows: per tile a lane computes the score of its key against each of them
// (q broadcast from shared memory, k read as float4 from a padded row), the
// warp folds the tile into an online softmax (running max and sum, fp32),
// and the probabilities are broadcast with shuffles for the P.V product,
// whose output columns are split over the lanes. Scores live in log2 units
// (q pre-scaled by scale * log2(e), the bias by log2(e)) so the softmax runs
// on exp2f. Everything after the load is fp32, whatever the input type.
//
// What the entry points choose:
//   * strides of q, k, v and out, so a kernel reads heads and the q/k/v
//     thirds of an unsplit projection in place (sam_window_attention.cu);
//   * an optional decomposed rel-pos bias, rebuilt per (row, key) from the
//     (S, gh) and (S, gw) term tables that the block stages in shared memory:
//     bias = rel_h[row, key / gw] + rel_w[row, key % gw];
//   * a causal mask, and an optional log-sum-exp output (natural log);
//   * an optional per-batch left-pad count: keys below it are masked except
//     each row's own key (K5, the int8-cache prefill);
//   * the TPU K1's all-underflow contract (see kExp2Shift);
//   * an int8 output (K1q): clip(rint(out * *out_inv), -127, 127), with the
//     reciprocal of the static activation scale read from device memory;
//   * the ragged edge: keys at or past Sk are masked and rows past S are not
//     written, so no caller pads;
//   * a key count Sk other than the query count S (K10's cross lengths; 0
//     means Sk = S). The causal mask is then top-left aligned: row i sees
//     keys 0..i, whatever Sk - S is.
//
// Bounds on an H100: the products run on the CUDA cores in fp32, with no
// tensor-core instruction, so every kernel here is bounded by fp32 FMA
// throughput and shared-memory bandwidth, far below the card's bf16 tensor
// rate. That is the price of a first kernel that is simple and right; the
// wgmma/TMA rewrite is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace grove {

constexpr int kWarps = 8;                 // warps per block
constexpr int kRows = 4;                  // query rows per warp
constexpr int kBQ = kWarps * kRows;       // query rows per block
constexpr int kBK = 32;                   // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// EXP2_SHIFT of grove_tpu/ops/sam_attention.py:29-39. The TPU K1 takes its
// softmax as exp2(logit - EXP2_SHIFT) in log2 units with no max pass, so a
// row whose largest logit lies below EXP2_SHIFT - 126 underflows everywhere
// and its denominator guard returns 0. With `zero_underflow` set this body
// returns 0 for such a row too, and a max-subtracted softmax otherwise (the
// overflow of terms above EXP2_SHIFT + 127 on the TPU is not copied).
constexpr float kExp2Shift = 32.f;

// Element strides of a (batch, seq, head, dim) view; dim is contiguous.
struct Strides {
  long long b, s, h;
};

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;         // (B, H, S) natural-log LSE, or nullptr
  const void* rh;     // rel_h terms (row, gh) per (b, h), or nullptr
  const void* rw;     // rel_w terms (row, gw) per (b, h)
  const int* pad;     // (B,) left-pad counts, or nullptr
  const float* out_inv;  // K1q: o is int8, rint(out * *out_inv); or nullptr
  Strides qs, ks, vs, os, rhs, rws;
  int B, H, S, gh, gw;
  int Sk;             // keys per (batch, head); 0 = S
  float scale;
  int causal;
  int zero_underflow; // rows with max logit < kExp2Shift - 126 (log2) -> 0
};

// The arguments of an entry over a full gh x gw grid with the decomposed
// rel-pos bias and no mask (K2, K11, K13): q, k, v and out (B, S, H, D), or
// raw (B, S, H * D), which has the same strides; the term tables rel_h
// (B, H, S, gh) and rel_w (B, H, S, gw).
inline AttnArgs grid_args(const void* q, const void* k, const void* v,
                          const void* rel_h, const void* rel_w, void* out,
                          int b, int s, int heads, int head_dim, int gh,
                          int gw, float scale) {
  const long long hd = (long long)heads * head_dim;
  AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.rh = rel_h;
  a.rw = rel_w;
  a.qs = {s * hd, hd, head_dim};
  a.ks = a.qs;
  a.vs = a.qs;
  a.os = a.qs;
  a.rhs = {(long long)heads * s * gh, gh, (long long)s * gh};
  a.rws = {(long long)heads * s * gw, gw, (long long)s * gw};
  a.B = b;
  a.H = heads;
  a.S = s;
  a.gh = gh;
  a.gw = gw;
  a.scale = scale;
  return a;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory floats one block needs: Q tile, padded K tile, V tile and,
// with a bias, the block's rows of the rel-pos term tables. The K row
// stride D + 4 keeps each row 16-byte aligned for float4 reads and, since
// D % 8 == 0, spreads a quarter-warp's rows over distinct banks.
template <int D>
__host__ __device__ constexpr int smem_floats_fixed() {
  return kBQ * D + kBK * (D + 4) + kBK * D;
}

inline size_t smem_bytes(int D_fixed_floats, int gh, int gw, bool bias) {
  return sizeof(float) *
         (size_t)(D_fixed_floats + (bias ? kBQ * (gh + gw) : 0));
}

template <typename T, int D>
__device__ __forceinline__ void attention_block(const AttnArgs& a) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  constexpr int NC = (D + 31) / 32;       // output columns per lane
  constexpr int KST = D + 4;              // padded K row stride
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // [kBQ][D]
  float* sK = sQ + kBQ * D;               // [kBK][KST]
  float* sV = sK + kBK * KST;             // [kBK][D]
  float* sR = sV + kBK * D;               // [kBQ][gh + gw]

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool bias = a.rh != nullptr;
  const int gs = a.gh + a.gw;
  const int pad = a.pad != nullptr ? a.pad[b] : 0;
  const int Sk = a.Sk > 0 ? a.Sk : a.S;

  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;

  const float qscale = a.scale * kLog2e;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    sQ[i] = row < a.S ? to_f(q[row * a.qs.s + d]) * qscale : 0.f;
  }
  if (bias) {
    const T* rh = static_cast<const T*>(a.rh) + b * a.rhs.b + h * a.rhs.h;
    const T* rw = static_cast<const T*>(a.rw) + b * a.rws.b + h * a.rws.h;
    for (int i = tid; i < kBQ * gs; i += kThreads) {
      const int r = i / gs;
      const int c = i - r * gs;
      const int row = q0 + r;
      float x = 0.f;
      if (row < a.S)
        x = c < a.gh ? to_f(rh[row * a.rhs.s + c])
                     : to_f(rw[row * a.rws.s + (c - a.gh)]);
      sR[i] = x * kLog2e;
    }
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int wrow = warp * kRows;          // this warp's first row in the tile
  const int kend = a.causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                      // previous tile consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int key = k0 + j;
      const bool ok = key < Sk;
      sK[j * KST + d] = ok ? to_f(k[key * a.ks.s + d]) : 0.f;
      sV[j * D + d] = ok ? to_f(v[key * a.vs.s + d]) : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = sK + lane * KST;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kd = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qd =
            *reinterpret_cast<const float4*>(sQ + (wrow + r) * D + d);
        s[r] = fmaf(qd.x, kd.x, s[r]);
        s[r] = fmaf(qd.y, kd.y, s[r]);
        s[r] = fmaf(qd.z, kd.z, s[r]);
        s[r] = fmaf(qd.w, kd.w, s[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + wrow + r;
      const bool valid = key < Sk && (!a.causal || key <= row) &&
                         (key >= pad || key == row);
      float x = s[r];
      if (bias && key < Sk) {
        const float* rr = sR + (wrow + r) * gs;
        x += rr[key / a.gw] + rr[a.gh + key % a.gw];
      }
      x = valid ? x : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(x));
      const float base = mn == -INFINITY ? 0.f : mn;
      const float p = exp2f(x - base);
      const float corr = exp2f(m[r] - base);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      s[r] = p;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < D ? sV[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

  const long long obase = b * a.os.b + h * a.os.h;
  T* o = static_cast<T*>(a.o) + obase;
  int8_t* oq = static_cast<int8_t*>(a.o) + obase;
  const float qinv = a.out_inv != nullptr ? *a.out_inv : 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + wrow + r;
    if (row >= a.S) continue;
    const float lsafe = fmaxf(l[r], 1e-30f);
    const bool underflow = a.zero_underflow && m[r] < kExp2Shift - 126.f;
    const float inv = underflow ? 0.f : 1.f / lsafe;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d >= D) continue;
      const float x = acc[r][c] * inv;
      if (a.out_inv != nullptr)
        oq[row * a.os.s + d] =
            (int8_t)fminf(fmaxf(rintf(x * qinv), -127.f), 127.f);
      else
        o[row * a.os.s + d] = from_f<T>(x);
    }
    if (a.lse != nullptr && lane == 0)
      a.lse[((long long)b * a.H + h) * a.S + row] = (m[r] + log2f(lsafe)) * kLn2;
  }
}

// Launch one instantiation on `stream`. Opts the kernel into more than the
// default 48 KB of dynamic shared memory where its tiles need it, and
// returns cudaGetLastError() so a refused launch is reported to the caller.
template <typename Kernel>
inline int launch(Kernel kernel, const AttnArgs& a, int fixed_floats,
                  cudaStream_t stream) {
  const size_t bytes = smem_bytes(fixed_floats, a.gh, a.gw, a.rh != nullptr);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace grove

// Define the __global__ instantiations of one entry point for every head
// dim this package's configs use, and a host dispatcher `NAME_dispatch`
// over (dtype, head_dim). dtype: 0 = float32, 1 = bfloat16.
#define GROVE_ATTENTION_ENTRY(NAME)                                           \
  template <typename T, int D>                                                \
  __global__ void __launch_bounds__(grove::kThreads)                          \
      NAME##_kernel(const grove::AttnArgs a) {                                \
    grove::attention_block<T, D>(a);                                          \
  }                                                                           \
  template <typename T>                                                       \
  static int NAME##_by_dim(const grove::AttnArgs& a, int d,                   \
                           cudaStream_t st) {                                 \
    switch (d) {                                                              \
      case 8:                                                                 \
        return grove::launch(NAME##_kernel<T, 8>, a,                          \
                             grove::smem_floats_fixed<8>(), st);              \
      case 64:                                                                \
        return grove::launch(NAME##_kernel<T, 64>, a,                         \
                             grove::smem_floats_fixed<64>(), st);             \
      case 80:                                                                \
        return grove::launch(NAME##_kernel<T, 80>, a,                         \
                             grove::smem_floats_fixed<80>(), st);             \
      case 128:                                                               \
        return grove::launch(NAME##_kernel<T, 128>, a,                        \
                             grove::smem_floats_fixed<128>(), st);            \
      default:                                                                \
        return (int)cudaErrorInvalidValue;                                    \
    }                                                                         \
  }                                                                           \
  static int NAME##_dispatch(const grove::AttnArgs& a, int dtype, int d,      \
                             cudaStream_t st) {                               \
    if (dtype == 0) return NAME##_by_dim<float>(a, d, st);                    \
    if (dtype == 1) return NAME##_by_dim<__nv_bfloat16>(a, d, st);            \
    return (int)cudaErrorInvalidValue;                                        \
  }
