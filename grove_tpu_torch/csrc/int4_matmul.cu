// K7a: W4A16 matmul over group-pair packed int4 weights (LLaMA decode).
//
// Replaces grove_tpu/ops/int4_matmul.py:_kernel (its pallas_call is at :317,
// reached through int4_matmul, :287), which Int4Dense takes for fewer than
// 64 rows (models/layers.py:263-267): every projection of every decode step
// of the int4 LLaMA-7B, at M = 2 and (K, N) = (4096, 4096), (4096, 11008)
// and (11008, 4096).
//
//   out[m, n] = sum_k x[m, k] * q4[k, n] * scale[k / G, n]
//
// x (M, K) float or bf16; wp (K/2, N) int8 in the layout of
// grove_tpu/ops/quant.py:pack_int4: packed row p*G + i holds logical row
// 2p*G + i in its low nibble and (2p+1)*G + i in its high nibble, so one
// "super-group" p of G packed rows carries quantisation groups 2p and 2p+1.
// scale (K/G, N) fp32. Nibbles are unpacked with plain shifts: the low one is
// (int8)(b << 4) >> 4, the high one b >> 4 (arithmetic). The TPU kernel's
// biased-nibble algebra existed only because Mosaic could not shift int8
// vectors; it is not copied. Products accumulate in fp32; out is in x's
// dtype.
//
// Bound on the H100: device-memory bytes of the weights, 0.5 B per weight
// (8 MB for a 4096 x 4096 projection), read once per call; x is tiny. The
// design: a block owns 128 output columns and MT rows of x; each lane reads
// 4 consecutive packed bytes of a row (one 32-bit load, so a warp reads a
// 128-byte line) and the block's 8 warps split the G packed rows of each
// super-group. The block stages the 2G activations of the super-group in
// shared memory as fp32 (every lane reads the same word: a broadcast). So
// that the few column tiles of a decode shape still fill the card, K is
// split over a third grid dimension; each split writes fp32 partial sums
// (ksplit, M, N) and a second small kernel adds them in a fixed order and
// casts, so the result does not depend on scheduling.

#include <stdint.h>

#include "attention_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                  // columns per lane: one 32-bit load
constexpr int kTileN = 32 * kCols;        // columns per block

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) int4_partial_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ wp,
    const float* __restrict__ scale, float* __restrict__ part, int M, int K,
    int N, int G, int supers, int ksplit) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                       // [MT][2G] one super-group of x
  float* sred = sx + MT * 2 * G;          // [kWarps][MT][kTileN]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kTileN + lane * kCols;
  const int m0 = blockIdx.y * MT;
  const int z = blockIdx.z;
  const int p0 = (int)((long long)supers * z / ksplit);
  const int p1 = (int)((long long)supers * (z + 1) / ksplit);
  const bool col_ok = n0 < N;             // N % 4 == 0: all 4 or none

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  for (int p = p0; p < p1; ++p) {
    __syncthreads();                      // previous super-group consumed
    for (int i = threadIdx.x; i < MT * 2 * G; i += kThreads) {
      const int m = i / (2 * G);
      const int j = i - m * 2 * G;
      const int row = m0 + m;
      sx[i] = row < M
          ? grove::to_f(x[(long long)row * K + (long long)p * 2 * G + j])
          : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    float slo[kCols], shi[kCols];
    const float* s0 = scale + (long long)(2 * p) * N + n0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      slo[c] = s0[c];
      shi[c] = s0[N + c];
    }
    const int8_t* w = wp + (long long)p * G * N + n0;
#pragma unroll 4
    for (int i = warp; i < G; i += kWarps) {
      const char4 b4 = *reinterpret_cast<const char4*>(w + (long long)i * N);
      const int8_t bytes[kCols] = {b4.x, b4.y, b4.z, b4.w};
      float wlo[kCols], whi[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int lo = (int8_t)((uint32_t)(uint8_t)bytes[c] << 4) >> 4;
        const int hi = bytes[c] >> 4;
        wlo[c] = (float)lo * slo[c];
        whi[c] = (float)hi * shi[c];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = sx[m * 2 * G + i];
        const float xh = sx[m * 2 * G + G + i];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[m][c] = fmaf(xh, whi[c], fmaf(xl, wlo[c], acc[m][c]));
      }
    }
  }

  // add the warps' partial sums (each warp took every 8th packed row)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      sred[(warp * MT + m) * kTileN + lane * kCols + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kTileN; i += kThreads) {
    const int m = i / kTileN;
    const int col = i - m * kTileN;
    const int row = m0 + m;
    const int n = blockIdx.x * kTileN + col;
    if (row < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sred[(w * MT + m) * kTileN + col];
      part[((long long)z * M + row) * N + n] = s;
    }
  }
}

template <typename T>
__global__ void int4_reduce_kernel(const float* __restrict__ part,
                                   T* __restrict__ out, int ksplit,
                                   long long mn) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < ksplit; ++z) s += part[z * mn + i];
    out[i] = grove::from_f<T>(s);
  }
}

template <typename T, int MT>
int launch_mt(const void* x, const void* wp, const float* scale, float* part,
              void* out, int m, int k, int n, int g, int ksplit,
              cudaStream_t st) {
  const size_t bytes = sizeof(float) * (size_t)MT * (2 * g + kWarps * kTileN);
  auto kernel = int4_partial_kernel<T, MT>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int supers = k / (2 * g);
  dim3 grid((n + kTileN - 1) / kTileN, (m + MT - 1) / MT, ksplit);
  kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wp), scale, part,
      m, k, n, g, supers, ksplit);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long mn = (long long)m * n;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  int4_reduce_kernel<T><<<blocks, 256, 0, st>>>(part, static_cast<T*>(out),
                                                ksplit, mn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wp, const float* scale, float* part,
           void* out, int m, int k, int n, int g, int mt, int ksplit,
           cudaStream_t st) {
  switch (mt) {
    case 1:
      return launch_mt<T, 1>(x, wp, scale, part, out, m, k, n, g, ksplit, st);
    case 2:
      return launch_mt<T, 2>(x, wp, scale, part, out, m, k, n, g, ksplit, st);
    case 4:
      return launch_mt<T, 4>(x, wp, scale, part, out, m, k, n, g, ksplit, st);
    case 8:
      return launch_mt<T, 8>(x, wp, scale, part, out, m, k, n, g, ksplit, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part: (ksplit, M, N) fp32 scratch the caller allocates. mt: rows of x per
// block (1, 2, 4 or 8). ksplit: splits of the K / (2G) super-groups.
extern "C" int grove_int4_matmul(const void* x, const void* wp,
                                 const float* scale, float* part, void* out,
                                 int m, int k, int n, int g, int mt,
                                 int ksplit, int dtype, void* stream) {
  if (g <= 0 || g % 32 != 0 || k % (2 * g) != 0 || n % 4 != 0 || m <= 0 ||
      ksplit < 1 || ksplit > k / (2 * g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, wp, scale, part, out, m, k, n, g, mt, ksplit, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wp, scale, part, out, m, k, n, g, mt,
                                 ksplit, st);
  return (int)cudaErrorInvalidValue;
}
