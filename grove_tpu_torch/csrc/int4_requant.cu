// K7c: group-pair packed int4 -> per-channel int8 view, stored column-major
// (the W4A8 LLaMA's prefill projections).
//
// Replaces grove_tpu/ops/int4_matmul.py:_kernel_requant (its pallas_call at
// :270, reached through int4_requant_int8, :252), which Int4Dense runs
// before its int8 GEMM for 64 rows or more with act_quant
// (models/layers.py:208-237): every projection of every LLaMA forward of 64
// tokens or more (prefill, the teacher-forced pass) of the W4A8 model.
//
//   q8[k, n] = (q4[k, n] * mult[k / G, n] + 128) >> 8      (int32, to int8)
//
// wp (K/2, N) int8 in the layout of grove_tpu/ops/quant.py:pack_int4
// (packed row p*G + i holds logical row 2p*G + i in its low nibble and
// (2p+1)*G + i in its high nibble); mult (K/G, N) int32, the fixed-point
// factor round(256 * s_g / s8) of each group to its channel's int8 scale.
// The shift is arithmetic and the cast to int8 keeps the low byte, as the
// TPU kernel's int32 shift and astype do. The result is written as the
// (N, K) row-major bytes of the (K, N) view: column-major, the layout in
// which torch._int_mm takes its second operand on the tensor cores.
//
// Bound on the H100: device-memory bytes, 0.5 B read and 1 B written per
// weight plus the multipliers (25.7 MB for a 4096 x 4096 projection). The
// kernel is a transpose, so the design stages a tile in shared memory so
// that both sides are coalesced: a block of 256 threads takes 64 packed rows
// (within one super-group: G % 64 == 0) by 64 columns; each thread reads 4
// consecutive bytes of a row (a warp reads two 64-byte rows), requantises
// both nibble planes in registers and stores them transposed in shared
// memory; the block then writes, for each of its 64 columns, 64 consecutive
// k of each plane as 32-bit words.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                 // packed rows per tile
constexpr int kTileN = 64;                // columns per tile
constexpr int kPad = kRows + 4;           // shared row stride, 4-byte aligned

__device__ __forceinline__ int8_t requant(int q4, int mult) {
  return (int8_t)((q4 * mult + 128) >> 8);
}

__global__ void __launch_bounds__(kThreads) int4_requant_kernel(
    const int8_t* __restrict__ wp, const int* __restrict__ mult,
    int8_t* __restrict__ out, int K, int N, int G) {
  __shared__ __align__(4) int8_t tile[2][kTileN][kPad];   // [plane][n][i]
  const int r0 = blockIdx.y * kRows;      // first packed row of the tile
  const int n0 = blockIdx.x * kTileN;
  const int p = r0 / G;                   // its super-group
  const int i0 = r0 - p * G;              // its first row in the super-group
  const int c4 = (threadIdx.x % (kTileN / 4)) * 4;
  int mlo[4], mhi[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mlo[c] = mult[(long long)(2 * p) * N + n0 + c4 + c];
    mhi[c] = mult[(long long)(2 * p + 1) * N + n0 + c4 + c];
  }
  for (int r = threadIdx.x / (kTileN / 4); r < kRows;
       r += kThreads / (kTileN / 4)) {
    const char4 b = *reinterpret_cast<const char4*>(
        wp + (long long)(r0 + r) * N + n0 + c4);
    const int8_t bytes[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int lo = (int8_t)((uint32_t)(uint8_t)bytes[c] << 4) >> 4;
      const int hi = bytes[c] >> 4;
      tile[0][c4 + c][r] = requant(lo, mlo[c]);
      tile[1][c4 + c][r] = requant(hi, mhi[c]);
    }
  }
  __syncthreads();
  constexpr int kWords = kRows / 4;       // 32-bit words per column and plane
  for (int w = threadIdx.x; w < 2 * kTileN * kWords; w += kThreads) {
    const int plane = w / (kTileN * kWords);
    const int rem = w - plane * kTileN * kWords;
    const int n = rem / kWords;
    const int kw = rem - n * kWords;
    const long long k = (long long)(2 * p + plane) * G + i0 + kw * 4;
    *reinterpret_cast<uint32_t*>(out + (long long)(n0 + n) * K + k) =
        *reinterpret_cast<const uint32_t*>(&tile[plane][n][kw * 4]);
  }
}

}  // namespace

// wp (kh, N) packed int8; mult (2 kh / G, N) int32; out (N, 2 kh) int8.
extern "C" int grove_int4_requant_int8(const void* wp, const void* mult,
                                       void* out, int kh, int n, int g,
                                       void* stream) {
  if (g <= 0 || g % kRows != 0 || kh % g != 0 || n <= 0 || n % kTileN != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(n / kTileN, kh / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int4_requant_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(wp), static_cast<const int*>(mult),
      static_cast<int8_t*>(out), 2 * kh, n, g);
  return (int)cudaGetLastError();
}
