// K7b: W4A8 matmul, per-token int8 activations against group-pair packed
// int4 weights (the W4A8 LLaMA's decode projections).
//
// Replaces grove_tpu/ops/int4_matmul.py:_kernel_a8 (its pallas_call at :372,
// reached through int4_matmul_a8, :340), which Int4Dense takes for fewer
// than 64 rows with act_quant (models/layers.py:257-262): every projection
// of every decode step of the W4A8 LLaMA-7B, at M = 2 and (K, N) =
// (4096, 4096), (4096, 11008), (11008, 4096), and the fused widths.
//
//   out[m, n] = sx[m] * sum_g scale[g, n] * sum_{k in g} xq[m, k] * q4[k, n]
//
// xq (M, K) int8 with sx (M, 1) fp32; wp (K/2, N) int8 in the layout of
// grove_tpu/ops/quant.py:pack_int4 (packed row p*G + i holds logical row
// 2p*G + i in its low nibble and (2p+1)*G + i in its high nibble, so one
// "super-group" p of G packed rows carries groups 2p and 2p+1); scale (K/G,
// N) fp32. Each group's sum of products is exact in int32 (at most
// 127 * 8 * G in magnitude), converted to fp32 (exact below 2^24), times the
// group's scale and added into an fp32 sum; sx applies at the store.
//
// The TPU kernel's biased low nibble with its -8 * rowsum correction, its
// 16 * hi plane and its super-group blocking exist because Mosaic legalises
// only and/xor on int8 vectors; none of them is copied. Here each nibble is
// sign-extended exactly, four lanes of one 32-bit word at a time (within
// each byte: (n ^ 8) - 8, with the bytes' top bits set so that no borrow
// crosses a byte), and __dp4a multiplies four int8 weights of consecutive k
// with four int8 activations into an int32 sum.
//
// Bound on the H100: device-memory bytes of the weights, 0.5 B per weight
// plus the group scales (8.9 MB for a 4096 x 4096 projection), read once per
// call; the activations are a few KB. The design follows K7a
// (csrc/int4_matmul.cu): a block owns 128 output columns and MT rows of xq;
// each lane reads 4 consecutive bytes of 4 consecutive packed rows (four
// 32-bit loads, each warp-wide load a 128-byte line), transposes the 4 x 4
// bytes with __byte_perm so that each column's four k share a word, and the
// block's 8 warps split the G packed rows of each super-group. The warps'
// int32 partial sums of a group meet in shared memory (integer adds, so
// their order does not matter), then one thread per (row, column) scales
// and accumulates them in fp32. K is split over a third grid dimension so
// that the few column tiles of a decode shape fill the card; each split
// writes fp32 partial sums (ksplit, M, N) and a second small kernel adds
// them in a fixed order, multiplies by sx and casts.

#include <stdint.h>

#include "attention_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                  // columns per lane: one 32-bit load
constexpr int kTileN = 32 * kCols;        // columns per block

// the low / high nibbles of the four bytes of w, each sign-extended to an
// int8 in its own byte
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t w) {
  return (((w & 0x0F0F0F0Fu) ^ 0x88888888u) - 0x08080808u) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t w) {
  return lo_nibbles(w >> 4);
}

// the 4 x 4 byte transpose: in r[j] byte c is (row j, column c); out[c]
// byte j is the same value
__device__ __forceinline__ void transpose4(const uint32_t r[4],
                                           uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

template <int MT>
__global__ void __launch_bounds__(kThreads) int4_a8_partial_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wp,
    const float* __restrict__ scale, float* __restrict__ part, int M, int K,
    int N, int G, int supers, int ksplit) {
  // int32 group sums of the block: [MT][2 planes][kTileN]
  extern __shared__ __align__(16) int isum[];
  constexpr int kOwned = (MT * kTileN + kThreads - 1) / kThreads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kTileN + lane * kCols;
  const int m0 = blockIdx.y * MT;
  const int z = blockIdx.z;
  const int p0 = (int)((long long)supers * z / ksplit);
  const int p1 = (int)((long long)supers * (z + 1) / ksplit);
  const bool col_ok = n0 < N;             // N % 4 == 0: all 4 or none
  const int* xw = reinterpret_cast<const int*>(xq);
  const int kw = K / 4;                   // int32 words per row of xq

  for (int i = threadIdx.x; i < MT * 2 * kTileN; i += kThreads) isum[i] = 0;
  float acc[kOwned];
#pragma unroll
  for (int e = 0; e < kOwned; ++e) acc[e] = 0.f;
  __syncthreads();

  for (int p = p0; p < p1; ++p) {
    int lo[MT][kCols], hi[MT][kCols];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) lo[m][c] = hi[m][c] = 0;
    if (col_ok) {
      const int8_t* w = wp + (long long)p * G * N + n0;
      for (int i = 4 * warp; i < G; i += 4 * kWarps) {
        uint32_t r[4], wl[4], wh[4], tl[4], th[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = *reinterpret_cast<const uint32_t*>(
              w + (long long)(i + j) * N);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tl[j] = lo_nibbles(r[j]);
          th[j] = hi_nibbles(r[j]);
        }
        transpose4(tl, wl);
        transpose4(th, wh);
        const int klo = (2 * p * G + i) / 4;      // word of xq, low plane
        const int khi = ((2 * p + 1) * G + i) / 4;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int row = m0 + m;
          if (row >= M) break;
          const int xl = __ldg(xw + (long long)row * kw + klo);
          const int xh = __ldg(xw + (long long)row * kw + khi);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            lo[m][c] = __dp4a(xl, (int)wl[c], lo[m][c]);
            hi[m][c] = __dp4a(xh, (int)wh[c], hi[m][c]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          atomicAdd(&isum[(m * 2 + 0) * kTileN + lane * kCols + c], lo[m][c]);
          atomicAdd(&isum[(m * 2 + 1) * kTileN + lane * kCols + c], hi[m][c]);
        }
    }
    __syncthreads();
    // one thread per (row, column): scale the group sums, clear them
#pragma unroll
    for (int e = 0; e < kOwned; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      if (idx < MT * kTileN) {
        const int m = idx / kTileN;
        const int col = idx - m * kTileN;
        const int n = blockIdx.x * kTileN + col;
        int* s = isum + m * 2 * kTileN + col;
        if (n < N) {
          const float* sc = scale + (long long)2 * p * N + n;
          const float both = __fadd_rn(__fmul_rn((float)s[0], sc[0]),
                                       __fmul_rn((float)s[kTileN], sc[N]));
          acc[e] = __fadd_rn(acc[e], both);
        }
        s[0] = 0;
        s[kTileN] = 0;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < kOwned; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int m = idx / kTileN;
    const int row = m0 + m;
    const int n = blockIdx.x * kTileN + idx - m * kTileN;
    if (idx < MT * kTileN && row < M && n < N)
      part[((long long)z * M + row) * N + n] = acc[e];
  }
}

template <typename T>
__global__ void int4_a8_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ sx,
                                      T* __restrict__ out, int ksplit, int N,
                                      long long mn) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < ksplit; ++z) s += part[z * mn + i];
    out[i] = grove::from_f<T>(__fmul_rn(s, sx[i / N]));
  }
}

template <typename T, int MT>
int launch_mt(const void* xq, const float* sx, const void* wp,
              const float* scale, float* part, void* out, int m, int k, int n,
              int g, int ksplit, cudaStream_t st) {
  const size_t bytes = sizeof(int) * (size_t)MT * 2 * kTileN;
  const int supers = k / (2 * g);
  dim3 grid((n + kTileN - 1) / kTileN, (m + MT - 1) / MT, ksplit);
  int4_a8_partial_kernel<MT><<<grid, kThreads, bytes, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wp), scale,
      part, m, k, n, g, supers, ksplit);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long mn = (long long)m * n;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  int4_a8_reduce_kernel<T><<<blocks, 256, 0, st>>>(
      part, sx, static_cast<T*>(out), ksplit, n, mn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xq, const float* sx, const void* wp,
           const float* scale, float* part, void* out, int m, int k, int n,
           int g, int mt, int ksplit, cudaStream_t st) {
  switch (mt) {
    case 1:
      return launch_mt<T, 1>(xq, sx, wp, scale, part, out, m, k, n, g, ksplit,
                             st);
    case 2:
      return launch_mt<T, 2>(xq, sx, wp, scale, part, out, m, k, n, g, ksplit,
                             st);
    case 4:
      return launch_mt<T, 4>(xq, sx, wp, scale, part, out, m, k, n, g, ksplit,
                             st);
    case 8:
      return launch_mt<T, 8>(xq, sx, wp, scale, part, out, m, k, n, g, ksplit,
                             st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part: (ksplit, M, N) fp32 scratch the caller allocates. mt: rows of xq per
// block (1, 2, 4 or 8). ksplit: splits of the K / (2G) super-groups. dtype:
// the output's, 0 fp32 or 1 bf16.
extern "C" int grove_int4_matmul_a8(const void* xq, const float* sx,
                                    const void* wp, const float* scale,
                                    float* part, void* out, int m, int k,
                                    int n, int g, int mt, int ksplit,
                                    int dtype, void* stream) {
  if (g <= 0 || g % 32 != 0 || k % (2 * g) != 0 || n % 4 != 0 || m <= 0 ||
      ksplit < 1 || ksplit > k / (2 * g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xq, sx, wp, scale, part, out, m, k, n, g, mt, ksplit,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xq, sx, wp, scale, part, out, m, k, n, g, mt,
                                 ksplit, st);
  return (int)cudaErrorInvalidValue;
}
