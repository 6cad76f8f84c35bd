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
// TPU kernel's int32 shift and astype do: q8 is bits 8..15 of
// q4 * mult + 128, so the arithmetic only needs to be right mod 2^16. The
// result is written as the (N, K) row-major bytes of the (K, N) view:
// column-major, the layout in which torch._int_mm takes its second operand
// on the tensor cores.
//
// Bound on the H100: device-memory bytes, 0.5 B read and 1 B written per
// weight plus the multipliers: 25.69 MB at 4096 x 4096, 69.04 MB at
// 4096 x 11008 and 11008 x 4096 (0.0077 / 0.0206 / 0.0206 ms at
// 3.35 TB/s). The design:
//   * Persistent CTAs: two an SM (ops/int4_matmul.py `_requant_plan`
//     mirrors `plan` below), CTA b walking tiles b, b + grid, ... in
//     row-major tile order. A tile is 128 packed rows (64 where G % 128 is
//     64) of one super-group by 128 columns (a last tile of 64 where
//     N % 128 is 64): 16 KB read, 32 KB written.
//   * A 4-stage ring of 16-byte cp.async copies: the tile's rows (8 lanes a
//     128-byte row) and its 2 x 128 multipliers, so tiles i + 1 .. i + 3
//     are in flight while tile i is requantised (3 stages were a little
//     slower on an H100 at the 11008-wide shapes). The chunks of a row are
//     XOR-swizzled by bits 4-5 of the row, so that the reads below meet no
//     bank conflict.
//   * Registers: a thread owns 4 columns and 16 packed rows of the tile
//     (its 16-row slice); lane (x, y) = (lane / 8, lane % 8) takes slice x
//     and column quad y of its warp's share. Each 4-byte word of a row
//     splits into its two nibble planes with one LOP3 each (the nibble u
//     XOR 8 is q4 + 8, unsigned), and one dp2a a byte computes
//     (q4 + 8) * mult + (128 - 8 mult), which is q4 * mult + 128 mod 2^16.
//     Three PRMTs gather byte 1 of four rows' results into one word: the
//     4 x 4 byte transpose of K7b, done as the bytes are picked. A thread
//     ends with 16 contiguous k of each of its columns and planes.
//   * Output: those 16 bytes go to a shared staging tile [plane][column]
//     [128 k] with one 16-byte store each, the chunks XOR-swizzled by the
//     column quad (no bank conflict); then the block writes each column and
//     plane as one 128-byte run of k, 8 lanes a run, 16-byte stores.
//   * No scratch tensor; each output byte is written once.
//
// The design it replaces ran 2048 / 5504 blocks of 64 x 64 tiles, 4-byte
// loads consumed at once, 8 byte-wide shared stores a word (2-way bank
// conflicts) and 64-byte output runs, with the multipliers re-read by every
// block and nothing in flight but other resident blocks.

#include <stdint.h>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 128;               // columns a tile
constexpr int kStages = 4;                // ring depth
constexpr int kCtasPerSm = 2;
constexpr int kInBytes = 128 * kTileN;    // up to 128 packed rows
constexpr int kMultBytes = 2 * kTileN * 4;
constexpr int kStageBytes = kInBytes + kMultBytes;
constexpr int kStagingBytes = 2 * kTileN * 128;
constexpr int kSmemBytes = kStages * kStageBytes + kStagingBytes;

// The launch: packed rows a tile, tiles, CTAs (ops/int4_matmul.py
// `_requant_plan` computes the same).
struct Plan {
  int rows, tiles_n, tiles, ctas;
};

Plan plan(int kh, int n, int g, int sms) {
  Plan p;
  p.rows = g % 128 == 0 ? 128 : 64;
  p.tiles_n = (n + kTileN - 1) / kTileN;
  p.tiles = kh / p.rows * p.tiles_n;
  p.ctas = p.tiles < kCtasPerSm * sms ? p.tiles : kCtasPerSm * sms;
  return p;
}

using grove::cp_async16;
using grove::cp_async_commit;
using grove::cp_async_wait;

// byte offset of 16-byte chunk `ch` of packed row `row` in a stage
__device__ __forceinline__ int in_off(int row, int ch) {
  return row * 128 + ((ch ^ (((row >> 4) & 3) << 1)) << 4);
}

// byte offset of 16-byte chunk `t` (k 16t .. 16t + 15) of (plane, column)
// in the staging tile
__device__ __forceinline__ int out_off(int plane, int col, int t) {
  return (plane * kTileN + col) * 128 + ((t ^ ((col >> 2) & 7)) << 4);
}

// byte 1 of v[0..3] as bytes 0..3 of one word
__device__ __forceinline__ uint32_t gather(const uint32_t v[4]) {
  const uint32_t lo = __byte_perm(v[0], v[1], 0x0051);
  const uint32_t hi = __byte_perm(v[2], v[3], 0x0051);
  return __byte_perm(lo, hi, 0x5410);
}

// the four (q4 + 8) * mult + (128 - 8 mult) of one word's nibble plane u
// (byte c: column c's q4 + 8), a[c] holding mult in the half of the dp2a
// operand that meets byte c
__device__ __forceinline__ void requant4(uint32_t u, const uint32_t a[4],
                                         const uint32_t c[4], uint32_t v[4]) {
  v[0] = __dp2a_lo(a[0], u, c[0]);
  v[1] = __dp2a_lo(a[1], u, c[1]);
  v[2] = __dp2a_hi(a[2], u, c[2]);
  v[3] = __dp2a_hi(a[3], u, c[3]);
}

template <int kRows>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) requant_kernel(
    const int8_t* __restrict__ wp, const int* __restrict__ mult,
    int8_t* __restrict__ out, int kh, int n, int g, int tiles_n,
    int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* staging = smem + kStages * kStageBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long k_len = 2LL * kh;
  const int count = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;

  // the copies of this CTA's i-th tile into stage i % kStages, one commit
  // group (empty past the CTA's last tile)
  auto issue = [&](int i) {
    const int t = (int)blockIdx.x + i * (int)gridDim.x;
    if (i < count) {
      unsigned char* st = smem + (i % kStages) * kStageBytes;
      const int rt = t / tiles_n, ct = t - rt * tiles_n;
      const int r0 = rt * kRows, n0 = ct * kTileN;
      const int p = r0 / g;
      const int cpr = min(kTileN, n - n0) >> 4;      // 16-byte chunks a row
      for (int c = tid; c < kRows * 8; c += kThreads) {
        const int row = c >> 3, ch = c & 7;
        if (ch < cpr)
          cp_async16(st + in_off(row, ch),
                     wp + (long long)(r0 + row) * n + n0 + ch * 16);
      }
      if (tid < 64) {
        const int plane = tid >> 5, ch = tid & 31;
        if (ch < cpr * 4)
          cp_async16(st + kInBytes + plane * 4 * kTileN + ch * 16,
                     mult + (long long)(2 * p + plane) * n + n0 + ch * 4);
      }
    }
    cp_async_commit();
  };

  for (int i = 0; i < kStages - 1; ++i) issue(i);
  const int x = lane >> 3, y = lane & 7;
  const int cq = 8 * (warp & 3) + y;            // columns 4 cq .. 4 cq + 3
  const int s = 4 * (warp >> 2) + x;            // packed rows 16 s .. + 15
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();    // tile i landed; stage (i - 1) % kStages and the
                        // staging tile are free
    issue(i + kStages - 1);
    const int t = (int)blockIdx.x + i * (int)gridDim.x;
    const int rt = t / tiles_n, ct = t - rt * tiles_n;
    const int r0 = rt * kRows, n0 = ct * kTileN;
    const int p = r0 / g, i0 = r0 - p * g;
    const int tw = min(kTileN, n - n0);
    const unsigned char* st = smem + (i % kStages) * kStageBytes;
    if (s < kRows / 16 && 4 * cq < tw) {
      uint32_t a[2][4], c[2][4];
#pragma unroll
      for (int plane = 0; plane < 2; ++plane) {
        const int4 m = *reinterpret_cast<const int4*>(
            st + kInBytes + plane * 4 * kTileN + cq * 16);
        const int ms[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[plane][e] = (e & 1) ? (uint32_t)ms[e] << 16
                                : (uint32_t)ms[e] & 0xFFFFu;
          c[plane][e] = 128u - 8u * (uint32_t)ms[e];
        }
      }
      uint32_t o[2][4][4];                       // [plane][column][word]
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        uint32_t v[2][4][4];                     // [plane][column][row]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = 16 * s + 4 * b + j;
          const uint32_t r = *reinterpret_cast<const uint32_t*>(
              st + in_off(row, cq >> 2) + (cq & 3) * 4);
          uint32_t u[2], w[2][4];
          u[0] = (r ^ 0x08080808u) & 0x0F0F0F0Fu;
          u[1] = ((r >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;
#pragma unroll
          for (int plane = 0; plane < 2; ++plane) {
            requant4(u[plane], a[plane], c[plane], w[plane]);
#pragma unroll
            for (int e = 0; e < 4; ++e) v[plane][e][j] = w[plane][e];
          }
        }
#pragma unroll
        for (int plane = 0; plane < 2; ++plane)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[plane][e][b] = gather(v[plane][e]);
      }
#pragma unroll
      for (int plane = 0; plane < 2; ++plane)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<uint4*>(staging +
                                    out_off(plane, 4 * cq + e, s)) =
              make_uint4(o[plane][e][0], o[plane][e][1], o[plane][e][2],
                         o[plane][e][3]);
    }
    __syncthreads();    // the staging tile is written
    constexpr int kChunks = kRows / 16;         // 16-byte chunks of k a run
    for (int idx = tid; idx < 2 * tw * kChunks; idx += kThreads) {
      const int ch = idx % kChunks, run = idx / kChunks;
      const int plane = run >= tw, col = run - plane * tw;
      *reinterpret_cast<uint4*>(
          out + (long long)(n0 + col) * k_len +
          (long long)(2 * p + plane) * g + i0 + 16 * ch) =
          *reinterpret_cast<const uint4*>(staging + out_off(plane, col, ch));
    }
  }
}

template <int kRows>
int launch(const Plan& pl, const int8_t* wp, const int* mult, int8_t* out,
           int kh, int n, int g, cudaStream_t st) {
  auto kernel = requant_kernel<kRows>;
  static bool ready[64] = {false};       // the attribute is set per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  kernel<<<pl.ctas, kThreads, kSmemBytes, st>>>(wp, mult, out, kh, n, g,
                                                pl.tiles_n, pl.tiles);
  return (int)cudaGetLastError();
}

bool shape_ok(int kh, int n, int g) {
  return g > 0 && g % 64 == 0 && kh > 0 && kh % g == 0 && n > 0 &&
         n % 64 == 0;
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

}  // namespace

// wp (kh, N) packed int8; mult (2 kh / G, N) int32; out (N, 2 kh) int8.
// G and N multiples of 64; wp and mult on 16 bytes.
extern "C" int grove_int4_requant_int8(const void* wp, const void* mult,
                                       void* out, int kh, int n, int g,
                                       void* stream) {
  const int sms = sm_count();
  if (!shape_ok(kh, n, g) || sms <= 0) return (int)cudaErrorInvalidValue;
  const Plan pl = plan(kh, n, g, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int8_t*>(wp);
  const auto* m = static_cast<const int*>(mult);
  auto* o = static_cast<int8_t*>(out);
  return pl.rows == 128 ? launch<128>(pl, w, m, o, kh, n, g, st)
                        : launch<64>(pl, w, m, o, kh, n, g, st);
}

// The launch the entry makes on a card of `sms` SMs, for
// ops/int4_matmul.py `_requant_plan` to be checked against: plan[0..4] =
// packed rows a tile, tiles, CTAs, ring stages, dynamic shared bytes.
extern "C" int grove_int4_requant_int8_plan(int kh, int n, int g, int sms,
                                            int* out) {
  if (!shape_ok(kh, n, g) || sms <= 0) return (int)cudaErrorInvalidValue;
  const Plan pl = plan(kh, n, g, sms);
  out[0] = pl.rows;
  out[1] = pl.tiles;
  out[2] = pl.ctas;
  out[3] = kStages;
  out[4] = kSmemBytes;
  return 0;
}
