// K14: ViTDet window partition and its inverse, each one stream of rows that
// writes (partition) or drops (unpartition) the zero pad itself.
//
// Replaces grove_tpu/ops/window_ops.py:_part_kernel (its pallas_call is at
// :59, through window_partition_fused, :97) and _unpart_kernel (:81,
// through window_unpartition_fused, :115), each the other's custom VJP.
// Only tests and benchmarks/window_probe.py call them in the JAX package.
//
//   partition:   x (B, H, W, C) -> windows (B, gh, gw, win, win, C),
//                windows[b, i, j, r, c] = x[b, i*win + r, j*win + c], 0 in
//                the pad (grid row or column at or past H or W)
//   unpartition: windows -> x (B, H, W, C), the inverse, the pad dropped
//
// gh = ceil(H / win), gw = ceil(W / win). The TPU kernels move an already
// padded grid and leave the pad and the pad drop to XLA; here both take the
// unpadded, contiguous grid. One window row, win * C elements, is
// contiguous on both sides, so each direction is a stream of rows (`row_of`;
// ops/window_ops.py `window_copy_plan` mirrors it and `plan`):
//   * partition: every window row t = ((b * gh + i) * gw + j) * win + r:
//     grid row y = i * win + r; where y < H its valid prefix of
//     min(win, W - j * win) pixels is copied and the rest of the row zeroed,
//     a row with y >= H is all zeros;
//   * unpartition: only the valid prefixes, in the output's order,
//     t = (b * H + y) * gw + j, each read from its window row and written to
//     the contiguous output; the pad's rows and pixels are never read.
//
// Bound on the H100: bytes, each input byte a correct call needs read once
// and each output byte written once, over 3.35 TB/s. At the full-width
// (16, 32, 32, 1280) bf16 grid, win 14 (gh = gw = 3, windows
// (144, 14, 14, 1280)): the partition reads 41.94 MB and writes 72.25 MB,
// the zero pad included, 0.0341 ms; the unpartition reads the 41.94 MB of
// valid pixels and writes 41.94 MB, 0.0250 ms.
//
// Two bodies, chosen by shape in `plan`:
//   * The bulk body (C * itemsize % 16 == 0, 16-byte aligned bases, room
//     for 2 row slots of win * C * itemsize bytes): persistent CTAs, up to
//     2 an SM, CTA k walking rows k, k + grid, ...; one thread of each
//     moves its rows with 1-D TMA bulk copies through a ring of up to 3 row
//     slots in shared memory: global -> shared completing on the slot's
//     mbarrier, shared -> global in one bulk group a row, a slot refilled
//     once `wait_group.read` says the store of the row before has read it,
//     so two rows load while one stores. No thread touches the data. The
//     partition stores a row's zeros (the pad rows, the tail of an edge row)
//     from one 4 KB slot zeroed once.
//   * The vector body (every other shape: the JAX tests' int8 at C = 8 and
//     bf16 at C = 20): one 256-thread block a row, its threads striding
//     over the valid prefix in the widest unsigned vector (16, 8, 4, 2 or 1
//     bytes) that divides a pixel's bytes and both bases, 4 loads in flight
//     a thread, then the zero tail.
// The design both replace padded the grid with a separate torch pad (a
// whole read and write of the grid), ran the vector body on the padded
// grid, and unpartitioned into a padded grid that the wrapper sliced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kMaxSlots = 3;
constexpr int kPerSm = 2;                 // persistent CTAs an SM
constexpr int kZeroBytes = 4096;          // the partition's zero slot
constexpr int kSmemLimit = 232448;        // dynamic shared bytes a block
constexpr int kSmemSm = 233472;           // shared bytes an SM
constexpr int kReserved = 1024;           // the runtime's a block
constexpr int kBulkThreads = 32;          // one thread moves, all zero
constexpr int kVecThreads = 256;

enum Body { kVector = 0, kBulk = 1 };

// the grid, in elements of `pixel` bytes
struct Geo {
  long long b, h, w, gh, gw, win, pixel, row;
  int unpartition;
};

// one row of the stream: `valid` bytes from byte `src` of the input to
// byte `dst` of the output, then `zero` zero bytes
struct Row {
  long long src, dst, valid, zero;
};

__host__ __device__ inline Row row_of(const Geo& g, long long t) {
  Row r;
  if (g.unpartition) {
    const long long j = t % g.gw, y = t / g.gw % g.h, b = t / (g.gw * g.h);
    r.src = (((b * g.gh + y / g.win) * g.gw + j) * g.win + y % g.win) * g.row;
    r.dst = ((b * g.h + y) * g.w + j * g.win) * g.pixel;
    const long long px = g.w - j * g.win;
    r.valid = (px < g.win ? px : g.win) * g.pixel;
    r.zero = 0;
  } else {
    const long long rr = t % g.win, j = t / g.win % g.gw,
                    i = t / (g.win * g.gw) % g.gh,
                    b = t / (g.win * g.gw * g.gh);
    const long long y = i * g.win + rr, px = g.w - j * g.win;
    const bool inside = y < g.h;
    r.valid = inside ? (px < g.win ? px : g.win) * g.pixel : 0;
    r.src = inside ? ((b * g.h + y) * g.w + j * g.win) * g.pixel : 0;
    r.dst = t * g.row;
    r.zero = g.row - r.valid;
  }
  return r;
}

Geo geometry(int b, int h, int w, int c, int win, int itemsize,
             int unpartition) {
  Geo g;
  g.b = b;
  g.h = h;
  g.w = w;
  g.win = win;
  g.gh = (h + win - 1) / win;
  g.gw = (w + win - 1) / win;
  g.pixel = (long long)c * itemsize;
  g.row = g.win * g.pixel;
  g.unpartition = unpartition;
  return g;
}

long long rows_of(const Geo& g) {
  return g.unpartition ? g.b * g.h * g.gw : g.b * g.gh * g.gw * g.win;
}

// The launch (ops/window_ops.py `window_copy_plan` computes the same):
// the body, ring slots, dynamic shared bytes, CTAs an SM and in all.
struct Plan {
  int body, slots, smem, per_sm;
  long long ctas;
};

Plan plan(const Geo& g, int sms, bool aligned) {
  Plan p{kVector, 0, 0, 0, rows_of(g)};
  const long long zero = g.unpartition ? 0 : kZeroBytes;
  long long slots = (kSmemLimit - zero - 8 * kMaxSlots) / g.row;
  if (slots > kMaxSlots) slots = kMaxSlots;
  if (g.pixel % 16 || !aligned || slots < 2) return p;
  p.body = kBulk;
  p.slots = (int)slots;
  p.smem = (int)(slots * g.row + zero + 8 * slots);
  p.per_sm = kSmemSm / (p.smem + kReserved);
  if (p.per_sm > kPerSm) p.per_sm = kPerSm;
  const long long most = (long long)p.per_sm * sms;
  if (p.ctas > most) p.ctas = most;
  return p;
}

using grove::bulk_copy;
using grove::mbar_expect;
using grove::mbar_init;
using grove::mbar_wait;
using grove::bulk_store;
using grove::bulk_commit;
using grove::bulk_wait_read;
using grove::bulk_wait;

__global__ void __launch_bounds__(kBulkThreads)
    window_bulk(const char* __restrict__ src, char* __restrict__ dst,
                const Geo g, long long rows, int slots, int zero_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* zero = smem + slots * g.row;
  uint64_t* bars = reinterpret_cast<uint64_t*>(zero + zero_bytes);
  for (int e = threadIdx.x * 16; e < zero_bytes; e += kBulkThreads * 16)
    *reinterpret_cast<uint4*>(zero + e) = make_uint4(0u, 0u, 0u, 0u);
  // the zeros, written by this proxy, are read by the bulk stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const long long mine = (rows - (long long)blockIdx.x + gridDim.x - 1) /
                         (long long)gridDim.x;
  auto row_at = [&](long long i) {
    return row_of(g, blockIdx.x + i * (long long)gridDim.x);
  };
  // this CTA's i-th row into slot i % slots (nothing for a pad row)
  auto load = [&](long long i) {
    const Row r = row_at(i);
    if (r.valid == 0) return;
    uint64_t* bar = bars + i % slots;
    mbar_expect(bar, (uint32_t)r.valid);
    bulk_copy(smem + (i % slots) * g.row, src + r.src, (uint32_t)r.valid,
              bar);
  };
  for (long long i = 0; i < slots && i < mine; ++i) load(i);
  uint32_t phase = 0;   // bit s: the parity slot s waits on next
  for (long long i = 0; i < mine; ++i) {
    const Row r = row_at(i);
    const int s = (int)(i % slots);
    if (r.valid) {
      mbar_wait(bars + s, (phase >> s) & 1);
      phase ^= 1u << s;
      bulk_store(dst + r.dst, smem + s * g.row, (uint32_t)r.valid);
    }
    for (long long z = 0; z < r.zero; z += zero_bytes) {
      const long long n = r.zero - z < zero_bytes ? r.zero - z : zero_bytes;
      bulk_store(dst + r.dst + r.valid + z, zero, (uint32_t)n);
    }
    bulk_commit();
    // row i - 1's slot takes row i - 1 + slots once its store has read it
    if (i >= 1 && i - 1 + slots < mine) {
      bulk_wait_read<1>();
      load(i - 1 + slots);
    }
  }
  bulk_wait<0>();
}

template <typename V>
__global__ void __launch_bounds__(kVecThreads)
    window_vector(const char* __restrict__ src, char* __restrict__ dst,
                  const Geo g) {
  const Row r = row_of(g, blockIdx.x);
  const V* s = reinterpret_cast<const V*>(src + r.src);
  V* d = reinterpret_cast<V*>(dst + r.dst);
  const long long n = r.valid / (long long)sizeof(V);
  // kUnroll loads in flight per thread before their stores
  constexpr int kUnroll = 4;
  for (long long e0 = threadIdx.x; e0 < n; e0 += kUnroll * kVecThreads) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = e0 + (long long)u * kVecThreads;
      if (e < n) buf[u] = s[e];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = e0 + (long long)u * kVecThreads;
      if (e < n) d[e] = buf[u];
    }
  }
  const long long nz = r.zero / (long long)sizeof(V);
  for (long long e = threadIdx.x; e < nz; e += kVecThreads) d[n + e] = V();
}

template <typename V>
int launch_vector(const void* src, void* dst, const Geo& g, long long rows,
                  cudaStream_t stream) {
  window_vector<V><<<(unsigned)rows, kVecThreads, 0, stream>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), g);
  return (int)cudaGetLastError();
}

int launch_bulk(const void* src, void* dst, const Geo& g, const Plan& p,
                cudaStream_t stream) {
  static int allowed[64] = {0};          // the attribute is set per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (p.smem > allowed[dev]) {
    e = cudaFuncSetAttribute(window_bulk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = p.smem;
  }
  window_bulk<<<(unsigned)p.ctas, kBulkThreads, p.smem, stream>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), g, rows_of(g),
      p.slots, g.unpartition ? 0 : kZeroBytes);
  return (int)cudaGetLastError();
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

bool shape_ok(int b, int h, int w, int c, int win, int itemsize) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || win <= 0 || itemsize <= 0)
    return false;
  const Geo g = geometry(b, h, w, c, win, itemsize, 0);
  // a grid dimension of the vector body: every row of the partition
  return rows_of(g) <= 0x7fffffffLL;
}

int window_copy_entry(const void* src, void* dst, int b, int h, int w, int c,
                      int win, int itemsize, int unpartition, void* stream) {
  const int sms = sm_count();
  if (!shape_ok(b, h, w, c, win, itemsize) || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Geo g = geometry(b, h, w, c, win, itemsize, unpartition);
  const bool aligned = ((uintptr_t)src | (uintptr_t)dst) % 16 == 0;
  const Plan p = plan(g, sms, aligned);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.body == kBulk) return launch_bulk(src, dst, g, p, st);
  const uintptr_t align = (uintptr_t)g.pixel | (uintptr_t)src |
                          (uintptr_t)dst;
  const long long rows = rows_of(g);
  if (align % 16 == 0) return launch_vector<uint4>(src, dst, g, rows, st);
  if (align % 8 == 0) return launch_vector<uint2>(src, dst, g, rows, st);
  if (align % 4 == 0) return launch_vector<uint32_t>(src, dst, g, rows, st);
  if (align % 2 == 0) return launch_vector<uint16_t>(src, dst, g, rows, st);
  return launch_vector<uint8_t>(src, dst, g, rows, st);
}

}  // namespace

// x (B, H, W, C) -> windows (B * gh * gw, win, win, C), zero-padded
extern "C" int grove_window_partition(const void* x, void* windows, int b,
                                      int h, int w, int c, int win,
                                      int itemsize, void* stream) {
  return window_copy_entry(x, windows, b, h, w, c, win, itemsize, 0, stream);
}

// windows (B * gh * gw, win, win, C) -> x (B, H, W, C), the pad dropped
extern "C" int grove_window_unpartition(const void* windows, void* x, int b,
                                        int h, int w, int c, int win,
                                        int itemsize, void* stream) {
  return window_copy_entry(windows, x, b, h, w, c, win, itemsize, 1, stream);
}

// The launch either entry makes on a card of `sms` SMs with 16-byte-aligned
// bases, for ops/window_ops.py `window_copy_plan` to be checked against:
// out[0..5] = body (0 vector, 1 bulk), ring slots, dynamic shared bytes,
// CTAs an SM, CTAs, rows.
extern "C" int grove_window_copy_plan(int b, int h, int w, int c, int win,
                                      int itemsize, int sms, int unpartition,
                                      int* out) {
  if (!shape_ok(b, h, w, c, win, itemsize) || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Geo g = geometry(b, h, w, c, win, itemsize, unpartition != 0);
  const Plan p = plan(g, sms, true);
  out[0] = p.body;
  out[1] = p.slots;
  out[2] = p.smem;
  out[3] = p.per_sm;
  out[4] = (int)p.ctas;
  out[5] = (int)rows_of(g);
  return 0;
}

// Every row of that launch, as the kernels compute it (`row_of`): out[5 t ..
// 5 t + 4] = source byte, destination byte, bytes copied, zero bytes after
// them, and the CTA that moves row t.
extern "C" int grove_window_copy_rows(int b, int h, int w, int c, int win,
                                      int itemsize, int sms, int unpartition,
                                      long long* out) {
  if (!shape_ok(b, h, w, c, win, itemsize) || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Geo g = geometry(b, h, w, c, win, itemsize, unpartition != 0);
  const Plan p = plan(g, sms, true);
  const long long rows = rows_of(g);
  for (long long t = 0; t < rows; ++t) {
    const Row r = row_of(g, t);
    long long* o = out + 5 * t;
    o[0] = r.src;
    o[1] = r.dst;
    o[2] = r.valid;
    o[3] = r.zero;
    o[4] = p.body == kBulk ? t % p.ctas : t;
  }
  return 0;
}
