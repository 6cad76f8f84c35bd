// K14: ViTDet window partition and its inverse, one block copy each.
//
// Replaces grove_tpu/ops/window_ops.py:_part_kernel (its pallas_call is at
// :59, through window_partition_fused, :97) and _unpart_kernel (:81,
// through window_unpartition_fused, :115), each the other's custom VJP.
// Only tests and benchmarks/window_probe.py call them in the JAX package.
//
//   partition:   x (B, Hp, Wp, C) -> windows (B, gh, gw, win, win, C),
//                windows[b, i, j, r, c] = x[b, i*win + r, j*win + c]
//   unpartition: the inverse,
//
// gh = Hp / win, gw = Wp / win. The zero pad before the partition and the
// pad drop after the unpartition stay outside, in torch, as they stay in
// XLA around the TPU kernels. Both tensors are contiguous, so one row of a
// window, win * C elements, is contiguous on both sides: the kernel is a
// gather of (B * gh * gw * win) such rows. One thread block moves one row,
// its threads striding over it in the widest unsigned vector (16, 8, 4, 2
// or 1 bytes) that divides a pixel's C * itemsize bytes and both base
// addresses, so any element size works (the JAX tests run it on int8).
//
// Bound on the H100: bytes, every element read once and written once over
// 3.35 TB/s (2 x 72 MB at the full-width (16, 42, 42, 1280) bf16 grid).
// The TPU kernel moved (win, Wp, C) row bands through VMEM and sliced the
// columns there (Mosaic's block shapes forbid win-sized blocks); here the
// address arithmetic runs once per row and the loads are 16 bytes wide
// when C * itemsize allows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void __launch_bounds__(256)
    window_copy(const V* __restrict__ src, V* __restrict__ dst, int gh,
                int gw, int win, int hp, int wp, int pixel_vecs,
                int unpartition) {
  // blockIdx.x = ((b * gh + i) * gw + j) * win + r: one window row
  const long long row = blockIdx.x;
  const int r = (int)(row % win);
  long long t = row / win;
  const int j = (int)(t % gw);
  t /= gw;
  const int i = (int)(t % gh);
  const long long b = t / gh;
  const long long n = (long long)win * pixel_vecs;
  const long long grid_off =
      ((b * hp + (long long)i * win + r) * wp + (long long)j * win) *
      pixel_vecs;
  const long long win_off = row * n;
  const V* s = src + (unpartition ? win_off : grid_off);
  V* d = dst + (unpartition ? grid_off : win_off);
  // kUnroll loads in flight per thread before their stores
  constexpr int kUnroll = 4;
  for (long long e0 = threadIdx.x; e0 < n; e0 += kUnroll * blockDim.x) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = e0 + (long long)u * blockDim.x;
      if (e < n) buf[u] = s[e];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = e0 + (long long)u * blockDim.x;
      if (e < n) d[e] = buf[u];
    }
  }
}

template <typename V>
int launch(const void* src, void* dst, int b, int hp, int wp, int win,
           long long pixel_bytes, int unpartition, cudaStream_t stream) {
  const int gh = hp / win;
  const int gw = wp / win;
  const long long rows = (long long)b * gh * gw * win;
  if (rows == 0) return 0;
  window_copy<V><<<(unsigned)rows, 256, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), gh, gw, win, hp, wp,
      (int)(pixel_bytes / sizeof(V)), unpartition);
  return (int)cudaGetLastError();
}

int window_copy_entry(const void* src, void* dst, int b, int hp, int wp,
                      int c, int win, int itemsize, int unpartition,
                      void* stream) {
  if (b < 0 || win <= 0 || hp % win != 0 || wp % win != 0 || c <= 0 ||
      itemsize <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)b * (hp / win) * (wp / win) * win > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long pixel_bytes = (long long)c * itemsize;
  const uintptr_t align = (uintptr_t)pixel_bytes | (uintptr_t)src |
                          (uintptr_t)dst;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0)
    return launch<uint4>(src, dst, b, hp, wp, win, pixel_bytes, unpartition,
                         st);
  if (align % 8 == 0)
    return launch<uint2>(src, dst, b, hp, wp, win, pixel_bytes, unpartition,
                         st);
  if (align % 4 == 0)
    return launch<uint32_t>(src, dst, b, hp, wp, win, pixel_bytes,
                            unpartition, st);
  if (align % 2 == 0)
    return launch<uint16_t>(src, dst, b, hp, wp, win, pixel_bytes,
                            unpartition, st);
  return launch<uint8_t>(src, dst, b, hp, wp, win, pixel_bytes, unpartition,
                         st);
}

}  // namespace

// x (B, Hp, Wp, C) -> windows (B * gh * gw, win, win, C)
extern "C" int grove_window_partition(const void* x, void* windows, int b,
                                      int hp, int wp, int c, int win,
                                      int itemsize, void* stream) {
  return window_copy_entry(x, windows, b, hp, wp, c, win, itemsize, 0,
                           stream);
}

// windows (B * gh * gw, win, win, C) -> x (B, Hp, Wp, C)
extern "C" int grove_window_unpartition(const void* windows, void* x, int b,
                                        int hp, int wp, int c, int win,
                                        int itemsize, void* stream) {
  return window_copy_entry(windows, x, b, hp, wp, c, win, itemsize, 1,
                           stream);
}
