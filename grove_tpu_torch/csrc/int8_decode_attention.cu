// K6: one greedy decode step of attention over the int8 KV cache.
//
// Replaces grove_tpu/ops/decode_attention.py:_decode_kernel (its pallas_call
// is at :122, reached through int8_cache_decode_attention, :89), used by
// every decode step of LLaMA-7B over the int8 cache (models/llama.py
// :273-284) at the full-width shape (B = 2, H = Hkv = 32, Cpad = 768,
// D = 128).
//
//   q (B, H, D) float or bf16, kt/vt (B, Hkv, C, D) int8,
//   k_s/v_s (B, Hkv, C) bf16, bias (B, C) fp32 (0 or -1e9) -> out (B, H, D)
//
// Query head h reads kv head h / (H / Hkv) (the jnp.repeat semantics of the
// reference; the TPU kernel's head permutation was a layout device). The
// steps and their rounding points are the TPU kernel's:
//   1. q is quantised per head: qs = max(|q| / 127, 1e-8),
//      qi = clip(rint(q / qs), -127, 127);
//   2. logit[c] = ((float)(qi . k[c]) * qs) * k_s[c] * inv_sqrt_d + bias[c],
//      the int8 dot exact in int32;
//   3. fp32 softmax over the C slots: e = exp(l - max), w = e / sum(e);
//   4. w' = bf16(w * v_s[c]), out[d] = sum_c w' * (float)v[c, d] in fp32.
//
// Bound on the H100: device-memory bytes, 2 C D int8 of K and V per (batch,
// kv head) (12.8 MB at full width, 0.0038 ms at 3.35 TB/s). The design:
//   * One launch, one thread-block cluster per (batch, kv head); its ranks
//     split the C slots into contiguous ranges (`_plan` in
//     ops/decode_attention.py chooses the cluster, 2 at full width: 128 CTAs
//     on 132 SMs, one wave). A CTA computes every query head of its kv head
//     (H / Hkv of them), so each K and V slab is read once a batch row.
//   * The rank's K and V slices are contiguous in the cache. One thread
//     issues TMA bulk copies (cp.async.bulk, 1-D), each completing on an
//     mbarrier: first the small ones (the group's q, the rank's k_s, v_s
//     and bias, on one barrier), so that they do not queue behind the
//     cache (plain loads issued after the cache's copies wait for most of
//     its stream, and the logits with them), then K's and V's slices, 128
//     slots a copy, through a ring of two shared-memory buffers: a copy is
//     issued into a buffer once the block has consumed it, and the logits
//     start as soon as K's first copy has landed (at full width 6 copies, 48
//     KB of K and 48 KB of V a rank; a ring that holds all six was no faster
//     on an H100, and a deeper ring costs CTAs an SM). Ranks start on
//     multiples of 8 slots and C is a multiple of 8, so every slice lies on
//     16 bytes.
//   * Logits: two threads a slot, each __dp4a over half of its row's
//     16-byte chunks read from shared memory (rotated by slot, so that a
//     quarter warp reads 8 distinct chunks: no bank conflict at D = 128),
//     added with one shuffle; the int32 sum is exact. The logit and P.V
//     loops take one query head a pass where a kv head has one (MHA), else
//     four (HB).
//   * The softmax keeps the TPU kernel's rounding points, so the split is
//     two-phase, not flash-decoding's rescale-after: each rank publishes
//     its local max; after a cluster barrier every rank reads all ranks'
//     maxima through distributed shared memory (DSMEM) in rank order; each
//     computes e = exp(l - max) and publishes its local sum; the global sum
//     comes the same way, added in rank order; then w = bf16(e / sum * v_s)
//     (normalise, scale, round, as the TPU kernel does). A rank whose slots
//     are all masked gets e = 0 there, so its share is exact zeros.
//   * P.V: a lane owns 4 columns, the warps split the slots; int8 V becomes
//     fp32 without I2F (PRMT into 0x4B0000XX, minus 2^23 + 128), fp32 FMAs,
//     each warp's sums kept in shared memory across copies; then the
//     warps' sums are added in order, and the ranks' (H / Hkv, D) partial
//     outputs through DSMEM in rank order, each rank writing its share once.
//   * No scratch tensor, no second launch, no atomics.
//
// The design it replaces ran one block per (batch, query head), 64
// CTAs on 132 SMs, and walked the 96 KB of its K and V one slot per warp
// iteration: a lane loaded 4 bytes, a 5-step shuffle reduction finished
// before the warp went on, so about one 128-byte line was in flight a warp.

#include <cooperative_groups.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "attention_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kChunk = 128;            // slots a bulk copy brings
constexpr int kMaxCluster = 8;
constexpr size_t kSmemLimit = 232448;

__host__ __device__ constexpr int up16(int x) { return (x + 15) & ~15; }

// Byte offsets of the shared-memory arrays (ops/decode_attention.py
// `_smem` mirrors `total`). span: the longest rank's slots; g: query heads
// of a kv head.
struct Layout {
  int ring;      // ring buffers of kChunk slots x D int8
  int lg;        // [g][span] fp32 logits, then e, then w
  int qraw;      // [g][D] q as it comes (fp32 or bf16)
  int ks, vs;    // [span] bf16 k_s, v_s
  int bias;      // [span] fp32
  int q;         // [g][D] int8 quantised q
  int qs;        // [g] fp32 q scales
  int pv;        // [kWarps][g][D] fp32 each warp's P.V sums
  int part;      // [g][D] fp32 this rank's output, read by the cluster
  int stat;      // [2 g] fp32 this rank's max, then sum, per head
  int glob;      // [2 g] fp32 the cluster's max and sum
  int red;       // [kWarps] fp32 block reductions
  int bars;      // [ring + 1] mbarriers: the ring's, then the small copies'
  int total;
};

__host__ __device__ inline Layout layout(int ring, int span, int g, int d) {
  Layout l;
  l.ring = 0;
  l.lg = ring * kChunk * d;
  l.qraw = l.lg + up16(4 * g * span);
  l.ks = l.qraw + 4 * g * d;
  l.vs = l.ks + up16(2 * span);
  l.bias = l.vs + up16(2 * span);
  l.q = l.bias + up16(4 * span);
  l.qs = l.q + up16(g * d);
  l.pv = l.qs + up16(4 * g);
  l.part = l.pv + 4 * kWarps * g * d;
  l.stat = l.part + 4 * g * d;
  l.glob = l.stat + up16(8 * g);
  l.red = l.glob + up16(8 * g);
  l.bars = l.red + up16(4 * kWarps);
  l.total = l.bars + 8 * (ring + 1);
  return l;
}

// rank r's first slot: ranks split the C / 8 groups of 8 slots
__host__ __device__ inline int rank_start(int c, int n, int r) {
  return 8 * (int)((long long)(c / 8) * r / n);
}

struct DecodeArgs {
  const void* q;
  const int8_t* kt;
  const int8_t* vt;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const float* bias;
  void* out;
  int h, hkv, c, d;
  int cluster;   // ranks splitting the slots
  int ring;      // bulk-copy buffers
  int span;      // slots of the longest rank, 8 ceil(C / 8 cluster)
  float inv_sqrt_d;
};

using grove::bulk_copy;
using grove::mbar_expect;
using grove::mbar_init;
using grove::mbar_wait;

// four int8 to exact floats: each byte b + 128 under the bits of 2^23,
// minus 2^23 + 128 (PRMT and FADD, no I2F)
__device__ __forceinline__ void i8x4_to_f(uint32_t v, float f[4]) {
  const uint32_t x = v ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + e)) -
           8388736.f;
}

// Max (kMax) or sum over the block; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  x = kMax ? grove::warp_max(x) : grove::warp_sum(x);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                        // scratch free from its last use
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = lane < kWarps ? scratch[lane] : (kMax ? -INFINITY : 0.f);
  return kMax ? grove::warp_max(x) : grove::warp_sum(x);
}

// HB: query heads a pass of the logit and P.V loops takes, 1 where the
// kv head has one (MHA), else 4
template <typename T, int HB>
__global__ void __launch_bounds__(kThreads, 1)
    decode_kernel(const DecodeArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = a.cluster;
  const int bk = (int)blockIdx.x / n;          // batch * Hkv + kv head
  const int b = bk / a.hkv;
  const int kvh = bk - b * a.hkv;
  const int g = a.h / a.hkv;                   // query heads of the kv head
  const int d = a.d;
  const int s0 = rank_start(a.c, n, rank);
  const int len = (rank + 1 < n ? rank_start(a.c, n, rank + 1) : a.c) - s0;
  const int chunks = (len + kChunk - 1) / kChunk;
  const int copies = 2 * chunks;               // K's, then V's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(a.ring, a.span, g, d);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + L.ring);
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  T* qraw = reinterpret_cast<T*>(smem + L.qraw);
  __nv_bfloat16* sks = reinterpret_cast<__nv_bfloat16*>(smem + L.ks);
  __nv_bfloat16* svs = reinterpret_cast<__nv_bfloat16*>(smem + L.vs);
  float* sbias = reinterpret_cast<float*>(smem + L.bias);
  int8_t* sq = reinterpret_cast<int8_t*>(smem + L.q);
  float* sqs = reinterpret_cast<float*>(smem + L.qs);
  float* pv = reinterpret_cast<float*>(smem + L.pv);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  float* glob = reinterpret_cast<float*>(smem + L.glob);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* pre = bars + a.ring;               // the small copies' barrier

  const long long slab = (long long)bk * a.c + s0;   // the rank's first slot
  const long long q0 = ((long long)b * a.h + (long long)kvh * g) * d;
  // copy i: K's chunk i, or V's chunk i - chunks, into buffer i % ring
  auto issue = [&](int i) {
    const bool isv = i >= chunks;
    const int ch = isv ? i - chunks : i;
    const uint32_t bytes = (uint32_t)(min(kChunk, len - ch * kChunk) * d);
    mbar_expect(bars + i % a.ring, bytes);
    bulk_copy(ring + (i % a.ring) * kChunk * d,
              (isv ? a.vt : a.kt) + (slab + (long long)ch * kChunk) * d,
              bytes, bars + i % a.ring);
  };
  if (tid == 0) {
    for (int i = 0; i <= a.ring; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t qb = (uint32_t)(g * d * sizeof(T));
    mbar_expect(pre, qb + (uint32_t)len * 8);
    bulk_copy(qraw, static_cast<const T*>(a.q) + q0, qb, pre);
    bulk_copy(sks, a.ks + slab, (uint32_t)len * 2, pre);
    bulk_copy(svs, a.vs + slab, (uint32_t)len * 2, pre);
    bulk_copy(sbias, a.bias + (long long)b * a.c + s0, (uint32_t)len * 4,
              pre);
    for (int i = 0; i < min(a.ring, copies); ++i) issue(i);
  }
  for (int i = tid; i < kWarps * g * d; i += kThreads) pv[i] = 0.f;
  __syncthreads();                  // the barriers are initialised

  // 1. q quantised per head, a warp a head
  mbar_wait(pre, 0);
  for (int j = warp; j < g; j += kWarps) {
    float v[kMaxD / 32];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < d ? grove::to_f(qraw[j * d + e]) : 0.f;
      amax = fmaxf(amax, fabsf(v[i]));
    }
    const float qs = fmaxf(grove::warp_max(amax) / 127.f, 1e-8f);
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int e = lane + 32 * i;
      if (e < d)
        sq[j * d + e] = (int8_t)fminf(fmaxf(rintf(v[i] / qs), -127.f), 127.f);
    }
    if (lane == 0) sqs[j] = qs;
  }
  __syncthreads();

  // 2. logits, K's copies: two threads a slot, each over half its chunks
  const int words16 = d / 16;                  // 16-byte chunks of a row
  const int half = tid & 1, slot = tid >> 1;   // kThreads / 2 == kChunk
  const int rot = words16 % 2 ? 0 : 2 * ((lane >> 1) % (words16 / 2));
  for (int ch = 0; ch < chunks; ++ch) {
    mbar_wait(bars + ch % a.ring, (ch / a.ring) & 1);
    const int slots = min(kChunk, len - ch * kChunk);
    const int8_t* krow =
        ring + (ch % a.ring) * kChunk * d + min(slot, slots - 1) * d;
    const int i = ch * kChunk + slot;
    for (int j0 = 0; j0 < g; j0 += HB) {
      int acc[HB];
#pragma unroll
      for (int jj = 0; jj < HB; ++jj) acc[jj] = 0;
      for (int w = half; w < words16; w += 2) {
        const int cw = (w + rot) % words16;
        const int4 kw = *reinterpret_cast<const int4*>(krow + 16 * cw);
#pragma unroll
        for (int jj = 0; jj < HB; ++jj) {
          if (HB == 1 || j0 + jj < g) {
            const int4 qw = *reinterpret_cast<const int4*>(
                sq + (j0 + jj) * d + 16 * cw);
            acc[jj] = __dp4a(kw.x, qw.x, acc[jj]);
            acc[jj] = __dp4a(kw.y, qw.y, acc[jj]);
            acc[jj] = __dp4a(kw.z, qw.z, acc[jj]);
            acc[jj] = __dp4a(kw.w, qw.w, acc[jj]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < HB; ++jj) {
        acc[jj] += __shfl_xor_sync(0xffffffffu, acc[jj], 1);
        const int j = j0 + jj;
        if (half == 0 && slot < slots && (HB == 1 || j < g))
          lg[j * a.span + i] =
              ((float)acc[jj] * sqs[j]) * __bfloat162float(sks[i]) *
                  a.inv_sqrt_d +
              sbias[i];
      }
    }
    __syncthreads();                            // the buffer is consumed
    if (tid == 0 && ch + a.ring < copies) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(ch + a.ring);
    }
  }

  // 3. the softmax, two-phase over the cluster: the ranks' maxima, then
  // their sums, each read through DSMEM in rank order
  for (int j = 0; j < g; ++j) {
    float m = -INFINITY;
    for (int i = tid; i < len; i += kThreads) m = fmaxf(m, lg[j * a.span + i]);
    m = block_reduce<true>(m, red);
    if (tid == 0) stat[j] = m;
  }
  cluster.sync();
  for (int j = tid; j < g; j += kThreads) {
    float m = -INFINITY;
    for (int r = 0; r < n; ++r) m = fmaxf(m, cluster.map_shared_rank(stat, r)[j]);
    glob[j] = m;
  }
  __syncthreads();
  for (int j = 0; j < g; ++j) {
    float s = 0.f;
    for (int i = tid; i < len; i += kThreads) {
      const float e = expf(lg[j * a.span + i] - glob[j]);
      lg[j * a.span + i] = e;
      s += e;
    }
    s = block_reduce<false>(s, red);
    if (tid == 0) stat[g + j] = s;
  }
  cluster.sync();
  for (int j = tid; j < g; j += kThreads) {
    float s = 0.f;
    for (int r = 0; r < n; ++r) s += cluster.map_shared_rank(stat, r)[g + j];
    glob[g + j] = s;
  }
  __syncthreads();
  for (int j = 0; j < g; ++j)
    for (int i = tid; i < len; i += kThreads)
      lg[j * a.span + i] = __bfloat162float(__float2bfloat16(
          lg[j * a.span + i] / glob[g + j] * __bfloat162float(svs[i])));
  __syncthreads();

  // 4. P.V, V's copies: a lane 4 columns, the warps over the slots
  const int words = d / 4;
  for (int ch = 0; ch < chunks; ++ch) {
    const int i = chunks + ch;
    mbar_wait(bars + i % a.ring, (i / a.ring) & 1);
    const int slots = min(kChunk, len - ch * kChunk);
    const int8_t* vb = ring + (i % a.ring) * kChunk * d;
    if (lane < words) {
      for (int j0 = 0; j0 < g; j0 += HB) {
        float acc[HB][4] = {};
        for (int s = warp; s < slots; s += kWarps) {
          float f[4];
          i8x4_to_f(*reinterpret_cast<const uint32_t*>(vb + s * d + 4 * lane),
                    f);
#pragma unroll
          for (int jj = 0; jj < HB; ++jj) {
            if (HB == 1 || j0 + jj < g) {
              const float w = lg[(j0 + jj) * a.span + ch * kChunk + s];
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[jj][e] = fmaf(w, f[e], acc[jj][e]);
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < HB; ++jj) {
          if (HB == 1 || j0 + jj < g) {
            float4* p = reinterpret_cast<float4*>(
                pv + (warp * g + j0 + jj) * d + 4 * lane);
            float4 t = *p;
            t.x += acc[jj][0];
            t.y += acc[jj][1];
            t.z += acc[jj][2];
            t.w += acc[jj][3];
            *p = t;
          }
        }
      }
    }
    __syncthreads();                            // the buffer is consumed
    if (tid == 0 && i + a.ring < copies) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + a.ring);
    }
  }
  // the warps' sums in order, then the ranks' in rank order
  for (int e = tid; e < g * d; e += kThreads) {
    float s = pv[e];
    for (int w = 1; w < kWarps; ++w) s += pv[w * g * d + e];
    part[e] = s;
  }
  cluster.sync();
  T* out = static_cast<T*>(a.out) +
           ((long long)b * a.h + (long long)kvh * g) * d;
  const int e1 = (int)((long long)g * d * (rank + 1) / n);
  for (int e = (int)((long long)g * d * rank / n) + tid; e < e1;
       e += kThreads) {
    float s = 0.f;
    for (int r = 0; r < n; ++r) s += cluster.map_shared_rank(part, r)[e];
    out[e] = grove::from_f<T>(s);
  }
  cluster.sync();                  // no rank leaves while its part is read
}

template <typename T, int HB>
int launch(const DecodeArgs& a, int b, size_t bytes, cudaStream_t st) {
  auto kernel = decode_kernel<T, HB>;
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * a.hkv * a.cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_heads(const DecodeArgs& a, int b, size_t bytes, cudaStream_t st) {
  return a.h == a.hkv ? launch<T, 1>(a, b, bytes, st)
                      : launch<T, 4>(a, b, bytes, st);
}

}  // namespace

// Dynamic shared memory of one CTA (ops/decode_attention.py `_smem`
// mirrors it).
extern "C" long long grove_int8_decode_attention_smem(int ring, int span,
                                                      int g, int d) {
  return layout(ring, span, g, d).total;
}

// The plan's fields (ops/decode_attention.py `_plan`): cluster ranks
// splitting the C slots (rank r starts at rank_start), ring bulk-copy
// buffers of 128 slots. D a multiple of 16 up to 128, C of 8; every
// tensor 16-byte aligned. dtype: q's and out's, 0 fp32 or 1 bf16.
extern "C" int grove_int8_decode_attention(const void* q, const void* kt,
                                           const void* vt, const void* ks,
                                           const void* vs, const float* bias,
                                           void* out, int b, int h, int hkv,
                                           int c, int d, int cluster,
                                           int ring, float inv_sqrt_d,
                                           int dtype, void* stream) {
  if (d <= 0 || d % 16 != 0 || d > kMaxD || hkv <= 0 || h % hkv != 0 ||
      c <= 0 || c % 8 != 0 || b <= 0 || cluster < 1 ||
      cluster > kMaxCluster || cluster > c / 8 || ring < 1 ||
      ((uintptr_t)q | (uintptr_t)kt | (uintptr_t)vt | (uintptr_t)ks |
       (uintptr_t)vs | (uintptr_t)bias) % 16 ||
      (long long)b * hkv * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q;
  a.kt = static_cast<const int8_t*>(kt);
  a.vt = static_cast<const int8_t*>(vt);
  a.ks = static_cast<const __nv_bfloat16*>(ks);
  a.vs = static_cast<const __nv_bfloat16*>(vs);
  a.bias = bias;
  a.out = out;
  a.h = h;
  a.hkv = hkv;
  a.c = c;
  a.d = d;
  a.cluster = cluster;
  a.ring = ring;
  a.span = 8 * ((c / 8 + cluster - 1) / cluster);
  a.inv_sqrt_d = inv_sqrt_d;
  const size_t bytes = (size_t)layout(ring, a.span, h / hkv, d).total;
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_heads<float>(a, b, bytes, st);
  if (dtype == 1) return launch_heads<__nv_bfloat16>(a, b, bytes, st);
  return (int)cudaErrorInvalidValue;
}
