// Shared bodies of the hand-written attention backward kernels (K4b, K9).
//
// The flash backward (Dao et al.) with the log-sum-exp of the forward:
//
//   p_ij  = exp(s_ij - lse_i),   s_ij = scale * q_i . k_j [+ bias_ij]
//   D_i   = rowsum(dO_i * O_i)            (torch ops, in the wrapper)
//   ds_ij = p_ij * (dO_i . v_j - D_i)
//   dq_i  = scale * sum_j ds_ij k_j       (dq body)
//   dk_j  = scale * sum_i ds_ij q_i,  dv_j = sum_i p_ij dO_i   (dkv body)
//
// Two contracts per body: causal with no bias (K4b, the LLaMA backward),
// and non-causal with the decomposed rel-pos bias of K1/K2
// (bias_ij = rel_h[i, j / gw] + rel_w[i, j % gw], rebuilt per (row, key)
// from the term tables staged in shared memory, K9). With the bias the dq
// body also returns the per-row term gradients
//
//   d_rh[i, a] = sum_{j: j / gw == a} ds_ij,   d_rw[i, b] = sum_{j % gw == b} ds_ij
//
// as exact sums in registers: lane L of the warp that owns row i keeps the
// buckets L and L + 32 of [rel_h | rel_w] (gh + gw <= 64) and adds each key's
// ds, broadcast by shuffle, in key order. Nothing is summed across blocks,
// so neither body uses atomics and both are deterministic.
//
// Tiling, as attention_core.cuh: a block of kWarps warps, kRows rows a warp.
//   dq:  the block owns kBQ query rows of one (batch, head) and streams the
//        keys in tiles of kBK = 32, one key per lane for the two dot products
//        (q.k and dO.v), then the output columns split over the lanes for
//        dq += ds * k, with ds broadcast by shuffle;
//   dkv: the block owns kBQ key rows and streams the queries in tiles of 32,
//        one query per lane for the dot products, then dk += ds * q and
//        dv += p * dO with the columns split over the lanes.
// A causal dq block stops at the key tile of its last row; a causal dkv
// block starts at the query tile of its first key.
//
// Numerics: every product and sum in fp32 from the input values, whatever
// the input type. The TPU K9 rounds p and ds to the input dtype before its
// dots (grove_tpu/ops/sam_attention_bwd.py:132, :186, :191) and K4b keeps
// them in fp32; this body keeps fp32 for both (a known rounding-point
// difference in bf16, none in fp32).
//
// Bound on an H100: fp32 FMA issue and shared-memory reads on the CUDA
// cores, as the forward body. K9's dkv in bf16 at head dims 64, 80 and 128
// runs the tensor-core backward body instead (attention_bwd_tc.cuh, with
// the TPU kernel's rounding points); this body keeps K9's dkv in fp32 and
// at D 8, K9's dq and K4b at every dtype, which come to the tensor-core
// body next.

#pragma once

#include "attention_core.cuh"

namespace grove {

constexpr int kMaxRel = 64;     // gh + gw: two buckets per lane

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, H, S) natural log, from the forward
  const float* dcap;    // (B, H, S) rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  const void* rh;       // rel_h terms (B, H, S, gh), or nullptr
  const void* rw;       // rel_w terms (B, H, S, gw)
  float* drh;           // (B, H, S, gh) fp32 out (dq body, with the bias)
  float* drw;           // (B, H, S, gw)
  Strides xs;           // q, k, v, dout, dq, dk, dv: (B, S, H, D)
  Strides rhs, rws;
  int B, H, S, gh, gw;
  float scale;
  int causal;
};

// Shared-memory floats of each body.
template <int D>
__host__ __device__ constexpr int dq_smem_fixed() {
  return 2 * kBQ * D + 2 * kBK * (D + 4);
}
template <int D>
__host__ __device__ constexpr int dkv_smem_fixed() {
  return 2 * kBQ * D + 2 * kBK * (D + 4) + 2 * kBK;
}
// Row stride of the staged term tables: odd, so lanes reading one column of
// 32 rows hit 32 banks.
__host__ __device__ inline int rel_stride(int gs) { return gs | 1; }

template <typename T>
__device__ __forceinline__ void stage_rel(float* sR, const BwdArgs& a,
                                          int b, int h, int row0, int tid) {
  const int gs = a.gh + a.gw;
  const int st = rel_stride(gs);
  const T* rh = static_cast<const T*>(a.rh) + b * a.rhs.b + h * a.rhs.h;
  const T* rw = static_cast<const T*>(a.rw) + b * a.rws.b + h * a.rws.h;
  for (int i = tid; i < kBK * gs; i += kThreads) {
    const int r = i / gs;
    const int c = i - r * gs;
    const int row = row0 + r;
    float x = 0.f;
    if (row < a.S)
      x = c < a.gh ? to_f(rh[row * a.rhs.s + c])
                   : to_f(rw[row * a.rws.s + (c - a.gh)]);
    sR[r * st + c] = x * kLog2e;
  }
}

template <typename T, int D>
__device__ __forceinline__ void dq_block(const BwdArgs& a) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static_assert(kBQ == kBK, "the bodies stage rows and keys alike");
  constexpr int NC = (D + 31) / 32;
  constexpr int KST = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // [kBQ][D]
  float* sG = sQ + kBQ * D;               // [kBQ][D]   dO rows
  float* sK = sG + kBQ * D;               // [kBK][KST]
  float* sV = sK + kBK * KST;             // [kBK][KST]
  float* sR = sV + kBK * KST;             // [kBQ][rel_stride] (log2 units)

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool bias = a.rh != nullptr;
  const int rst = rel_stride(a.gh + a.gw);

  const long long xb = b * a.xs.b + h * a.xs.h;
  const T* q = static_cast<const T*>(a.q) + xb;
  const T* k = static_cast<const T*>(a.k) + xb;
  const T* v = static_cast<const T*>(a.v) + xb;
  const T* g = static_cast<const T*>(a.dout) + xb;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    const bool ok = row < a.S;
    sQ[i] = ok ? to_f(q[row * a.xs.s + d]) : 0.f;
    sG[i] = ok ? to_f(g[row * a.xs.s + d]) : 0.f;
  }
  if (bias) stage_rel<T>(sR, a, b, h, q0, tid);

  const int wrow = warp * kRows;
  const long long sb = ((long long)b * a.H + h) * a.S;
  float lse2[kRows], dc[kRows], acc[kRows][NC], drel[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + wrow + r;
    lse2[r] = row < a.S ? a.lse[sb + row] * kLog2e : 0.f;
    dc[r] = row < a.S ? a.dcap[sb + row] : 0.f;
    drel[r][0] = drel[r][1] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const float qk2 = a.scale * kLog2e;
  const int kend = a.causal ? min(a.S, q0 + kBQ) : a.S;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                      // previous tile consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int key = k0 + j;
      const bool ok = key < a.S;
      sK[j * KST + d] = ok ? to_f(k[key * a.xs.s + d]) : 0.f;
      sV[j * KST + d] = ok ? to_f(v[key * a.xs.s + d]) : 0.f;
    }
    __syncthreads();

    // lane = key: s = q.k and dp = dO.v for each of the warp's rows
    const int key = k0 + lane;
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* kr = sK + lane * KST;
    const float* vr = sV + lane * KST;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kd = *reinterpret_cast<const float4*>(kr + d);
      const float4 vd = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qd =
            *reinterpret_cast<const float4*>(sQ + (wrow + r) * D + d);
        const float4 gd =
            *reinterpret_cast<const float4*>(sG + (wrow + r) * D + d);
        s[r] = fmaf(qd.x, kd.x, s[r]);
        s[r] = fmaf(qd.y, kd.y, s[r]);
        s[r] = fmaf(qd.z, kd.z, s[r]);
        s[r] = fmaf(qd.w, kd.w, s[r]);
        dp[r] = fmaf(gd.x, vd.x, dp[r]);
        dp[r] = fmaf(gd.y, vd.y, dp[r]);
        dp[r] = fmaf(gd.z, vd.z, dp[r]);
        dp[r] = fmaf(gd.w, vd.w, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + wrow + r;
      const bool valid = key < a.S && row < a.S && (!a.causal || key <= row);
      float x = s[r] * qk2;
      if (bias && valid) {
        const float* rr = sR + (wrow + r) * rst;
        x += rr[key / a.gw] + rr[a.gh + key % a.gw];
      }
      const float p = valid ? exp2f(x - lse2[r]) : 0.f;
      s[r] = p * (dp[r] - dc[r]);         // ds
    }

    // dq += ds * k (columns over lanes); the term gradients by bucket
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float kj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        kj[c] = d < D ? sK[j * KST + d] : 0.f;
      }
      const int kk = k0 + j;
      const int hb = bias ? kk / a.gw : -1;            // rel_h bucket
      const int wb = bias ? a.gh + kk % a.gw : -1;     // rel_w bucket
      const bool m0 = lane == hb || lane == wb;
      const bool m1 = lane + 32 == hb || lane + 32 == wb;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(dsj, kj[c], acc[r][c]);
        drel[r][0] += m0 ? dsj : 0.f;
        drel[r][1] += m1 ? dsj : 0.f;
      }
    }
  }

  T* dq = static_cast<T*>(a.dq) + xb;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + wrow + r;
    if (row >= a.S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[row * a.xs.s + d] = from_f<T>(acc[r][c] * a.scale);
    }
    if (bias) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        if (c < a.gh)
          a.drh[(sb + row) * a.gh + c] = drel[r][t];
        else if (c < a.gh + a.gw)
          a.drw[(sb + row) * a.gw + (c - a.gh)] = drel[r][t];
      }
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void dkv_block(const BwdArgs& a) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  constexpr int NC = (D + 31) / 32;
  constexpr int KST = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                       // [kBQ][D]   this block's keys
  float* sV = sK + kBQ * D;               // [kBQ][D]
  float* sQ = sV + kBQ * D;               // [kBK][KST] query tile
  float* sG = sQ + kBK * KST;             // [kBK][KST] its dO rows
  float* sL = sG + kBK * KST;             // [kBK] lse (log2 units)
  float* sD = sL + kBK;                   // [kBK] D
  float* sR = sD + kBK;                   // [kBK][rel_stride] (log2 units)

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int j0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool bias = a.rh != nullptr;
  const int rst = rel_stride(a.gh + a.gw);

  const long long xb = b * a.xs.b + h * a.xs.h;
  const T* q = static_cast<const T*>(a.q) + xb;
  const T* k = static_cast<const T*>(a.k) + xb;
  const T* v = static_cast<const T*>(a.v) + xb;
  const T* g = static_cast<const T*>(a.dout) + xb;
  const long long sb = ((long long)b * a.H + h) * a.S;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int key = j0 + r;
    const bool ok = key < a.S;
    sK[i] = ok ? to_f(k[key * a.xs.s + d]) : 0.f;
    sV[i] = ok ? to_f(v[key * a.xs.s + d]) : 0.f;
  }

  const int wrow = warp * kRows;
  int kh[kRows], kw[kRows];
  float dk[kRows][NC], dv[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = j0 + wrow + r;
    kh[r] = bias ? key / a.gw : 0;
    kw[r] = bias ? a.gh + key % a.gw : 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;
  }

  const float qk2 = a.scale * kLog2e;
  const int qstart = a.causal ? (j0 / kBK) * kBK : 0;
  for (int q0 = qstart; q0 < a.S; q0 += kBK) {
    __syncthreads();                      // previous tile consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int row = q0 + r;
      const bool ok = row < a.S;
      sQ[r * KST + d] = ok ? to_f(q[row * a.xs.s + d]) : 0.f;
      sG[r * KST + d] = ok ? to_f(g[row * a.xs.s + d]) : 0.f;
    }
    if (tid < kBK) {
      const int row = q0 + tid;
      sL[tid] = row < a.S ? a.lse[sb + row] * kLog2e : 0.f;
      sD[tid] = row < a.S ? a.dcap[sb + row] : 0.f;
    }
    if (bias) stage_rel<T>(sR, a, b, h, q0, tid);
    __syncthreads();

    // lane = query row: s = q.k and dp = dO.v for each of the warp's keys
    const int row = q0 + lane;
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* qr = sQ + lane * KST;
    const float* gr = sG + lane * KST;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qd = *reinterpret_cast<const float4*>(qr + d);
      const float4 gd = *reinterpret_cast<const float4*>(gr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 kd =
            *reinterpret_cast<const float4*>(sK + (wrow + r) * D + d);
        const float4 vd =
            *reinterpret_cast<const float4*>(sV + (wrow + r) * D + d);
        s[r] = fmaf(qd.x, kd.x, s[r]);
        s[r] = fmaf(qd.y, kd.y, s[r]);
        s[r] = fmaf(qd.z, kd.z, s[r]);
        s[r] = fmaf(qd.w, kd.w, s[r]);
        dp[r] = fmaf(gd.x, vd.x, dp[r]);
        dp[r] = fmaf(gd.y, vd.y, dp[r]);
        dp[r] = fmaf(gd.z, vd.z, dp[r]);
        dp[r] = fmaf(gd.w, vd.w, dp[r]);
      }
    }
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int key = j0 + wrow + r;
      const bool valid = key < a.S && row < a.S && (!a.causal || key <= row);
      float x = s[r] * qk2;
      if (bias && valid) {
        const float* rr = sR + lane * rst;
        x += rr[kh[r]] + rr[kw[r]];
      }
      p[r] = valid ? exp2f(x - sL[lane]) : 0.f;
      s[r] = p[r] * (dp[r] - sD[lane]);   // ds
    }

    // dv += p * dO, dk += ds * q (columns over lanes)
#pragma unroll 4
    for (int i = 0; i < kBK; ++i) {
      float qi[NC], gi[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        qi[c] = d < D ? sQ[i * KST + d] : 0.f;
        gi[c] = d < D ? sG[i * KST + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pi = __shfl_sync(0xffffffffu, p[r], i);
        const float dsi = __shfl_sync(0xffffffffu, s[r], i);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[r][c] = fmaf(pi, gi[c], dv[r][c]);
          dk[r][c] = fmaf(dsi, qi[c], dk[r][c]);
        }
      }
    }
  }

  T* dko = static_cast<T*>(a.dk) + xb;
  T* dvo = static_cast<T*>(a.dv) + xb;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = j0 + wrow + r;
    if (key >= a.S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d >= D) continue;
      dko[key * a.xs.s + d] = from_f<T>(dk[r][c] * a.scale);
      dvo[key * a.xs.s + d] = from_f<T>(dv[r][c]);
    }
  }
}

// Launch one backward instantiation: the grid covers S in blocks of kBQ
// rows (dq) or keys (dkv) for every (batch, head).
template <typename Kernel>
inline int bwd_launch(Kernel kernel, const BwdArgs& a, int fixed_floats,
                      int rel_rows, cudaStream_t stream) {
  const int rel = a.rh != nullptr ? rel_rows * rel_stride(a.gh + a.gw) : 0;
  const size_t bytes = sizeof(float) * (size_t)(fixed_floats + rel);
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

// The __global__ instantiations of one backward entry for every head dim of
// HEAD_DIMS and a host dispatcher `NAME_dispatch` over (dtype, head_dim);
// BODY is dq or dkv. dtype: 0 = float32, 1 = bfloat16.
#define GROVE_BWD_CASE(NAME, BODY, D)                                         \
  case D:                                                                     \
    return grove::bwd_launch(NAME##_kernel<T, D>, a,                          \
                             grove::BODY##_smem_fixed<D>(), grove::kBQ, st);
#define GROVE_BWD_ENTRY(NAME, BODY)                                           \
  template <typename T, int D>                                                \
  __global__ void __launch_bounds__(grove::kThreads)                          \
      NAME##_kernel(const grove::BwdArgs a) {                                 \
    grove::BODY##_block<T, D>(a);                                             \
  }                                                                           \
  template <typename T>                                                       \
  static int NAME##_by_dim(const grove::BwdArgs& a, int d,                    \
                           cudaStream_t st) {                                 \
    switch (d) {                                                              \
      GROVE_BWD_CASE(NAME, BODY, 8)                                           \
      GROVE_BWD_CASE(NAME, BODY, 64)                                          \
      GROVE_BWD_CASE(NAME, BODY, 80)                                          \
      GROVE_BWD_CASE(NAME, BODY, 128)                                         \
      default:                                                                \
        return (int)cudaErrorInvalidValue;                                    \
    }                                                                         \
  }                                                                           \
  static int NAME##_dispatch(const grove::BwdArgs& a, int dtype, int d,       \
                             cudaStream_t st) {                               \
    if (dtype == 0) return NAME##_by_dim<float>(a, d, st);                    \
    if (dtype == 1) return NAME##_by_dim<__nv_bfloat16>(a, d, st);            \
    return (int)cudaErrorInvalidValue;                                        \
  }
