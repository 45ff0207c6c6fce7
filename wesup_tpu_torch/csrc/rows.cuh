// Streaming of short (weighted) sums of rows, shared by kernels K1, K2, K4
// (csrc/cellpool.cu) and K6, K8 (csrc/adjoint.cu), and the dtype helpers of
// those files.
//
// Each kernel reduces, per output row, a list of terms (a row of its input,
// and for K2, K4, K6 and K8 an f32 weight) that a block has compacted in
// shared memory:  out[c] = fmaf(w_t, rows[off_t + c], ...) over t in list
// order (K1: out[c] += rows[off_t + c]).  Two lane maps:
//   - 8 channels per lane, 256 per warp (K2, K4, K6, K8): one 16-byte load
//     per row in bf16, two in f32 (VecRow, ScalarRow);
//   - 4 channels per lane, 128 per warp (K1, whose rows are 128 channels
//     on the main path): one 8-byte load in bf16, one 16-byte load in f32
//     (VecRow4, ScalarRow<T, 4>).  A full warp per list keeps every lane
//     busy where the 8-channel map would idle half of them, and needs no
//     second list per warp of another length.
// Loads are issued kDepth terms ahead into registers, then the adds run in
// list order, so every channel's f32 sum has the order of the list.
// stream_terms (K2, K6) takes the terms after its last full batch one at a
// time; stream_list (K1, K4, K8) issues that last batch whole with the rows
// past the end masked off, so a list shorter than kDepth (K4's lists hold
// 2-11 terms, K8's 1.5-4.1 on average) still has all its loads in
// flight.
//
// Why registers and not a cp.async / TMA ring in shared memory: a term is
// one 8- or 16-byte load per lane (256-512 B per warp), lists are 2-270
// terms long, and a block holds up to 8 warps of such lists.  Four to 16
// loads in flight per lane and 24-64 resident warps per SM already hold
// more bytes in flight than the HBM latency-bandwidth product needs (~15 KB
// per SM), without the barriers and shared-memory stages a ring would add.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace wesup_rows {

constexpr int kLaneChans = 8;                 // channels per lane
constexpr int kWarpChans = 32 * kLaneChans;   // channels per warp
constexpr int kMaxWarps = 8;                  // warps per block, at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to the dtype T that the pointer names, returned as f32
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 consecutive channels of one row, loaded 16 bytes at a time (needs a
// 16-byte aligned address and a channel stride of 1).
template <typename T>
struct VecRow;

template <>
struct VecRow<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p, long long, int) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void fma(float w, float* acc) const {
    acc[0] = fmaf(w, lo.x, acc[0]);
    acc[1] = fmaf(w, lo.y, acc[1]);
    acc[2] = fmaf(w, lo.z, acc[2]);
    acc[3] = fmaf(w, lo.w, acc[3]);
    acc[4] = fmaf(w, hi.x, acc[4]);
    acc[5] = fmaf(w, hi.y, acc[5]);
    acc[6] = fmaf(w, hi.z, acc[6]);
    acc[7] = fmaf(w, hi.w, acc[7]);
  }
};

template <>
struct VecRow<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, long long,
                                       int) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void fma(float w, float* acc) const {
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      acc[2 * k] = fmaf(w, f.x, acc[2 * k]);
      acc[2 * k + 1] = fmaf(w, f.y, acc[2 * k + 1]);
    }
  }
};

// 4 consecutive channels of one row (K1's lane map): one 16-byte load in
// f32, one 8-byte load in bf16 (needs an address aligned to that size).
template <typename T>
struct VecRow4;

template <>
struct VecRow4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p, long long, int) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void add(float* acc) const {
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
};

template <>
struct VecRow4<__nv_bfloat16> {
  uint2 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, long long,
                                       int) {
    u = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void add(float* acc) const {
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    acc[0] += a.x;
    acc[1] += a.y;
    acc[2] += b.x;
    acc[3] += b.y;
  }
};

// The same N channels (8 by default) read one element at a time, with any
// channel stride; channels at or past ``nvalid`` read as 0 (the masked tail
// of C).
template <typename T, int N = kLaneChans>
struct ScalarRow {
  float x[N];
  __device__ __forceinline__ void load(const T* p, long long cs, int nvalid) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      x[e] = e < nvalid ? to_f32(p[e * cs]) : 0.f;
    }
  }
  __device__ __forceinline__ void fma(float w, float* acc) const {
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = fmaf(w, x[e], acc[e]);
  }
  __device__ __forceinline__ void add(float* acc) const {
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] += x[e];
  }
};

// acc[e] = fmaf(w[t], rows[off[t] + e * cs], acc[e]) for t = 0 .. n-1 in
// order; ``base`` points at the lane's first channel.
template <typename T, bool VEC>
__device__ __forceinline__ void stream_terms(const T* base, long long cs,
                                             const long long* off,
                                             const float* w, int n,
                                             int nvalid, float* acc) {
  using Row = typename std::conditional<VEC, VecRow<T>, ScalarRow<T>>::type;
  // 128 bytes per lane in flight in either dtype
  constexpr int kDepth = sizeof(T) == 2 ? 8 : 4;
  int t = 0;
  for (; t + kDepth <= n; t += kDepth) {
    Row r[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) r[d].load(base + off[t + d], cs, nvalid);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) r[d].fma(w[t + d], acc);
  }
  for (; t < n; ++t) {
    Row r;
    r.load(base + off[t], cs, nvalid);
    r.fma(w[t], acc);
  }
}

// The same sums over rows named by an index list: row t starts at
// base + idx[t] * stride, its channels ``cs`` apart (1 but for K8's scalar
// form).  Weighted (K4, K8): acc = fmaf(w[t], row, acc); unweighted (K1):
// acc += row.  Batches of kDepth loads, then the adds in list order; the
// last batch is issued whole, its rows past n masked off (n is uniform
// across the warp, so the masks do not diverge).
template <typename Row, int kDepth, bool WEIGHTED, typename T>
__device__ __forceinline__ void stream_list(const T* base, const int* idx,
                                            long long stride, const float* w,
                                            int n, int nvalid, float* acc,
                                            long long cs = 1) {
  for (int t = 0; t < n; t += kDepth) {
    Row r[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (t + d < n) r[d].load(base + idx[t + d] * stride, cs, nvalid);
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (t + d < n) {
        if constexpr (WEIGHTED) {
          r[d].fma(w[t + d], acc);
        } else {
          r[d].add(acc);
        }
      }
    }
  }
}

// the lane's 8 sums, written once (two 16-byte stores when VEC)
template <bool VEC>
__device__ __forceinline__ void store_sums(float* dst, const float* acc,
                                           int nvalid) {
  if (VEC) {
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(dst)[1] =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int e = 0; e < kLaneChans; ++e) {
      if (e < nvalid) dst[e] = acc[e];
    }
  }
}

// K1's 4 sums, written once (one 16-byte store when VEC)
template <bool VEC>
__device__ __forceinline__ void store_sums4(float* dst, const float* acc,
                                            int nvalid) {
  if (VEC) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < nvalid) dst[e] = acc[e];
    }
  }
}

// the lane's 8 sums rounded to T and written once (K4, and K8's scalar
// form): one 16-byte store in bf16, two in f32 when VEC
template <bool VEC>
__device__ __forceinline__ void store_rounded(float* dst, const float* acc,
                                              int nvalid) {
  store_sums<VEC>(dst, acc, nvalid);
}

template <bool VEC>
__device__ __forceinline__ void store_rounded(__nv_bfloat16* dst,
                                              const float* acc, int nvalid) {
  if (VEC) {
    uint4 u;
    auto* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
    }
    *reinterpret_cast<uint4*>(dst) = u;
  } else {
#pragma unroll
    for (int e = 0; e < kLaneChans; ++e) {
      if (e < nvalid) dst[e] = __float2bfloat16_rn(acc[e]);
    }
  }
}

// Block shape shared by K2, K4, K6 and K8: ``nch`` warps of 256 channels per
// list (at most 8; more channels go to grid.y) and ``ncl`` lists per block,
// so that ncl * nch <= 8 warps stream at once and no warp idles:
// C = 256 -> 8 lists x 1 warp; 768 -> 2 x 3; 1536 -> 1 x 6.
struct Shape {
  int nch_total, nch, ncl;
};

inline Shape block_shape(int C) {
  Shape s;
  s.nch_total = (C + kWarpChans - 1) / kWarpChans;
  s.nch = s.nch_total < kMaxWarps ? s.nch_total : kMaxWarps;
  if (s.nch < 1) s.nch = 1;
  s.ncl = kMaxWarps / s.nch;
  return s;
}

}  // namespace wesup_rows
