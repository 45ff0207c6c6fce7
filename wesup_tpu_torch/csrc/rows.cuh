// Streaming of short weighted sums of tap rows, shared by kernels K2
// (csrc/cellpool.cu) and K6 (csrc/adjoint.cu), and the dtype helpers of
// both files.
//
// Both kernels reduce, per output row (b, k), a list of terms (element
// offset of a tap row, f32 weight) that a block has compacted in shared
// memory:  out[b, k, c] = fmaf(w_t, taps[off_t + c], ...) over t in list
// order.  A warp owns 256 channels of one list and a lane 8 consecutive
// channels of each row: one 16-byte load in bf16, two in f32.  Loads are
// issued kDepth terms ahead into registers, then the fmafs run in list
// order, so every channel's f32 sum has the order of the list.
//
// Why registers and not a cp.async / TMA ring in shared memory: a term is
// one 16-byte load per lane (512 B per warp), lists are 9-150 terms long,
// and a block holds up to 8 warps of such lists.  Eight loads in flight per
// lane and 40-64 resident warps per SM already hold more bytes in flight
// than the HBM latency-bandwidth product needs (~15 KB per SM), without the
// barriers and shared-memory stages a ring would add.

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

// The same 8 channels read one element at a time, with any channel stride;
// channels at or past ``nvalid`` read as 0 (the masked tail of C).
template <typename T>
struct ScalarRow {
  float x[kLaneChans];
  __device__ __forceinline__ void load(const T* p, long long cs, int nvalid) {
#pragma unroll
    for (int e = 0; e < kLaneChans; ++e) {
      x[e] = e < nvalid ? to_f32(p[e * cs]) : 0.f;
    }
  }
  __device__ __forceinline__ void fma(float w, float* acc) const {
#pragma unroll
    for (int e = 0; e < kLaneChans; ++e) acc[e] = fmaf(w, x[e], acc[e]);
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

// Block shape shared by both kernels: ``nch`` warps of 256 channels per
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
