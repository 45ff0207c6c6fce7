// General segment sum, kernel K5 of the WESUP port, for Hopper (sm_90a).
// Built by wesup_tpu_torch/ops/_build.py with nvcc into the shared library
// that also holds csrc/cellpool.cu; the wrapper is
// wesup_tpu_torch/ops/pooling.py::segment_sum.
//
// K5  segment_sum  replaces wesup_tpu/ops/pooling_pallas.py::segment_sum_pallas
//                  (Pallas _kernel, pallas_call at :91), batched:
//       out[b, k, c] = sum over pixels p with seg[b, p] == k of feat[b, p, c],
//       f32 sums of (B, P, C) f32 or bf16 features; ids outside [0, K) add
//       nothing.
//
// What bounds it on the H100: bytes.  It reads the (B, P, C) features once
// (245 MB for the 128-channel stage-0 taps at B=8, 288x416, bf16; 1.96 GB
// for the fullres forward's 1024-channel map) and writes a small (B, K, C)
// f32 result, one add per element read.  The TPU kernel built a (K, block)
// one-hot tile per pixel block and ran an MXU dot into a VMEM accumulator
// carried across the sequential grid; a GPU has neither the sequential
// grid nor a reason to multiply by zeros.
//
// Design (simple and deterministic; making it fast is later work):
//   - The wrapper sorts the ids once (stable, so pixel order is kept within
//     a segment) into per-(b, k) pixel lists: order[start[g] .. start[g+1]),
//     g = b * K + k.  Sorting is preparation around the kernel, not its sum.
//   - One block of 256 threads per (segment g, channel tile).  A thread owns
//     V consecutive channels (V = 8 bf16 or 4 f32: one 16-byte load; V = 1
//     when C or the base address does not allow it) and walks every G-th
//     pixel of the list (G = 256 / TX thread groups, TX threads across the
//     tile), so a row of the features is read by TX neighbouring threads in
//     one contiguous segment.
//   - The G partial sums meet in shared memory and are added in group order
//     by group 0, which writes each output element once: no atomics, so two
//     launches agree bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc[0..V) += V consecutive values at p (16-byte aligned when V > 1)
template <typename T, int V>
struct Accum {
  static __device__ __forceinline__ void add(const T* p, float* acc) {
    acc[0] += to_f32(*p);
  }
};

template <>
struct Accum<float, 4> {
  static __device__ __forceinline__ void add(const float* p, float* acc) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
};

template <>
struct Accum<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void add(const __nv_bfloat16* p,
                                             float* acc) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
};

template <typename T, int V>
__global__ void segment_sum_kernel(const int* __restrict__ order,
                                   const int* __restrict__ start,
                                   const T* __restrict__ feat,
                                   float* __restrict__ out, int P, int C,
                                   int K, int TX) {
  __shared__ float part[kThreads * kMaxVec];
  const int g = blockIdx.x;  // b * K + k
  const int b = g / K;
  const int tx = threadIdx.x % TX;
  const int grp = threadIdx.x / TX;
  const int n_grp = blockDim.x / TX;
  const int c0 = (blockIdx.y * TX + tx) * V;
  const bool active = c0 < C;

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (active) {
    const T* fb = feat + static_cast<size_t>(b) * P * C + c0;
    const int j1 = start[g + 1];
    for (int j = start[g] + grp; j < j1; j += n_grp) {
      Accum<T, V>::add(fb + static_cast<size_t>(order[j]) * C, acc);
    }
  }
  if (n_grp > 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) part[threadIdx.x * V + i] = acc[i];
    __syncthreads();
    if (grp != 0) return;
    for (int q = 1; q < n_grp; ++q) {
      const float* src = part + (q * TX + tx) * V;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += src[i];
    }
  }
  if (!active) return;
  float* dst = out + static_cast<size_t>(g) * C + c0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (c0 + i < C) dst[i] = acc[i];
  }
}

template <typename T, int V>
int launch(const int* order, const int* start, const void* feat, float* out,
           int B, int P, int C, int K, cudaStream_t s) {
  const int n_vec = (C + V - 1) / V;
  int tx = 1;
  while (tx < n_vec && tx < kThreads) tx *= 2;
  const dim3 grid(B * K, (n_vec + tx - 1) / tx);
  if (grid.x == 0) return 0;
  segment_sum_kernel<T, V><<<grid, kThreads, 0, s>>>(
      order, start, static_cast<const T*>(feat), out, P, C, K, tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// order (B * P,) int32 and start (B * K + 1,) int32: the per-segment pixel
// lists; feat (B, P, C) in T; out (B, K, C) f32.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int wesup_segment_sum(const void* order, const void* start,
                                 const void* feat, void* out, int B, int P,
                                 int C, int K, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int*>(order);
  const auto* st = static_cast<const int*>(start);
  auto* dst = static_cast<float*>(out);
  const bool aligned = reinterpret_cast<size_t>(feat) % 16 == 0;
  if (dtype == 0) {
    if (aligned && C % 4 == 0) {
      return launch<float, 4>(o, st, feat, dst, B, P, C, K, s);
    }
    return launch<float, 1>(o, st, feat, dst, B, P, C, K, s);
  }
  if (dtype == 1) {
    if (aligned && C % 8 == 0) {
      return launch<__nv_bfloat16, 8>(o, st, feat, dst, B, P, C, K, s);
    }
    return launch<__nv_bfloat16, 1>(o, st, feat, dst, B, P, C, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
