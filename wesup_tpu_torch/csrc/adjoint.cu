// Adjoint superpixel pooling of one downsampled stage, kernel K6 of the
// WESUP port, for Hopper (sm_90a).  Built by wesup_tpu_torch/ops/_build.py
// with nvcc into the shared library that also holds csrc/cellpool.cu; the
// wrapper is wesup_tpu_torch/ops/adjoint.py::adjoint_pool_stage.
//
// K6  adjoint_pool_stage  replaces wesup_tpu/ops/adjoint_pallas.py::
//                         adjoint_pool_stage (Pallas _kernel, pallas_call
//                         at :102):
//       out[b, k, c] = sum_h sum_v T(p_h[v, k]) * tapsH_T[b, c, h, v],
//       p_h[v, k]    = sum over w with seg[b, h, w] == k of A_wT[v, w],
// f32 sums, T = the taps' dtype (p_h rounded to it, as the TPU kernel
// rounds its first product before the second; A_wT arrives rounded to T).
// Pixels with seg < 0 add nothing.
//
// What bounds it on the H100: bytes.  tapsH_T is the biggest input (245 MB
// for stage 1 at B=8, 288x416, bf16; about 1.17 GB over the four stages)
// and each of its elements meets one or two clusters.  A_wT has at most two
// nonzeros per column (linear interpolation), so the work is a few
// operations per byte.  The TPU kernel built each row's (W, K) one-hot in
// VMEM and ran two dense MXU products per row (about 6.7e11 operations over
// the four stages at the main-path shape), nearly all on zeros.
//
// Design (simple and deterministic; making it fast is later work):
//   - The wrapper gives the per-(b, k) pixel lists of ops/pooling.py (one
//     stable sort of seg, so each list is in pixel order: row by row, w
//     ascending) and a per-column table of A_wT: the first nonzero row
//     v0[w] (non-decreasing in w) and the weights a0[w], a1[w] of rows
//     v0[w] and v0[w] + 1.
//   - One block of 128 threads per (b, k, tile of 512 channels); a thread
//     owns 4 channels, 128 apart, so each load of a warp is 32 neighbouring
//     channels when tapsH_T is a channels-last view (its strides are
//     arguments; the forward passes such a view).
//   - The block walks k's list once.  Within a row h, pixels arrive with
//     non-decreasing v0, and pixel w adds a0[w] to p_h[v0] and a1[w] to
//     p_h[v0 + 1]; so two running sums (rows cur and cur + 1) hold all of
//     p_h that is still open.  When v0 moves on or the row ends, the
//     finished p_h[v] is rounded to T and its products with the taps of
//     (h, v) are added to the f32 accumulators.  Each p_h[v] is the same f32
//     sum of the same weights the TPU kernel forms (in another order), and
//     only its nonzeros are visited.
//   - Every output element is written once: no atomics, so two launches
//     agree bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kChanPerThread = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// p rounded to the taps' dtype, as the TPU kernel casts p_h
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
struct Block {
  const T* taps;    // tapsH_T[b] at channel 0
  long long sc, sh, sv;
  int Ws;
  long long coff[kChanPerThread];  // c * sc of this thread's channels
  bool ok[kChanPerThread];
  float acc[kChanPerThread];

  // acc += T(p) * tapsH_T[b, c, h, v] for the thread's channels
  __device__ __forceinline__ void flush(int h, int v, float p) {
    if (p == 0.f || v >= Ws) return;
    const float pr = round_to(p, taps);
    const T* row = taps + h * sh + v * sv;
#pragma unroll
    for (int j = 0; j < kChanPerThread; ++j) {
      if (ok[j]) acc[j] = fmaf(pr, to_f32(row[coff[j]]), acc[j]);
    }
  }
};

template <typename T>
__global__ void adjoint_pool_kernel(
    const int* __restrict__ order, const int* __restrict__ start,
    const T* __restrict__ taps, long long sb, long long sc, long long sh,
    long long sv, const int* __restrict__ v0, const float* __restrict__ a0,
    const float* __restrict__ a1, float* __restrict__ out, int W, int Ws,
    int C, int K) {
  const int g = blockIdx.x;  // b * K + k
  const int b = g / K;
  const int c_base = blockIdx.y * kThreads * kChanPerThread + threadIdx.x;

  Block<T> blk;
  blk.taps = taps + b * sb;
  blk.sc = sc;
  blk.sh = sh;
  blk.sv = sv;
  blk.Ws = Ws;
#pragma unroll
  for (int j = 0; j < kChanPerThread; ++j) {
    const int c = c_base + j * kThreads;
    blk.ok[j] = c < C;
    blk.coff[j] = static_cast<long long>(c) * sc;
    blk.acc[j] = 0.f;
  }

  int cur_h = -1, cur_v = -1;
  float pa = 0.f, pb = 0.f;  // open sums of p_h[cur_v], p_h[cur_v + 1]
  const int j1 = start[g + 1];
  for (int j = start[g]; j < j1; ++j) {
    const int pix = order[j];
    const int h = pix / W;
    const int w = pix - h * W;
    const int v = v0[w];
    if (h != cur_h || v != cur_v) {
      if (cur_v >= 0) {
        if (h == cur_h && v == cur_v + 1) {
          blk.flush(cur_h, cur_v, pa);
          pa = pb;
          pb = 0.f;
        } else {
          blk.flush(cur_h, cur_v, pa);
          blk.flush(cur_h, cur_v + 1, pb);
          pa = 0.f;
          pb = 0.f;
        }
      }
      cur_h = h;
      cur_v = v;
    }
    pa += a0[w];
    pb += a1[w];
  }
  if (cur_v >= 0) {
    blk.flush(cur_h, cur_v, pa);
    blk.flush(cur_h, cur_v + 1, pb);
  }

  float* dst = out + static_cast<size_t>(g) * C;
#pragma unroll
  for (int j = 0; j < kChanPerThread; ++j) {
    if (blk.ok[j]) dst[c_base + j * kThreads] = blk.acc[j];
  }
}

template <typename T>
int launch(const int* order, const int* start, const void* taps,
           long long sb, long long sc, long long sh, long long sv,
           const int* v0, const float* a0, const float* a1, float* out,
           int B, int W, int Ws, int C, int K, cudaStream_t s) {
  const int per_block = kThreads * kChanPerThread;
  const dim3 grid(B * K, (C + per_block - 1) / per_block);
  if (grid.x == 0 || grid.y == 0) return 0;
  adjoint_pool_kernel<T><<<grid, kThreads, 0, s>>>(
      order, start, static_cast<const T*>(taps), sb, sc, sh, sv, v0, a0, a1,
      out, W, Ws, C, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// order / start: the per-segment pixel lists of seg (B, H, W); taps: the
// (B, C, H, Ws) tapsH_T with element strides sb, sc, sh, sv; v0 / a0 / a1:
// the (W,) column table of A_wT; out: (B, K, C) f32.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int wesup_adjoint_pool_stage(
    const void* order, const void* start, const void* taps, long long sb,
    long long sc, long long sh, long long sv, const void* v0, const void* a0,
    const void* a1, void* out, int B, int W, int Ws, int C, int K,
    int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int*>(order);
  const auto* st = static_cast<const int*>(start);
  const auto* col = static_cast<const int*>(v0);
  const auto* w0 = static_cast<const float*>(a0);
  const auto* w1 = static_cast<const float*>(a1);
  auto* dst = static_cast<float*>(out);
  if (dtype == 0) {
    return launch<float>(o, st, taps, sb, sc, sh, sv, col, w0, w1, dst, B, W,
                         Ws, C, K, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(o, st, taps, sb, sc, sh, sv, col, w0, w1,
                                 dst, B, W, Ws, C, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
