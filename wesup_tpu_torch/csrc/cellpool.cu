// Superpixel pooling kernels K1 and K2 of the WESUP forward, for Hopper
// (sm_90a).  Built by wesup_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes; the wrappers are in
// wesup_tpu_torch/ops/cellpool.py.
//
// K1  cell_pool0      replaces wesup_tpu/ops/cellpool_pallas.py::cell_pool0
//                     (Pallas _kernel via _pool0_impl):
//       sums[b, k, c] = sum over pixels (h, w) with seg[b, h, w] == k of
//                       taps[b, h, w, c]; pixels with seg < 0 add nothing.
// K2  cell_pool_stage replaces cellpool_pallas.py::cell_pool_stage
//                     (Pallas _stage_kernel via _stage_fwd_impl):
//       sums[b, k, c] = sum_{p, q} M[b, p, q, k] * taps[b, p, q, c], with M
//       given by its compact window weights mc (B, Hs, Ih, Ws, Jw): entry
//       (p, i, q, j) is the mass stage pixel (p, q) sends to cluster
//       (ay[p] + i + rmin_y, ax[q] + j + rmin_x).
//
// What bounds them on the H100: bytes.  Each reads a (B, H, W, C) tap tensor
// once (245 MB for stage 0 at B=8, 288x416, bf16) and writes a small
// (B, K, C) f32 result; the arithmetic is a few operations per byte, far
// below the ~295 operations per byte where the tensor cores become the
// limit.  The TPU kernels built one-hot / banded weight tiles and ran one
// MXU dot per 8-row block, then added overlapping window partials through a
// 0/1 placement einsum.  None of that is needed here.
//
// Design (simple and deterministic; making it fast is later work):
//   - SLIC's cell structure bounds which pixels can reach cluster
//     k = ky * Kw + kx: for K1 the pixels whose cell lies within +-1 of
//     (ky, kx); for K2 the stage rows p whose window [ay[p] + rmin_y,
//     ay[p] + rmin_y + Ih) holds ky, and the same along x.  Both are
//     contiguous ranges (cells and anchors are monotone) that the host
//     tabulates once per plan: lo[ky] .. hi[ky] and lo[kx] .. hi[kx].
//   - One thread block per (channel chunk of 32, cluster row ky, 8 cluster
//     columns, image b); one thread per (kx, c).  A warp is one cluster and
//     32 neighbouring channels, so its reads of taps are one contiguous
//     segment and its reads of seg / mc are broadcasts, and the branch on
//     "does this pixel belong to k" / "is this weight nonzero" is uniform
//     across the warp: a tap row is read from memory only by the warp that
//     uses it.
//   - Each thread walks its window in a fixed order, accumulates in f32 and
//     writes its output element exactly once: no atomics, so runs are
//     bitwise repeatable.
//   - taps may be f32 or bf16 (mc has taps' dtype); products of two bf16
//     values are exact in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChanPerWarp = 32;   // threadIdx.x: channel within the chunk
constexpr int kClustPerBlock = 8;  // threadIdx.y: cluster column in block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void cell_pool0_kernel(const int* __restrict__ seg,
                                  const T* __restrict__ taps,
                                  float* __restrict__ out,
                                  const int* __restrict__ row_lo,
                                  const int* __restrict__ row_hi,
                                  const int* __restrict__ col_lo,
                                  const int* __restrict__ col_hi, int H, int W,
                                  int C, int Kh, int Kw) {
  const int n_kxb = (Kw + kClustPerBlock - 1) / kClustPerBlock;
  const int ky = blockIdx.y / n_kxb;
  const int kx = (blockIdx.y % n_kxb) * kClustPerBlock + threadIdx.y;
  const int c = blockIdx.x * kChanPerWarp + threadIdx.x;
  const int b = blockIdx.z;
  if (kx >= Kw || c >= C) return;

  const int k = ky * Kw + kx;
  const int* seg_b = seg + static_cast<size_t>(b) * H * W;
  const T* taps_b = taps + static_cast<size_t>(b) * H * W * C + c;
  const int h0 = row_lo[ky], h1 = row_hi[ky];
  const int w0 = col_lo[kx], w1 = col_hi[kx];
  float acc = 0.f;
  for (int h = h0; h < h1; ++h) {
    const int* seg_row = seg_b + static_cast<size_t>(h) * W;
    for (int w = w0; w < w1; ++w) {
      if (seg_row[w] == k) {
        acc += to_f32(taps_b[(static_cast<size_t>(h) * W + w) * C]);
      }
    }
  }
  out[(static_cast<size_t>(b) * Kh * Kw + k) * C + c] = acc;
}

template <typename T>
__global__ void cell_pool_stage_kernel(
    const T* __restrict__ mc, const T* __restrict__ taps,
    float* __restrict__ out, const int* __restrict__ ay,
    const int* __restrict__ ax, const int* __restrict__ p_lo,
    const int* __restrict__ p_hi, const int* __restrict__ q_lo,
    const int* __restrict__ q_hi, int Hs, int Ws, int C, int Ih, int Jw,
    int Kh, int Kw, int rmin_y, int rmin_x) {
  const int n_kxb = (Kw + kClustPerBlock - 1) / kClustPerBlock;
  const int ky = blockIdx.y / n_kxb;
  const int kx = (blockIdx.y % n_kxb) * kClustPerBlock + threadIdx.y;
  const int c = blockIdx.x * kChanPerWarp + threadIdx.x;
  const int b = blockIdx.z;
  if (kx >= Kw || c >= C) return;

  const int k = ky * Kw + kx;
  const T* mc_b = mc + static_cast<size_t>(b) * Hs * Ih * Ws * Jw;
  const T* taps_b = taps + static_cast<size_t>(b) * Hs * Ws * C + c;
  const int p0 = p_lo[ky], p1 = p_hi[ky];
  const int q0 = q_lo[kx], q1 = q_hi[kx];
  float acc = 0.f;
  for (int p = p0; p < p1; ++p) {
    const int i = ky - ay[p] - rmin_y;  // in [0, Ih) by the host's tables
    const T* mc_row = mc_b + (static_cast<size_t>(p) * Ih + i) * Ws * Jw;
    for (int q = q0; q < q1; ++q) {
      const int j = kx - ax[q] - rmin_x;  // in [0, Jw)
      const float wgt = to_f32(mc_row[q * Jw + j]);
      if (wgt != 0.f) {
        acc = fmaf(wgt, to_f32(taps_b[(static_cast<size_t>(p) * Ws + q) * C]),
                   acc);
      }
    }
  }
  out[(static_cast<size_t>(b) * Kh * Kw + k) * C + c] = acc;
}

dim3 pool_grid(int B, int C, int Kh, int Kw) {
  const int n_kxb = (Kw + kClustPerBlock - 1) / kClustPerBlock;
  return dim3((C + kChanPerWarp - 1) / kChanPerWarp, Kh * n_kxb, B);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int wesup_cell_pool0(const void* seg, const void* taps, void* out,
                                const void* row_lo, const void* row_hi,
                                const void* col_lo, const void* col_hi, int B,
                                int H, int W, int C, int Kh, int Kw, int dtype,
                                void* stream) {
  const dim3 block(kChanPerWarp, kClustPerBlock);
  const dim3 grid = pool_grid(B, C, Kh, Kw);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sg = static_cast<const int*>(seg);
  auto* o = static_cast<float*>(out);
  const auto* rl = static_cast<const int*>(row_lo);
  const auto* rh = static_cast<const int*>(row_hi);
  const auto* cl = static_cast<const int*>(col_lo);
  const auto* ch = static_cast<const int*>(col_hi);
  if (dtype == 0) {
    cell_pool0_kernel<float><<<grid, block, 0, s>>>(
        sg, static_cast<const float*>(taps), o, rl, rh, cl, ch, H, W, C, Kh,
        Kw);
  } else if (dtype == 1) {
    cell_pool0_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        sg, static_cast<const __nv_bfloat16*>(taps), o, rl, rh, cl, ch, H, W,
        C, Kh, Kw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wesup_cell_pool_stage(
    const void* mc, const void* taps, void* out, const void* ay,
    const void* ax, const void* p_lo, const void* p_hi, const void* q_lo,
    const void* q_hi, int B, int Hs, int Ws, int C, int Ih, int Jw, int Kh,
    int Kw, int rmin_y, int rmin_x, int dtype, void* stream) {
  const dim3 block(kChanPerWarp, kClustPerBlock);
  const dim3 grid = pool_grid(B, C, Kh, Kw);
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  const auto* y = static_cast<const int*>(ay);
  const auto* x = static_cast<const int*>(ax);
  const auto* pl = static_cast<const int*>(p_lo);
  const auto* ph = static_cast<const int*>(p_hi);
  const auto* ql = static_cast<const int*>(q_lo);
  const auto* qh = static_cast<const int*>(q_hi);
  if (dtype == 0) {
    cell_pool_stage_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(mc), static_cast<const float*>(taps), o, y,
        x, pl, ph, ql, qh, Hs, Ws, C, Ih, Jw, Kh, Kw, rmin_y, rmin_x);
  } else if (dtype == 1) {
    cell_pool_stage_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(mc),
        static_cast<const __nv_bfloat16*>(taps), o, y, x, pl, ph, ql, qh, Hs,
        Ws, C, Ih, Jw, Kh, Kw, rmin_y, rmin_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
