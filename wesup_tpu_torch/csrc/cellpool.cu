// Superpixel pooling kernels K1 and K2 of the WESUP forward, and their
// backward bodies K3 and K4, for Hopper (sm_90a).  Built by
// wesup_tpu_torch/ops/_build.py with nvcc into a shared library with a plain
// C interface, loaded with ctypes; the wrappers are in
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
//
// K3  cell_pool0_bwd       replaces cellpool_pallas.py::cell_pool0's backward
//                          (Pallas _bwd_kernel via _bwd_impl):
//       dtaps[b, h, w, c] = T(dsums[b, seg[b, h, w], c]), 0 where seg < 0.
// K4  cell_pool_stage_bwd  replaces cell_pool_stage's backward
//                          (Pallas _stage_bwd_kernel via _stage_bwd_impl):
//       dtaps[b, p, q, c] = T(sum_{i, j} mc[b, p, i, q, j] *
//                             T(dsums[b, k(p, i, q, j), c])),
//       k = (ay[p] + rmin_y + i) * Kw + (ax[q] + rmin_x + j), terms whose
//       cluster row or column falls outside the grid skipped, f32 sums.
//
// T is taps' dtype.  The JAX backward rounds the gathered cotangent window to
// T before its f32-accumulated product and rounds the sum to T at the end;
// K4 does the same, so bf16 gradients follow the reference's rounding.
//
// What bounds them: bytes, as for K1 and K2: each writes a full-resolution
// tap gradient (245 MB for stage 0 at B=8, 288x416, bf16) from a few MB of
// dsums that stay in the 50 MB L2.  Neither needs the TPU kernels' one-hot /
// banded weight tiles: K3 is a gather and K4 a gather with an Ih x Jw
// weighted sum.
//
// Design (simple first):
//   - K3: one thread per 4 consecutive channels of one pixel (scalar when C
//     is not a multiple of 4), grid-stride.  Neighbouring threads write
//     neighbouring addresses; seg is read as a broadcast by the threads of a
//     pixel; every output element is written once, no atomics.  A pure
//     selection: bitwise equal to the plain gather.
//   - K4: one thread per (b, p, q, c), laid out as K2 (32 channels x 8 stage
//     columns per block), so a warp's mc reads are broadcasts and its dsums
//     reads one contiguous row segment.  Each thread walks its Ih x Jw window
//     in a fixed order and writes once.

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

// ---- backward ------------------------------------------------------------

__device__ __forceinline__ void store_f32(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// four consecutive values; dst is 4-element aligned
__device__ __forceinline__ void store4_f32(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4_f32(__nv_bfloat16* dst, float4 v) {
  auto* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  d2[0] = __floats2bfloat162_rn(v.x, v.y);
  d2[1] = __floats2bfloat162_rn(v.z, v.w);
}

// a dsums value rounded to T, as the reference casts its cotangent window
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kBwdThreads = 256;

// V = 4: one thread per 4 channels (C % 4 == 0); V = 1: one per channel.
template <typename T, int V>
__global__ void cell_pool0_bwd_kernel(const int* __restrict__ seg,
                                      const float* __restrict__ dsums,
                                      T* __restrict__ dtaps, long long n_items,
                                      int HW, int C, int K) {
  const int per_pix = C / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n_items; t += stride) {
    const long long pix = t / per_pix;               // b * HW + h * W + w
    const int c = static_cast<int>(t - pix * per_pix) * V;
    const int k = seg[pix];
    T* out = dtaps + pix * C + c;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k >= 0) {
      const long long b = pix / HW;
      const float* src = dsums + (b * K + k) * C + c;
      if (V == 4) {
        v = *reinterpret_cast<const float4*>(src);
      } else {
        v.x = *src;
      }
    }
    if (V == 4) {
      store4_f32(out, v);
    } else {
      store_f32(out, v.x);
    }
  }
}

template <typename T>
__global__ void cell_pool_stage_bwd_kernel(
    const T* __restrict__ mc, const float* __restrict__ dsums,
    T* __restrict__ dtaps, const int* __restrict__ ay,
    const int* __restrict__ ax, int Hs, int Ws, int C, int Ih, int Jw, int Kh,
    int Kw, int rmin_y, int rmin_x) {
  const int n_qb = (Ws + kClustPerBlock - 1) / kClustPerBlock;
  const int p = blockIdx.y / n_qb;
  const int q = (blockIdx.y % n_qb) * kClustPerBlock + threadIdx.y;
  const int c = blockIdx.x * kChanPerWarp + threadIdx.x;
  const int b = blockIdx.z;
  if (q >= Ws || c >= C) return;

  // mc[b, p, i, q, j] lies at ((b * Hs + p) * Ih + i) * Ws * Jw + q * Jw + j
  const T* mc_pq = mc + (static_cast<size_t>(b) * Hs + p) * Ih * Ws * Jw +
                   static_cast<size_t>(q) * Jw;
  const float* ds_b = dsums + static_cast<size_t>(b) * Kh * Kw * C + c;
  const int ky0 = ay[p] + rmin_y, kx0 = ax[q] + rmin_x;
  float acc = 0.f;
  for (int i = 0; i < Ih; ++i) {
    const int ky = ky0 + i;
    if (ky < 0 || ky >= Kh) continue;
    const T* mc_i = mc_pq + static_cast<size_t>(i) * Ws * Jw;
    for (int j = 0; j < Jw; ++j) {
      const int kx = kx0 + j;
      if (kx < 0 || kx >= Kw) continue;
      const float wgt = to_f32(mc_i[j]);
      if (wgt != 0.f) {
        const float g = ds_b[(static_cast<size_t>(ky) * Kw + kx) * C];
        acc = fmaf(wgt, round_to(g, dtaps), acc);
      }
    }
  }
  store_f32(dtaps + ((static_cast<size_t>(b) * Hs + p) * Ws + q) * C + c,
            acc);
}

template <typename T>
int launch_pool0_bwd(const int* seg, const float* dsums, void* dtaps, int B,
                     int H, int W, int C, int K, cudaStream_t s) {
  const long long n_pix = static_cast<long long>(B) * H * W;
  // 16-byte loads of dsums and 4-value stores need aligned rows and bases
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<size_t>(dsums) % 16 == 0 &&
                   reinterpret_cast<size_t>(dtaps) % (4 * sizeof(T)) == 0;
  const long long n_items = n_pix * (vec ? C / 4 : C);
  const long long want = (n_items + kBwdThreads - 1) / kBwdThreads;
  const int blocks = static_cast<int>(want < (1 << 30) ? want : (1 << 30));
  if (blocks == 0) return 0;
  T* out = static_cast<T*>(dtaps);
  if (vec) {
    cell_pool0_bwd_kernel<T, 4><<<blocks, kBwdThreads, 0, s>>>(
        seg, dsums, out, n_items, H * W, C, K);
  } else {
    cell_pool0_bwd_kernel<T, 1><<<blocks, kBwdThreads, 0, s>>>(
        seg, dsums, out, n_items, H * W, C, K);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stage_bwd(const void* mc, const float* dsums, void* dtaps,
                     const int* ay, const int* ax, int B, int Hs, int Ws,
                     int C, int Ih, int Jw, int Kh, int Kw, int rmin_y,
                     int rmin_x, cudaStream_t s) {
  const int n_qb = (Ws + kClustPerBlock - 1) / kClustPerBlock;
  const dim3 block(kChanPerWarp, kClustPerBlock);
  const dim3 grid((C + kChanPerWarp - 1) / kChanPerWarp, Hs * n_qb, B);
  cell_pool_stage_bwd_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(mc), dsums, static_cast<T*>(dtaps), ay, ax, Hs,
      Ws, C, Ih, Jw, Kh, Kw, rmin_y, rmin_x);
  return static_cast<int>(cudaGetLastError());
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

// K3: dsums (B, K, C) f32, seg (B, H, W) int32 -> dtaps (B, H, W, C) in T.
extern "C" int wesup_cell_pool0_bwd(const void* seg, const void* dsums,
                                    void* dtaps, int B, int H, int W, int C,
                                    int K, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sg = static_cast<const int*>(seg);
  const auto* ds = static_cast<const float*>(dsums);
  if (dtype == 0) return launch_pool0_bwd<float>(sg, ds, dtaps, B, H, W, C, K, s);
  if (dtype == 1) {
    return launch_pool0_bwd<__nv_bfloat16>(sg, ds, dtaps, B, H, W, C, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4: dsums (B, Kh * Kw, C) f32, mc (B, Hs, Ih, Ws, Jw) in T -> dtaps
// (B, Hs, Ws, C) in T.
extern "C" int wesup_cell_pool_stage_bwd(
    const void* mc, const void* dsums, void* dtaps, const void* ay,
    const void* ax, int B, int Hs, int Ws, int C, int Ih, int Jw, int Kh,
    int Kw, int rmin_y, int rmin_x, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ds = static_cast<const float*>(dsums);
  const auto* y = static_cast<const int*>(ay);
  const auto* x = static_cast<const int*>(ax);
  if (dtype == 0) {
    return launch_stage_bwd<float>(mc, ds, dtaps, y, x, B, Hs, Ws, C, Ih, Jw,
                                   Kh, Kw, rmin_y, rmin_x, s);
  }
  if (dtype == 1) {
    return launch_stage_bwd<__nv_bfloat16>(mc, ds, dtaps, y, x, B, Hs, Ws, C,
                                           Ih, Jw, Kh, Kw, rmin_y, rmin_x, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
