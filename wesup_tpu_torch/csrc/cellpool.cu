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
// Design, common part:
//   - SLIC's cell structure bounds which pixels can reach cluster
//     k = ky * Kw + kx: for K1 the pixels whose cell lies within +-1 of
//     (ky, kx); for K2 the stage rows p whose window [ay[p] + rmin_y,
//     ay[p] + rmin_y + Ih) holds ky, and the same along x.  Both are
//     contiguous ranges (cells and anchors are monotone) that the host
//     tabulates once per plan: lo[ky] .. hi[ky] and lo[kx] .. hi[kx].
//   - Every output element is written exactly once: no atomics, so runs
//     are bitwise repeatable.  taps may be f32 or bf16 (mc has taps'
//     dtype); products of two bf16 values are exact in f32.
//
// K1 (simple; making it fast is later work): one thread block per (channel
// chunk of 32, cluster row ky, 8 cluster columns, image b); one thread per
// (kx, c).  A warp is one cluster and 32 neighbouring channels, so its
// reads of taps are one contiguous segment and its reads of seg are
// broadcasts; each thread walks its window in a fixed order.
//
// K2 (compact once, then stream the rows).  A cluster's window at stage 1
// of the main path (Kh x Kw = 20 x 29, Ih = Jw = 5) has about 1161 (p, q)
// positions and only about 102 nonzero weights, at most 200 (38 / 16 / 9
// of 289 / 72 / 33 at stages 2-4), and C runs to 1536 channels.  So:
//   - A block owns ncl clusters (ky, kx0 .. kx0 + ncl) of one image and
//     nch warps of 256 channels per cluster (csrc/rows.cuh: C = 256 -> 8
//     clusters x 1 warp, 768 -> 2 x 3, 1536 -> 1 x 6; channels past 2048
//     go to grid.y).  3-24 KB of shared memory per block (ncl lists);
//     registers (48 in the bf16 vector form) bound the residency at 40-42
//     warps per SM at every C.
//   - Compact once: warp l reads cluster kx0 + l's window in (p, q) order,
//     64 positions per batch of loads, 2 per lane in flight (mc[b, p, i, q,
//     j] with i = ky - ay[p] - rmin_y, j = kx - ax[q] - rmin_x), and
//     ballot / prefix-popc append the nonzero terms (row offset
//     (p * Ws + q) * C, f32 weight) to the cluster's list in shared
//     memory, in that order.  All channel warps of the cluster share the
//     list.
//   - Stream (rows.cuh): each warp fmafs its 256 channels of the listed tap
//     rows in list order, a lane 8 consecutive channels per 16-byte load, 8
//     (bf16) or 4 (f32) rows in flight; each channel's f32 sum has the
//     order of a thread that walks the window and skips zero weights.
//   - A window with more than kStageCap = 256 nonzero terms is compacted
//     and streamed in rounds: the list resumes at the first term that did
//     not fit, and the sums carry in registers, so the order is unchanged
//     and no shape is refused.  C % 8 != 0 or a misaligned base takes the
//     scalar form of the stream (same order, masked past C).
//   - Bound: bytes, about 364 MB over the four stages at the main-path
//     shape (taps, mc, the f32 sums), 0.11 ms at 3.35 TB/s.  Tensor cores
//     (wgmma) are not used: at 1-3 operations per byte they cannot raise
//     the rate, and a dense product would read M's zeros too.
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
//   - K4: one thread per (b, p, q, c), laid out as K1 (32 channels x 8 stage
//     columns per block), so a warp's mc reads are broadcasts and its dsums
//     reads one contiguous row segment.  Each thread walks its Ih x Jw window
//     in a fixed order and writes once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "rows.cuh"

namespace {

constexpr int kChanPerWarp = 32;   // threadIdx.x: channel within the chunk
constexpr int kClustPerBlock = 8;  // threadIdx.y: cluster column in block

using wesup_rows::kLaneChans;
using wesup_rows::kMaxWarps;
using wesup_rows::kWarpChans;
using wesup_rows::round_to;
using wesup_rows::to_f32;

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

// K2: per block, ncl clusters (ky, kx0 .. kx0 + ncl) of one image and nch
// warps of 256 channels per cluster (rows.cuh).  Warp l < ncl compacts
// cluster kx0 + l; then every warp streams its cluster's terms.
constexpr int kStageCap = 256;  // terms per cluster per round
constexpr int kUnroll = 2;      // 32-position steps per batch of loads

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32) cell_pool_stage_kernel(
        const T* __restrict__ mc, const T* __restrict__ taps,
        float* __restrict__ out, const int* __restrict__ ay,
        const int* __restrict__ ax, const int* __restrict__ p_lo,
        const int* __restrict__ p_hi, const int* __restrict__ q_lo,
        const int* __restrict__ q_hi, int Hs, int Ws, int C, int Ih, int Jw,
        int Kh, int Kw, int rmin_y, int rmin_x, int ncl, int nch) {
  // ncl lists of kStageCap terms: offsets, then weights
  extern __shared__ long long s_off[];
  float* s_w = reinterpret_cast<float*>(s_off + ncl * kStageCap);
  __shared__ int s_n[kMaxWarps];

  const int n_kxb = (Kw + ncl - 1) / ncl;
  const int b = blockIdx.x / (Kh * n_kxb);
  const int rem = blockIdx.x - b * Kh * n_kxb;
  const int ky = rem / n_kxb;
  const int kx0 = (rem - ky * n_kxb) * ncl;
  const int n_cl = min(ncl, Kw - kx0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = warp / nch;  // the warp's cluster within the block
  const int c = (blockIdx.y * nch + warp % nch) * kWarpChans +
                lane * kLaneChans;
  const bool streams = cl < n_cl && c < C;
  const int nvalid = C - c;
  const T* base = taps + static_cast<size_t>(b) * Hs * Ws * C +
                  (streams ? c : 0);

  // the compacting warp's window: stage rows p0 .. p1 x columns q0 .. q1,
  // positions idx = (p - p0) * nq + (q - q0), visited in (p, q) order
  const bool compacts = warp < n_cl;
  const int kx = kx0 + warp;
  int p0 = 0, nq = 1, npos = 0, q0 = 0;
  if (compacts) {
    p0 = p_lo[ky];
    q0 = q_lo[kx];
    nq = q_hi[kx] - q0;
    npos = (p_hi[ky] - p0) * nq;
    if (nq <= 0) npos = 0, nq = 1;
  }
  const T* mc_b = mc + static_cast<size_t>(b) * Hs * Ih * Ws * Jw;
  long long* my_off = s_off + warp * kStageCap;
  float* my_w = s_w + warp * kStageCap;
  int cursor = 0;

  float acc[kLaneChans];
#pragma unroll
  for (int e = 0; e < kLaneChans; ++e) acc[e] = 0.f;

  for (;;) {
    if (compacts) {
      // the nonzero weights of the window from ``cursor`` on, in order,
      // until the buffer is full: 32 positions per step, ballot + popc
      int n = 0;
      bool full = false;
      while (!full && cursor < npos) {
        // kUnroll loads of 32 positions in flight, then their ballots in
        // position order
        float wgt[kUnroll];
        long long row[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int idx = cursor + u * 32 + lane;
          wgt[u] = 0.f;
          row[u] = 0;
          if (idx < npos) {
            const int dp = idx / nq;
            const int p = p0 + dp;
            const int q = q0 + idx - dp * nq;
            const int i = ky - ay[p] - rmin_y;  // in [0, Ih) by the tables
            const int j = kx - ax[q] - rmin_x;  // in [0, Jw)
            wgt[u] = to_f32(mc_b[((static_cast<size_t>(p) * Ih + i) * Ws +
                                  q) * Jw + j]);
            row[u] = static_cast<long long>(p) * Ws + q;
          }
        }
        int step = kUnroll * 32;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool nz = wgt[u] != 0.f;
          const unsigned m = __ballot_sync(0xffffffffu, nz);
          const int slot = n + __popc(m & ((1u << lane) - 1u));
          if (nz && slot < kStageCap) {
            my_off[slot] = row[u] * C;
            my_w[slot] = wgt[u];
          }
          const int total = __popc(m);
          if (n + total > kStageCap) {
            // resume at the first term that did not fit
            const unsigned over = __ballot_sync(0xffffffffu,
                                                nz && slot == kStageCap);
            step = u * 32 + __ffs(over) - 1;
            n = kStageCap;
            full = true;
            break;
          }
          n += total;
          if (n == kStageCap) {
            step = (u + 1) * 32;
            full = true;
            break;
          }
        }
        cursor = min(cursor + step, npos);
      }
      if (lane == 0) s_n[warp] = n;
    }
    __syncthreads();
    if (streams) {
      wesup_rows::stream_terms<T, VEC>(base, 1, s_off + cl * kStageCap,
                                       s_w + cl * kStageCap, s_n[cl], nvalid,
                                       acc);
    }
    // another round while any cluster of the block has terms left
    if (!__syncthreads_or(compacts && cursor < npos)) break;
  }
  if (streams) {
    const int k = ky * Kw + kx0 + cl;
    wesup_rows::store_sums<VEC>(
        out + (static_cast<size_t>(b) * Kh * Kw + k) * C + c, acc, nvalid);
  }
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
        // dsums rounded to T, as the reference casts its cotangent window
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

template <typename T>
int launch_stage(const void* mc, const void* taps, void* out, const void* ay,
                 const void* ax, const void* p_lo, const void* p_hi,
                 const void* q_lo, const void* q_hi, int B, int Hs, int Ws,
                 int C, int Ih, int Jw, int Kh, int Kw, int rmin_y,
                 int rmin_x, cudaStream_t s) {
  const wesup_rows::Shape sp = wesup_rows::block_shape(C);
  const int n_kxb = (Kw + sp.ncl - 1) / sp.ncl;
  const dim3 grid(B * Kh * n_kxb, sp.nch_total > 0
                      ? (sp.nch_total + sp.nch - 1) / sp.nch : 0);
  if (grid.x == 0 || grid.y == 0) return 0;
  const dim3 block(32 * sp.ncl * sp.nch);
  const size_t smem = static_cast<size_t>(sp.ncl) * kStageCap *
                      (sizeof(long long) + sizeof(float));  // <= 24 KB
  const T* t = static_cast<const T*>(taps);
  auto* o = static_cast<float*>(out);
  // 16-byte loads and stores: rows of C % 8 == 0 from aligned bases
  const bool vec = C % kLaneChans == 0 &&
                   reinterpret_cast<size_t>(t) % 16 == 0 &&
                   reinterpret_cast<size_t>(o) % 16 == 0;
  const auto* m = static_cast<const T*>(mc);
  const auto* y = static_cast<const int*>(ay);
  const auto* x = static_cast<const int*>(ax);
  const auto* pl = static_cast<const int*>(p_lo);
  const auto* ph = static_cast<const int*>(p_hi);
  const auto* ql = static_cast<const int*>(q_lo);
  const auto* qh = static_cast<const int*>(q_hi);
  if (vec) {
    cell_pool_stage_kernel<T, true><<<grid, block, smem, s>>>(
        m, t, o, y, x, pl, ph, ql, qh, Hs, Ws, C, Ih, Jw, Kh, Kw, rmin_y,
        rmin_x, sp.ncl, sp.nch);
  } else {
    cell_pool_stage_kernel<T, false><<<grid, block, smem, s>>>(
        m, t, o, y, x, pl, ph, ql, qh, Hs, Ws, C, Ih, Jw, Kh, Kw, rmin_y,
        rmin_x, sp.ncl, sp.nch);
  }
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
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_stage<float>(mc, taps, out, ay, ax, p_lo, p_hi, q_lo, q_hi,
                               B, Hs, Ws, C, Ih, Jw, Kh, Kw, rmin_y, rmin_x,
                               s);
  }
  if (dtype == 1) {
    return launch_stage<__nv_bfloat16>(mc, taps, out, ay, ax, p_lo, p_hi,
                                       q_lo, q_hi, B, Hs, Ws, C, Ih, Jw, Kh,
                                       Kw, rmin_y, rmin_x, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
