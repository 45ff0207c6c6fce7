// Adjoint superpixel pooling of one downsampled stage, kernel K6 of the
// WESUP port, and its backward, kernel K8, for Hopper (sm_90a).  Built by
// wesup_tpu_torch/ops/_build.py with nvcc into the shared library that also
// holds csrc/cellpool.cu; the wrappers are wesup_tpu_torch/ops/adjoint.py::
// adjoint_pool_stage and adjoint_pool_stage_bwd.
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
// operations per byte.  The bytes this data needs are the tapsH_T rows
// that meet a nonzero p_h: about 1.09 GB over the four stages at the
// main-path shape, 0.33 ms at 3.35 TB/s.  The TPU kernel built each row's
// (W, K) one-hot in VMEM and ran two dense MXU products per row (about
// 6.7e11 operations over the four stages at the main-path shape), nearly
// all on zeros.
//
// Design (compact once, then stream the rows):
//   - The wrapper gives the per-(b, k) pixel lists of ops/pooling.py (one
//     stable sort of seg, so each list is in pixel order: row by row, w
//     ascending) and a per-column table of A_wT: the first nonzero row
//     v0[w] (non-decreasing in w) and the weights a0[w], a1[w] of rows
//     v0[w] and v0[w] + 1.  The lists of consecutive g = b * K + k are
//     consecutive in ``order``.
//   - A block owns ncl consecutive lists and nch warps of 256 channels per
//     list (rows.cuh: C = 256 -> 8 lists x 1 warp, 768 -> 2 x 3, 1536 ->
//     1 x 6, so ncl * nch <= 8 warps and none idles; channels past 2048 go
//     to grid.y).  41 KB of shared memory per block: an SM keeps 5 blocks,
//     30-40 warps, resident.
//   - Phase 1, compact once.  The block loads its lists' pixels in windows
//     of kWin = 1024 with coalesced loads, each pixel's h, v0, a0, a1 into
//     one 16-byte slot of shared memory.  Lane 0 of warp l then walks list
//     l's part of the window: within a row pixels arrive with
//     non-decreasing v0, so two running f32 sums (rows cur and cur + 1)
//     hold all of p_h that is still open; pixel w adds a0[w] to p_h[v0] and
//     a1[w] to p_h[v0 + 1], in pixel order.  Each finished nonzero p_h[v]
//     is rounded to T and appended, with the offset of tapsH_T[b, :, h, v],
//     to the list's entries in (h, v) order.  The walk is serial per list,
//     but it reads shared memory only and runs once per list, not once per
//     channel tile.  The open sums carry from one window to the next, so a
//     list of any length is walked; a window of n pixels gives a list at
//     most 2n + 2 entries, which its buffer holds.  (A window of 512 pixels
//     doubles the resident blocks and measured slower at C = 256, where 8
//     lists share a block and take more windows.)
//   - Phase 2, stream the rows (rows.cuh).  Each warp walks its list's
//     entries for its 256 channels: a lane loads 8 consecutive channels 16
//     bytes at a time, 8 (bf16) or 4 (f32) entries ahead, and fmafs them
//     in entry order; the f32 sums stay in registers across windows and are
//     written once, with vector stores.  Each channel's sum is the same
//     fmaf sequence as a walk that flushes p_h into the taps as it goes
//     (tests/test_torch_port_pooling.py::_k6_walk): the same rounded p_h,
//     in the same order.
//   - A tapsH_T that is not channel-contiguous (or C % 8 != 0, or a
//     misaligned base) takes the scalar form of phase 2: the same order,
//     one element per load, masked past C.
//   - No atomics: two launches agree bitwise.
//   - Tensor cores (wgmma) are not used: at 1-3 operations per byte of
//     tapsH_T the card is bound by bytes, and a dense product would also
//     have to read the zeros of p_h.
//
// K8  adjoint_pool_stage_bwd, the backward of K6.  The JAX package has no
//     kernel here (no pallas_call: it differentiates its einsums, wesup_tpu/
//     models/wesup.py:375-377); this is the port's own kernel, the exact
//     transpose of K6 as K6 computes it:
//       dtapsH[b, h, v, c] = T( sum_k T(p_h[v, k]) * dsums[b, k, c] ),
// f32 sums, the same rounded p_h as K6's, dsums (B, K, C) f32 in any strides
// (the forward casts its sums to the compute dtype before the projection,
// so in bf16 the cotangent arrives bf16-representable and no cast is
// needed), written channels last (B, H, Ws, C) in T.
//
// What bounds it on the H100: bytes.  Its output is as large as K6's input
// (about 1.17 GB over stages 1-4 at B=8, 288x416, bf16) and each element is
// a sum of a few terms (on the main path 1.5 at stage 1 to 4.1 at stage 4 on
// average: a column's pixel range spans up to 5 pixels at stage 1 and 34 at
// stage 4, and a superpixel is about 14 pixels wide); add the f32 dsums
// rows, read once (about 80 MB), and seg.
//
// Design (a gather over output rows, no atomics: two launches agree
// bitwise):
//   - Column v of image row h meets only the pixels w with v0[w] == v
//     (weight a0[w]) or v0[w] + 1 == v (weight a1[w]).  v0 does not
//     decrease along w, so these pixels are one range [lo[v], hi[v]); the
//     host tabulates it once per matrix (ops/adjoint.py::column_table).
//   - A block owns a run of columns v of one image row (b, h) and the
//     block shape of rows.cuh (nch warps of 256 channels per row, ncl rows
//     at a time).  Phase 0 stages the run's pixels (seg, v0, a0, a1) in
//     shared memory in one coalesced pass.  Phase 1: one thread per column
//     walks its range in ascending w, merges the weights of pixels of
//     equal seg into a short term list in shared memory (first appearance
//     order), rounds each merged p_h to T and drops the zeros.  Pixels
//     with seg outside [0, K) add nothing.
//   - Order of the adds: each p_h[v, k] is the sum, from 0, of its pixels'
//     weights in ascending w, which is the order in which K6's phase 1
//     sums it (the a1 terms of the pixels with v0 = v - 1 come before the
//     a0 terms of those with v0 = v, all in pixel order): the backward's
//     p_h is bitwise the forward's (tests/test_torch_port_pooling.py::
//     test_k8_walk_p_is_the_forward_p replays both).
//   - Phase 2: each warp streams its rows' terms (rows.cuh::stream_list,
//     fmaf in list order, all loads of a list in flight) and writes each
//     output row once, rounded to T, with 16-byte evict-first stores.  A
//     dsums that is not channel-contiguous or not 16-byte aligned (or C %
//     8 != 0) takes the scalar form: the same order, one element per load.
//   - Measured on the H100 at the main path's shapes (PERF.md): the terms
//     re-read f32 dsums rows from L2 (about 5.5 GB over stages 1-4 against
//     1.17 GB of output), so stages 3-4 run at 7-8 TB/s of L2 reads, not at
//     the HBM rate.  Staging the pixels and evict-first stores took 6% off;
//     streaming two or four columns a warp at once (more loads in flight,
//     more registers) was 1.4-2.3x slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstddef>
#include <type_traits>

#include "rows.cuh"

namespace {

using wesup_rows::kLaneChans;
using wesup_rows::kMaxWarps;
using wesup_rows::kWarpChans;
using wesup_rows::round_to;

constexpr int kWin = 1024;                    // pixels per window
constexpr int kEntries = 2 * kWin + 2 * kMaxWarps;

// One list's walk: the open sums of p_h and where its entries go.
template <typename T>
struct Walker {
  long long sh, sv;
  int Ws;
  int cur_h, cur_v;
  float pa, pb;      // open sums of p_h[cur_v], p_h[cur_v + 1]
  long long* off;    // this window's entries
  float* p;
  int n;

  __device__ __forceinline__ void flush(int h, int v, float s) {
    if (s == 0.f || v >= Ws) return;
    off[n] = h * sh + v * sv;
    // rounded to the taps' dtype, as the TPU kernel casts p_h
    p[n] = round_to(s, static_cast<const T*>(nullptr));
    ++n;
  }

  __device__ __forceinline__ void step(int h, int v, float w0, float w1) {
    if (h != cur_h || v != cur_v) {
      if (cur_v >= 0) {
        if (h == cur_h && v == cur_v + 1) {
          flush(cur_h, cur_v, pa);
          pa = pb;
          pb = 0.f;
        } else {
          flush(cur_h, cur_v, pa);
          flush(cur_h, cur_v + 1, pb);
          pa = 0.f;
          pb = 0.f;
        }
      }
      cur_h = h;
      cur_v = v;
    }
    pa += w0;
    pb += w1;
  }

  __device__ __forceinline__ void finish() {
    if (cur_v >= 0) {
      flush(cur_h, cur_v, pa);
      flush(cur_h, cur_v + 1, pb);
    }
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32) adjoint_pool_kernel(
    const int* __restrict__ order, const int* __restrict__ start,
    const T* __restrict__ taps, long long sb, long long sc, long long sh,
    long long sv, const int* __restrict__ v0, const float* __restrict__ a0,
    const float* __restrict__ a1, float* __restrict__ out, int W, int Ws,
    int C, int K, int BK, int ncl, int nch) {
  __shared__ int4 s_pix[kWin];  // h, v0[w], a0[w], a1[w] (float bits)
  __shared__ long long s_off[kEntries];
  __shared__ float s_p[kEntries];
  __shared__ int s_beg[kMaxWarps], s_n[kMaxWarps];

  const int g0 = blockIdx.x * ncl;
  const int n_lists = min(ncl, BK - g0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = warp / nch;  // the warp's list within the block
  const int c = (blockIdx.y * nch + warp % nch) * kWarpChans +
                lane * kLaneChans;
  const bool streams = cl < n_lists && c < C;
  const int nvalid = C - c;
  const int g = g0 + cl;
  const T* base = taps + (streams ? (g / K) * sb + c * sc : 0);

  // lane 0 of warp l < n_lists walks list g0 + l (no two walks share a
  // warp, so their branches do not serialise each other)
  const bool walks = lane == 0 && warp < n_lists;
  Walker<T> wk;
  int lo = 0, hi = 0;
  if (walks) {
    lo = start[g0 + warp];
    hi = start[g0 + warp + 1];
    wk.sh = sh;
    wk.sv = sv;
    wk.Ws = Ws;
    wk.cur_h = wk.cur_v = -1;
    wk.pa = wk.pb = 0.f;
  }

  float acc[kLaneChans];
#pragma unroll
  for (int e = 0; e < kLaneChans; ++e) acc[e] = 0.f;

  const int r0 = start[g0], r1 = start[g0 + n_lists];
  for (int ws = r0; ws < r1; ws += kWin) {
    const int n = min(kWin, r1 - ws);
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int pix = order[ws + t];
      const int h = pix / W;
      const int w = pix - h * W;
      s_pix[t] = make_int4(h, v0[w], __float_as_int(a0[w]),
                           __float_as_int(a1[w]));
    }
    __syncthreads();
    if (walks) {
      const int jb = max(lo, ws), je = min(hi, ws + n);
      // a window of m pixels of this list gives at most 2 m + 2 entries;
      // lists further on start at least that far on
      const int at = 2 * max(jb - ws, 0) + 2 * warp;
      wk.off = s_off + at;
      wk.p = s_p + at;
      wk.n = 0;
#pragma unroll 4
      for (int j = jb; j < je; ++j) {
        const int4 px = s_pix[j - ws];  // one 16-byte shared load
        wk.step(px.x, px.y, __int_as_float(px.z), __int_as_float(px.w));
      }
      if (jb < je && je == hi) wk.finish();
      s_beg[warp] = at;
      s_n[warp] = wk.n;
    }
    __syncthreads();
    if (streams) {
      const int at = s_beg[cl];
      wesup_rows::stream_terms<T, VEC>(base, sc, s_off + at, s_p + at,
                                       s_n[cl], nvalid, acc);
    }
    __syncthreads();
  }
  if (streams) {
    wesup_rows::store_sums<VEC>(out + static_cast<size_t>(g) * C + c, acc,
                                nvalid);
  }
}

template <typename T>
int launch(const int* order, const int* start, const void* taps,
           long long sb, long long sc, long long sh, long long sv,
           const int* v0, const float* a0, const float* a1, float* out,
           int B, int W, int Ws, int C, int K, cudaStream_t s) {
  const wesup_rows::Shape sp = wesup_rows::block_shape(C);
  const int BK = B * K;
  const dim3 grid((BK + sp.ncl - 1) / sp.ncl, sp.nch_total > 0
                      ? (sp.nch_total + sp.nch - 1) / sp.nch : 0);
  if (grid.x == 0 || grid.y == 0) return 0;
  const dim3 block(32 * sp.ncl * sp.nch);
  const T* t = static_cast<const T*>(taps);
  // 16-byte loads need channel-contiguous rows whose starts are 16-byte
  // aligned; 16-byte stores need C % 8 == 0 (out is a fresh tensor)
  const bool vec = sc == 1 && C % kLaneChans == 0 && sb % kLaneChans == 0 &&
                   sh % kLaneChans == 0 && sv % kLaneChans == 0 &&
                   reinterpret_cast<size_t>(t) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  if (vec) {
    adjoint_pool_kernel<T, true><<<grid, block, 0, s>>>(
        order, start, t, sb, sc, sh, sv, v0, a0, a1, out, W, Ws, C, K, BK,
        sp.ncl, sp.nch);
  } else {
    adjoint_pool_kernel<T, false><<<grid, block, 0, s>>>(
        order, start, t, sb, sc, sh, sv, v0, a0, a1, out, W, Ws, C, K, BK,
        sp.ncl, sp.nch);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8's output: the lane's 8 sums rounded to T and written once with
// evict-first stores (the 1.17 GB output streams through the 50 MB L2 once
// and the dsums rows, re-read by every column that names them, stay there)
__device__ __forceinline__ void store_out(float* dst, const float* acc) {
  __stcs(reinterpret_cast<float4*>(dst),
         make_float4(acc[0], acc[1], acc[2], acc[3]));
  __stcs(reinterpret_cast<float4*>(dst) + 1,
         make_float4(acc[4], acc[5], acc[6], acc[7]));
}

__device__ __forceinline__ void store_out(__nv_bfloat16* dst,
                                          const float* acc) {
  uint4 u;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h[k] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
  }
  __stcs(reinterpret_cast<uint4*>(dst), u);
}

// K8: per block, a run of ``run`` columns v of one image row (b, h).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32) adjoint_pool_bwd_kernel(
    const int* __restrict__ seg, const float* __restrict__ dsums,
    long long sb, long long sk, long long sc, const int* __restrict__ v0,
    const float* __restrict__ a0, const float* __restrict__ a1,
    const int* __restrict__ lo, const int* __restrict__ hi,
    T* __restrict__ dtaps, int H, int W, int Ws, int C, int K, int cap,
    int run, int ncl, int nch) {
  // the run's pixels (seg, v0, a0, a1 bits; at most run * cap of them),
  // then run lists of cap terms (cluster indices, then weights) and their
  // lengths
  extern __shared__ int4 s_bwd[];
  int4* s_px = s_bwd;
  int* s_k = reinterpret_cast<int*>(s_px + cap * run);
  float* s_w = reinterpret_cast<float*>(s_k + cap * run);
  int* s_n = reinterpret_cast<int*>(s_w + cap * run);

  const int n_runs = (Ws + run - 1) / run;
  const int bh = blockIdx.x / n_runs;  // b * H + h
  const int v_beg = (blockIdx.x - bh * n_runs) * run;
  const int nv = min(run, Ws - v_beg);
  const int* seg_row = seg + static_cast<size_t>(bh) * W;

  // phase 0: the run's pixels, one coalesced pass.  Consecutive columns'
  // ranges touch or overlap, so their union is [lo[v_beg], hi[v_beg + nv -
  // 1]), at most nv * cap pixels
  const int w_beg = lo[v_beg];
  const int span = hi[v_beg + nv - 1] - w_beg;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int w = w_beg + i;
    s_px[i] = make_int4(seg_row[w], v0[w], __float_as_int(a0[w]),
                        __float_as_int(a1[w]));
  }
  __syncthreads();

  // phase 1: column v_beg + u's merged terms
  for (int u = threadIdx.x; u < nv; u += blockDim.x) {
    const int v = v_beg + u;
    int* my_k = s_k + u * cap;
    float* my_w = s_w + u * cap;
    int n = 0;
    const int w_end = hi[v] - w_beg;
    for (int i = lo[v] - w_beg; i < w_end; ++i) {
      const int4 px = s_px[i];  // one 16-byte shared load
      const int k = px.x;
      if (k < 0 || k >= K) continue;
      const float wgt = __int_as_float(px.y == v ? px.z : px.w);
      int j = 0;
      while (j < n && my_k[j] != k) ++j;
      if (j == n) {
        my_k[n] = k;
        my_w[n] = 0.f;
        ++n;
      }
      my_w[j] += wgt;
    }
    // rounded to the taps' dtype, as K6 rounds p_h; zeros add nothing
    int m = 0;
    for (int j = 0; j < n; ++j) {
      const float p = round_to(my_w[j], static_cast<const T*>(nullptr));
      if (p != 0.f) {
        my_k[m] = my_k[j];
        my_w[m] = p;
        ++m;
      }
    }
    s_n[u] = m;
  }
  __syncthreads();

  // phase 2: the warps of slot l stream columns l, l + ncl, ...
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (blockIdx.y * nch + warp % nch) * kWarpChans +
                lane * kLaneChans;
  if (c >= C) return;
  const int nvalid = C - c;
  const float* base = dsums + (bh / H) * sb + c * sc;
  T* out = dtaps + (static_cast<size_t>(bh) * Ws + v_beg) * C + c;
  // 128 bytes of f32 rows per lane in flight
  constexpr int kDepth = 4;
  using Row = typename std::conditional<VEC, wesup_rows::VecRow<float>,
                                        wesup_rows::ScalarRow<float>>::type;
  for (int v = warp / nch; v < nv; v += ncl) {
    float acc[kLaneChans];
#pragma unroll
    for (int e = 0; e < kLaneChans; ++e) acc[e] = 0.f;
    wesup_rows::stream_list<Row, kDepth, true>(base, s_k + v * cap, sk,
                                               s_w + v * cap, s_n[v], nvalid,
                                               acc, sc);
    T* dst = out + static_cast<size_t>(v) * C;
    if constexpr (VEC) {
      store_out(dst, acc);
    } else {
      wesup_rows::store_rounded<false>(dst, acc, nvalid);
    }
  }
}

constexpr size_t kSmemDefault = 48 * 1024;  // no opt-in needed below this

// shared memory of a K8 block: the run's pixels, run lists of cap terms
// and their lengths
size_t bwd_smem(int run, int cap) {
  const size_t terms = static_cast<size_t>(cap) * run;
  return terms * sizeof(int4) + (2 * terms + run) * sizeof(int);
}

template <typename T>
int launch_bwd(const int* seg, const float* dsums, long long sb,
               long long sk, long long sc, const int* v0, const float* a0,
               const float* a1, const int* lo, const int* hi, void* dtaps,
               int B, int H, int W, int Ws, int C, int K, int cap,
               cudaStream_t s) {
  const wesup_rows::Shape sp = wesup_rows::block_shape(C);
  if (B <= 0 || H <= 0 || Ws <= 0 || sp.nch_total <= 0) return 0;
  cap = std::max(cap, 1);
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // columns per slot: the grid's warps fill the card's resident warps (64
  // per SM) about once, and each warp walks up to 32 columns
  const long long tasks = static_cast<long long>(B) * H * Ws * sp.nch_total;
  const long long m = std::max(1LL, std::min<long long>(
      32, tasks / (static_cast<long long>(n_sm) * 64)));
  int run = static_cast<int>(std::min<long long>(Ws, sp.ncl * m));
  while (run > 1 && bwd_smem(run, cap) > kSmemDefault) run = (run + 1) / 2;
  if (bwd_smem(run, cap) > kSmemDefault) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // runs of even length along the row
  const int n_even = (Ws + run - 1) / run;
  run = (Ws + n_even - 1) / n_even;
  const long long n_blocks =
      static_cast<long long>(B) * H * ((Ws + run - 1) / run);
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  (sp.nch_total + sp.nch - 1) / sp.nch);
  const dim3 block(32 * sp.ncl * sp.nch);
  T* out = static_cast<T*>(dtaps);
  // 16-byte loads need channel-contiguous rows whose starts are 16-byte
  // aligned; 16-byte stores need C % 8 == 0 (out is a fresh tensor)
  const bool vec = sc == 1 && C % kLaneChans == 0 && sb % kLaneChans == 0 &&
                   sk % kLaneChans == 0 &&
                   reinterpret_cast<size_t>(dsums) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  auto kernel = vec ? adjoint_pool_bwd_kernel<T, true>
                    : adjoint_pool_bwd_kernel<T, false>;
  kernel<<<grid, block, bwd_smem(run, cap), s>>>(
      seg, dsums, sb, sk, sc, v0, a0, a1, lo, hi, out, H, W, Ws, C, K, cap,
      run, sp.ncl, sp.nch);
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

// K8: seg (B, H, W) int32; dsums (B, K, C) f32 with element strides sb, sk,
// sc; v0 / a0 / a1: the (W,) column table of A_wT, lo / hi: its (Ws,) column
// ranges, cap their widest; dtaps: (B, H, Ws, C) in T.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int wesup_adjoint_pool_stage_bwd(
    const void* seg, const void* dsums, long long sb, long long sk,
    long long sc, const void* v0, const void* a0, const void* a1,
    const void* lo, const void* hi, void* dtaps, int B, int H, int W, int Ws,
    int C, int K, int cap, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sg = static_cast<const int*>(seg);
  const auto* ds = static_cast<const float*>(dsums);
  const auto* col = static_cast<const int*>(v0);
  const auto* w0 = static_cast<const float*>(a0);
  const auto* w1 = static_cast<const float*>(a1);
  const auto* l = static_cast<const int*>(lo);
  const auto* h = static_cast<const int*>(hi);
  if (dtype == 0) {
    return launch_bwd<float>(sg, ds, sb, sk, sc, col, w0, w1, l, h, dtaps, B,
                             H, W, Ws, C, K, cap, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(sg, ds, sb, sk, sc, col, w0, w1, l, h,
                                     dtaps, B, H, W, Ws, C, K, cap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
