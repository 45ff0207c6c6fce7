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
// K1 (compact once per cluster, then stream its pixels' rows).  On the main
// path (C = 128) a cluster's +-1-cell window holds about 1755 pixels (at
// most 1936), of which about 175 (at most 268) belong to it, and 8.5% of
// the clusters lie in the canvas padding and are empty.  So:
//   - A block owns one cluster (b, k) and nch warps of 128 channels
//     (rows.cuh's 4-channel lane map: C = 128 -> one warp, 136 -> two;
//     channels past 1024 go to grid.y).  A block of one cluster ends when
//     its own list does, where a block of 8 clusters held its slot until
//     the longest of 8 uneven lists (0-268 pixels) was done.
//   - Compact: warp 0 scans the cluster's window of seg in (h, w) order,
//     128 positions per batch of int32 loads (4 per lane in flight; the
//     lane's window row and column move on without a division), and
//     ballot / prefix-popc append the pixels with seg == k (as h * W + w)
//     to the round's list in shared memory, in that order.  seg < 0
//     matches no cluster.  The windows of neighbouring clusters overlap, so
//     seg (3.8 MB) is read about 9 times, from L2, against 207 MB of taps
//     rows streamed from HBM.  The scans cost more than those bytes say:
//     with the stream left out, the kernel still took a fifth of its time.
//   - Stream (rows.cuh stream_list): each warp adds the listed taps rows in
//     list order, a lane 4 consecutive channels (one 8-byte load in bf16,
//     one 16-byte load in f32), 16 (bf16) or 8 (f32) rows in flight, and
//     writes its 4 f32 sums with one 16-byte store.  The lane map at
//     C = 128: rows.cuh's 256-channel warp would idle half its lanes, and
//     two clusters per warp (16 lanes each) would walk lists of different
//     lengths in one loop; 4-channel lanes keep the whole warp on one list.
//   - Rounds of kPool0Cap = 128 pixels: a cluster's scan stops when the
//     list is full, the list is streamed, and the scan resumes at the first
//     pixel that did not fit, the sums carrying in registers.  So no size
//     is refused (a large sp_area or a degenerate seg can make a cluster as
//     large as its window), and the order is unchanged.  On the main path
//     (about 175 pixels a cluster) most clusters take two rounds, so a
//     block's scan is split around its first stream.  Measured: one-
//     cluster blocks with rounds of 96-192 pixels alike; 256-pixel rounds
//     (one for most clusters) or 64 took 1.2x as long, and 8-cluster blocks
//     with 512-pixel rounds 1.23x.
//   - Each channel's f32 sum adds the cluster's pixels in (h, w) order, as
//     a thread that walks the window and skips other clusters' pixels
//     would (the earlier thread-per-channel design, which the kernel stays
//     bitwise equal to).  An empty cluster writes zeros.  C % 4 != 0 or a
//     misaligned base takes the scalar form (same order, masked past C).
//   - Bound: bytes: the valid pixels' taps rows read once, seg, the f32
//     sums; about 214 MB, 0.064 ms at 3.35 TB/s at the main-path shape.
//     Tensor cores (wgmma) are not used: one add per 2-byte element is far
//     below the ~295 operations per byte where they become the limit, and
//     a one-hot product would also read the windows' other pixels.
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
// K3 (stream pixel runs, reuse each cotangent row while the segment
// repeats).  The TPU kernel (_bwd_kernel) selected each 8-row block's rows
// through a one-hot (L, n) x (n, C) MXU product, because TPU gathers are
// slow; here it is a plain selection with no products, so no tensor cores.
// Bound: bytes: seg and dsums read once, dtaps written once; 251.6 MB,
// 0.075 ms at 3.35 TB/s at the main-path shape (C = 128, bf16), and 1.99
// GB, 0.593 ms at C = 1024.  The output is 97-99% of those bytes, so the
// kernel is a store stream, and what it must avoid is a load in front of
// each store: the earlier one-thread-per-4-channels form loaded seg and
// then a dsums row before every 8-byte store and took twice its bound,
// though without those loads its threads stored at the card's rate.  So:
//   - A lane owns 8 consecutive channels: one 16-byte store per pixel in
//     bf16, two in f32.  g = ceil(C / 8) lanes make a slot that covers a
//     pixel's row (C = 128: 16 lanes, two slots per warp); above 256
//     channels a slot is a whole warp on one 256-channel chunk and the
//     chunks are separate warp tasks (C = 1024: four).
//   - A warp owns one task: a range of spw * run <= 32 consecutive pixels
//     of the flat (b, h, w) index (ranges and runs cross image rows and
//     images) and one chunk.  Slot j walks pixels j * run .. (j + 1) * run
//     - 1 of the range (C = 128: runs of 16; C >= 256: 32), so a warp's
//     store of one pixel is a contiguous 256-512 bytes.  The grid holds
//     every task: grids of one or two waves of resident blocks striding
//     over the tasks took longer, and so did ranges of 64 or 128 pixels
//     at C = 128.
//   - seg is loaded once per task, coalesced, one pixel per lane, and
//     turned into the dsums row index b * K + k (-1 where seg < 0) with one
//     32-bit division by H * W per pixel; the walk takes each pixel's row
//     index from its lane with __shfl_sync.  No 64-bit division anywhere.
//   - The lane keeps its 8 channels of the current row in registers,
//     already rounded to T (__float2bfloat16_rn: torch's rounding of
//     .to(bfloat16)), and loads a row only when the row index changes
//     along its run (about once per 14 pixels at sp_area 200).  An invalid
//     pixel stores zeros and loads nothing.  Rounding in the wrapper (a
//     torch cast, as K4 does) took longer at C = 128.
//   - kBwdUnroll pixels per batch: their row loads (where the index
//     changes) are issued before their stores.  The stores are evict-first
//     (__stcs): the output streams through the 50 MB L2 once, and dsums
//     (2.4 MB at C = 128, 19 MB at C = 1024) stays there.
//   - C % 8 != 0 or a misaligned base takes the scalar form of the same
//     walk (element loads and stores, masked past C).
//   - Every output element is written once, no atomics; a pure selection:
//     bitwise equal to the plain gather.
//
// K4 (compact once per stage pixel, then stream the cotangent rows).  A
// stage pixel's window (Ih x Jw = 25 weights at stages 1-3 of the main
// path, 49 at stage 4) holds on average 1.98 / 2.94 / 5.07 / 11.07 nonzero
// weights (at most 6 / 7 / 11 / 18), and C runs to 1536 channels.  So:
//   - The wrapper rounds dsums to T once, with a torch cast (dsums.to(T)),
//     as the JAX backward casts its cotangent window before the Pallas
//     body; the kernel reads rows of T.  That is bitwise the same as
//     rounding on every read, and halves the bytes re-read in bf16.
//   - A block owns a run of consecutive stage pixels (b, p, q0 .. q0 + run)
//     and ncl pixel slots x nch warps of 256 channels (rows.cuh block shape:
//     C = 256 -> 8 x 1, 768 -> 2 x 3, 1536 -> 1 x 6; channels past 2048 go
//     to grid.y).  run = ncl * m, with m (1-32 pixels per slot) set so that
//     the grid holds about one wave of the card's resident warps, then
//     balanced over the stage row: stage 1 of the main path takes whole
//     rows of 208 pixels (26 per slot), stage 4 runs of 2.  Longer runs
//     pay the block's staging and compaction over more pixels: capped at
//     8 per slot (two waves) K4 took 1.09x as long.
//   - Compact once: the block loads the run's Ih slabs mc[b, p, i, q0 ..
//     q0 + run, :] (contiguous over (q, j)) into shared memory with
//     coalesced loads; then thread u lists pixel q0 + u's nonzero weights
//     whose cluster lies in the grid, as (cluster index, f32 weight), in
//     (i, j) order, the order of a thread that walks the window.  A list
//     holds at most Ih * Jw terms and the buffer is sized from Ih and Jw
//     at launch (above 48 KB through cudaFuncSetAttribute), so no plan is
//     refused.
//   - Stream (rows.cuh stream_list): the warps of slot l walk pixels l,
//     l + ncl, ... of the run; a lane loads 8 consecutive channels of each
//     listed row (one 16-byte load in bf16, two in f32), 8 (bf16) or 4
//     (f32) rows in flight, the last batch masked, and fmafs them in list
//     order.  The sum is rounded to T once and written with one 16-byte
//     store (bf16) or two (f32), each element once, no atomics; a pixel
//     with no terms writes zeros.  C % 8 != 0 or a misaligned base takes
//     the scalar form (same order, masked past C).
//   - In bf16 the product of two bf16 values is exact in f32, so each
//     element is the ordered sum of w * T(dsums), rounded once per add, as
//     in the earlier thread-per-channel design; in f32 the fmafs and their
//     order are that design's too, so the kernel stays bitwise equal to it.
//   - Bound: bytes: mc and dsums read once, dtaps written once; about 364
//     MB, 0.109 ms over stages 1-4 at the main-path shape.  The stream
//     re-reads each dsums row from L2 once per stage pixel that names it
//     (about 0.87 GB in bf16 over the four stages).  Tensor cores (wgmma)
//     are not used: at 1-3 operations per byte they cannot raise the rate,
//     and a dense product would read M's zeros too.

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
using wesup_rows::to_f32;

// K1: per block, one cluster k of one image and nch warps of 128 channels.
// Warp 0 compacts the cluster's pixels; then every warp streams its
// channels of their rows.
constexpr int kPool0Cap = 128;     // pixels per round
constexpr int kPool0Unroll = 4;    // 32-position steps per batch of loads
constexpr int kPool0LaneChans = 4;
constexpr int kPool0WarpChans = 32 * kPool0LaneChans;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32) cell_pool0_kernel(
    const int* __restrict__ seg, const T* __restrict__ taps,
    float* __restrict__ out, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const int* __restrict__ col_lo,
    const int* __restrict__ col_hi, int H, int W, int C, int Kh, int Kw,
    int nch) {
  __shared__ int s_pix[kPool0Cap];  // the round's pixels h * W + w
  __shared__ int s_n;

  const int K = Kh * Kw;
  const int b = blockIdx.x / K;
  const int k = blockIdx.x - b * K;
  const int ky = k / Kw, kx = k - ky * Kw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (blockIdx.y * nch + warp) * kPool0WarpChans +
                lane * kPool0LaneChans;
  const bool streams = c < C;
  const int nvalid = C - c;
  const T* base = taps + static_cast<size_t>(b) * H * W * C +
                  (streams ? c : 0);

  // warp 0's window: rows h0 .. h1 x columns w0 .. w0 + nw, positions
  // idx = (h - h0) * nw + (w - w0), visited in (h, w) order
  const bool compacts = warp == 0;
  int h0 = 0, w0 = 0, nw = 1, npos = 0;
  if (compacts) {
    h0 = row_lo[ky];
    w0 = col_lo[kx];
    nw = col_hi[kx] - w0;
    npos = (row_hi[ky] - h0) * nw;
    if (nw <= 0 || npos <= 0) npos = 0, nw = 1;
  }
  const int* seg_b = seg + static_cast<size_t>(b) * H * W;
  int cursor = 0;
  // window row and column (dh, dw) of the lane's position cursor + lane,
  // moved on 32 positions at a time without a division
  int dh = lane / nw;
  int dw = lane - dh * nw;

  float acc[kPool0LaneChans];
#pragma unroll
  for (int e = 0; e < kPool0LaneChans; ++e) acc[e] = 0.f;

  for (;;) {
    if (compacts) {
      // the cluster's pixels from ``cursor`` on, in order, until the
      // buffer is full: 32 positions per step, ballot + popc
      int n = 0;
      bool full = false;
      while (!full && cursor < npos) {
        // kPool0Unroll loads of 32 positions in flight, then their ballots
        // in position order
        bool hit[kPool0Unroll];
        int pix[kPool0Unroll];
#pragma unroll
        for (int u = 0; u < kPool0Unroll; ++u) {
          hit[u] = false;
          pix[u] = 0;
          if (cursor + u * 32 + lane < npos) {
            pix[u] = (h0 + dh) * W + w0 + dw;
            hit[u] = seg_b[pix[u]] == k;
          }
          for (dw += 32; dw >= nw; dw -= nw) ++dh;
        }
        int step = kPool0Unroll * 32;
#pragma unroll
        for (int u = 0; u < kPool0Unroll; ++u) {
          const unsigned m = __ballot_sync(0xffffffffu, hit[u]);
          const int slot = n + __popc(m & ((1u << lane) - 1u));
          if (hit[u] && slot < kPool0Cap) s_pix[slot] = pix[u];
          const int total = __popc(m);
          if (n + total > kPool0Cap) {
            // resume at the first pixel that did not fit
            const unsigned over = __ballot_sync(0xffffffffu,
                                                hit[u] && slot == kPool0Cap);
            step = u * 32 + __ffs(over) - 1;
            n = kPool0Cap;
            full = true;
            break;
          }
          n += total;
          if (n == kPool0Cap) {
            step = (u + 1) * 32;
            full = true;
            break;
          }
        }
        cursor = min(cursor + step, npos);
        if (step != kPool0Unroll * 32) {
          // the buffer filled inside the batch: the next round resumes here
          dh = (cursor + lane) / nw;
          dw = cursor + lane - dh * nw;
        }
      }
      if (lane == 0) s_n = n;
    }
    __syncthreads();
    if (streams) {
      // 128 bytes per lane in flight in either dtype
      constexpr int kDepth = sizeof(T) == 2 ? 16 : 8;
      using Row = typename std::conditional<
          VEC, wesup_rows::VecRow4<T>,
          wesup_rows::ScalarRow<T, kPool0LaneChans>>::type;
      wesup_rows::stream_list<Row, kDepth, false>(
          base, s_pix, C, nullptr, s_n, nvalid, acc);
    }
    // another round while the cluster has pixels left
    if (!__syncthreads_or(compacts && cursor < npos)) break;
  }
  if (streams) {
    wesup_rows::store_sums4<VEC>(
        out + (static_cast<size_t>(b) * K + k) * C + c, acc, nvalid);
  }
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

template <typename T>
int launch_pool0(const int* seg, const void* taps, float* out,
                 const int* row_lo, const int* row_hi, const int* col_lo,
                 const int* col_hi, int B, int H, int W, int C, int Kh,
                 int Kw, cudaStream_t s) {
  // one block per (image, cluster); nch warps of 128 channels, more
  // channels to grid.y
  const int nch_total = (C + kPool0WarpChans - 1) / kPool0WarpChans;
  const int nch = std::min(nch_total, kMaxWarps);
  const dim3 grid(B * Kh * Kw, nch > 0 ? (nch_total + nch - 1) / nch : 0);
  if (grid.x == 0 || grid.y == 0) return 0;
  const dim3 block(32 * nch);
  const T* t = static_cast<const T*>(taps);
  // 4-channel vector loads (8 or 16 bytes) and 16-byte stores: rows of
  // C % 4 == 0 from aligned bases
  const bool vec = C % kPool0LaneChans == 0 &&
                   reinterpret_cast<size_t>(t) % (kPool0LaneChans *
                                                  sizeof(T)) == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  if (vec) {
    cell_pool0_kernel<T, true><<<grid, block, 0, s>>>(
        seg, t, out, row_lo, row_hi, col_lo, col_hi, H, W, C, Kh, Kw, nch);
  } else {
    cell_pool0_kernel<T, false><<<grid, block, 0, s>>>(
        seg, t, out, row_lo, row_hi, col_lo, col_hi, H, W, C, Kh, Kw, nch);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- backward ------------------------------------------------------------

// K3: a lane's 8 channels of one cotangent row, loaded from f32 and held in
// the form they are stored in.
template <typename T, bool VEC>
struct GradRow;

// bf16, 16-byte aligned: two 16-byte loads, rounded once to 8 packed bf16,
// one 16-byte store
template <>
struct GradRow<__nv_bfloat16, true> {
  float4 lo, hi;
  uint4 u;
  __device__ __forceinline__ void load(const float* src, int) {
    lo = __ldg(reinterpret_cast<const float4*>(src));
    hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
  }
  __device__ __forceinline__ void round() {
    auto* h = reinterpret_cast<__nv_bfloat162*>(&u);
    h[0] = __floats2bfloat162_rn(lo.x, lo.y);
    h[1] = __floats2bfloat162_rn(lo.z, lo.w);
    h[2] = __floats2bfloat162_rn(hi.x, hi.y);
    h[3] = __floats2bfloat162_rn(hi.z, hi.w);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void store(__nv_bfloat16* dst, int) const {
    __stcs(reinterpret_cast<uint4*>(dst), u);
  }
};

// f32, 16-byte aligned: two 16-byte loads, two 16-byte stores
template <>
struct GradRow<float, true> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* src, int) {
    lo = __ldg(reinterpret_cast<const float4*>(src));
    hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
  }
  __device__ __forceinline__ void round() {}
  __device__ __forceinline__ void zero() {
    lo = make_float4(0.f, 0.f, 0.f, 0.f);
    hi = lo;
  }
  __device__ __forceinline__ void store(float* dst, int) const {
    __stcs(reinterpret_cast<float4*>(dst), lo);
    __stcs(reinterpret_cast<float4*>(dst) + 1, hi);
  }
};

// any C or alignment: element loads and stores, masked past C (nvalid)
template <typename T>
struct GradRow<T, false> {
  float x[kLaneChans];
  __device__ __forceinline__ void load(const float* src, int nvalid) {
#pragma unroll
    for (int e = 0; e < kLaneChans; ++e) x[e] = e < nvalid ? src[e] : 0.f;
  }
  __device__ __forceinline__ void round() {}
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < kLaneChans; ++e) x[e] = 0.f;
  }
  __device__ __forceinline__ void store(T* dst, int nvalid) const {
#pragma unroll
    for (int e = 0; e < kLaneChans; ++e) {
      if (e < nvalid) {
        if constexpr (std::is_same<T, float>::value) {
          dst[e] = x[e];
        } else {
          dst[e] = __float2bfloat16_rn(x[e]);
        }
      }
    }
  }
};

constexpr int kBwdWarps = 8;    // warps per block
constexpr int kBwdUnroll = 4;   // pixels per batch of row loads

// K3: per warp, one task: a range of spw * run <= 32 consecutive pixels of
// the flat (b, h, w) index and one 256-channel chunk; slot j (g lanes of 8
// channels) walks pixels j * run .. (j + 1) * run - 1 of the range.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdWarps * 32) cell_pool0_bwd_kernel(
    const int* __restrict__ seg, const float* __restrict__ dsums,
    T* __restrict__ dtaps, int n_pix, int HW, int C, int K, int g, int spw,
    int run, int nchunk, int n_tasks) {
  const int lane = threadIdx.x & 31;
  const int slot = lane / g;
  const int lane_c = (lane - slot * g) * kLaneChans;
  const int task = blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  if (task >= n_tasks) return;   // the whole warp
  const int range = task / nchunk;
  const int c = (task - range * nchunk) * kWarpChans + lane_c;
  const int p0 = range * spw * run;
  const bool stores = slot < spw && c < C;
  const int nvalid = C - c;
  // lane i: the dsums row index of pixel p0 + i, -1 where seg < 0 or past
  // the range
  int key = -1;
  if (lane < spw * run && p0 + lane < n_pix) {
    const int k = seg[p0 + lane];
    if (k >= 0) key = (p0 + lane) / HW * K + k;
  }
  // the slot's first position in the range (idle lanes: clamped), pixels
  const int q0 = min(slot, spw - 1) * run;
  const int n_mine = min(run, n_pix - p0 - q0);
  T* out = dtaps + static_cast<size_t>(p0 + q0) * C + c;
  const float* src = dsums + c;
  GradRow<T, VEC> cur;
  cur.zero();
  int cur_key = -1;
  for (int t0 = 0; t0 < run; t0 += kBwdUnroll) {
    // the batch's row indices; past the run, the last one repeats
    int kk[kBwdUnroll];
    int last = cur_key;
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int kq = __shfl_sync(0xffffffffu, key, min(q0 + t0 + u, 31));
      kk[u] = last = t0 + u < run ? kq : last;
    }
    // loads where the row changes, then the stores in pixel order
    GradRow<T, VEC> r[kBwdUnroll];
    int prev = cur_key;
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (stores && kk[u] != prev && kk[u] >= 0) {
        r[u].load(src + static_cast<size_t>(kk[u]) * C, nvalid);
      }
      prev = kk[u];
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (kk[u] != cur_key) {
        if (kk[u] >= 0) {
          r[u].round();
          cur = r[u];
        } else {
          cur.zero();
        }
        cur_key = kk[u];
      }
      if (stores && t0 + u < n_mine) {
        cur.store(out + static_cast<size_t>(t0 + u) * C, nvalid);
      }
    }
  }
}

// K4: per block, a run of ``run`` stage pixels (b, p, q0 .. q0 + run) of
// one stage row, and ncl pixel slots x nch warps of 256 channels.  The
// block stages the run's window weights, thread u compacts pixel q0 + u,
// then the warps of slot l stream pixels l, l + ncl, ...
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32) cell_pool_stage_bwd_kernel(
    const T* __restrict__ mc, const T* __restrict__ dsums,
    T* __restrict__ dtaps, const int* __restrict__ ay,
    const int* __restrict__ ax, int Hs, int Ws, int C, int Ih, int Jw, int Kh,
    int Kw, int rmin_y, int rmin_x, int run, int ncl, int nch) {
  // the run's weights (Ih slabs of run * Jw), then run lists of Ih * Jw
  // terms (cluster indices, then weights), then the lists' lengths
  extern __shared__ float s_mc[];
  const int cap = Ih * Jw;
  int* s_k = reinterpret_cast<int*>(s_mc + cap * run);
  float* s_w = reinterpret_cast<float*>(s_k + cap * run);
  int* s_n = reinterpret_cast<int*>(s_w + cap * run);

  const int n_runs = (Ws + run - 1) / run;
  const int b = blockIdx.x / (Hs * n_runs);
  const int rem = blockIdx.x - b * Hs * n_runs;
  const int p = rem / n_runs;
  const int q0 = (rem - p * n_runs) * run;
  const int nq = min(run, Ws - q0);

  // mc[b, p, i, q, j] lies at ((b * Hs + p) * Ih + i) * Ws * Jw + q * Jw + j:
  // for each i the run's (q, j) are one contiguous slab
  const int span = nq * Jw;
  const T* mc_p = mc + (static_cast<size_t>(b) * Hs + p) * Ih * Ws * Jw +
                  static_cast<size_t>(q0) * Jw;
  for (int idx = threadIdx.x; idx < Ih * span; idx += blockDim.x) {
    const int i = idx / span;
    const int r = idx - i * span;
    s_mc[i * run * Jw + r] =
        to_f32(mc_p[static_cast<size_t>(i) * Ws * Jw + r]);
  }
  __syncthreads();

  const int u = threadIdx.x;
  if (u < nq) {
    // pixel q0 + u's nonzero weights of clusters in the grid, (i, j) order
    const int ky0 = ay[p] + rmin_y, kx0 = ax[q0 + u] + rmin_x;
    int* my_k = s_k + u * cap;
    float* my_w = s_w + u * cap;
    int n = 0;
    for (int i = 0; i < Ih; ++i) {
      const int ky = ky0 + i;
      if (ky < 0 || ky >= Kh) continue;
      const float* wrow = s_mc + (i * run + u) * Jw;
      for (int j = 0; j < Jw; ++j) {
        const int kx = kx0 + j;
        if (kx < 0 || kx >= Kw) continue;
        const float wgt = wrow[j];
        if (wgt != 0.f) {
          my_k[n] = ky * Kw + kx;
          my_w[n] = wgt;
          ++n;
        }
      }
    }
    s_n[u] = n;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (blockIdx.y * nch + warp % nch) * kWarpChans +
                lane * kLaneChans;
  if (c >= C) return;
  const int nvalid = C - c;
  // dsums arrives rounded to T (the wrapper's cast)
  const T* base = dsums + static_cast<size_t>(b) * Kh * Kw * C + c;
  T* out = dtaps + (static_cast<size_t>(b) * Hs + p) * Ws * C + c;
  // 128 bytes per lane in flight in either dtype
  constexpr int kDepth = sizeof(T) == 2 ? 8 : 4;
  using Row = typename std::conditional<VEC, wesup_rows::VecRow<T>,
                                        wesup_rows::ScalarRow<T>>::type;
  for (int v = warp / nch; v < nq; v += ncl) {
    float acc[kLaneChans];
#pragma unroll
    for (int e = 0; e < kLaneChans; ++e) acc[e] = 0.f;
    wesup_rows::stream_list<Row, kDepth, true>(base, s_k + v * cap, C,
                                               s_w + v * cap, s_n[v], nvalid,
                                               acc);
    wesup_rows::store_rounded<VEC>(out + static_cast<size_t>(q0 + v) * C,
                                   acc, nvalid);
  }
}

template <typename T>
int launch_pool0_bwd(const int* seg, const float* dsums, void* dtaps, int B,
                     int H, int W, int C, int K, cudaStream_t s) {
  // pixel and row indices are 32-bit (the wrapper checks B * H * W and
  // B * K); channel offsets are taken in size_t
  const long long n_pix = static_cast<long long>(B) * H * W;
  if (n_pix <= 0 || C <= 0) return 0;
  if (n_pix > INT_MAX - 32 || static_cast<long long>(B) * K > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the lane map: g lanes of 8 channels per slot, spw slots per warp, runs
  // of ``run`` pixels, nchunk chunks of 256 channels
  const int lanes = (C + kLaneChans - 1) / kLaneChans;
  const int g = std::min(lanes, 32);
  const int spw = 32 / g;
  const int run = 32 / spw;
  const int nchunk = (lanes + 31) / 32;
  const long long n_ranges = (n_pix + spw * run - 1) / (spw * run);
  const long long n_tasks = n_ranges * nchunk;
  if (n_tasks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  T* out = static_cast<T*>(dtaps);
  // 16-byte loads and stores: rows of C % 8 == 0 from aligned bases
  const bool vec = C % kLaneChans == 0 &&
                   reinterpret_cast<size_t>(dsums) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  auto kernel = vec ? cell_pool0_bwd_kernel<T, true>
                    : cell_pool0_bwd_kernel<T, false>;
  // one task per warp
  const int blocks = static_cast<int>((n_tasks + kBwdWarps - 1) / kBwdWarps);
  kernel<<<blocks, kBwdWarps * 32, 0, s>>>(
      seg, dsums, out, static_cast<int>(n_pix), H * W, C, K, g, spw, run,
      nchunk, static_cast<int>(n_tasks));
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBwdPixPerSlot = 32;          // stage pixels per slot, at most
constexpr size_t kSmemDefault = 48 * 1024;  // above: opt in per kernel
constexpr size_t kSmemMax = 232448;         // the most a block can take

// shared memory of a K4 block: the run's weights, its lists, their lengths
size_t stage_bwd_smem(int run, int Ih, int Jw) {
  const size_t cap = static_cast<size_t>(Ih) * Jw;
  return (3 * cap * run + run) * sizeof(float);
}

template <typename T>
int launch_stage_bwd(const void* mc, const void* dsums, void* dtaps,
                     const int* ay, const int* ax, int B, int Hs, int Ws,
                     int C, int Ih, int Jw, int Kh, int Kw, int rmin_y,
                     int rmin_x, cudaStream_t s) {
  const wesup_rows::Shape sp = wesup_rows::block_shape(C);
  if (B <= 0 || Hs <= 0 || Ws <= 0 || sp.nch_total <= 0) return 0;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // pixels per slot: the grid's warps fill the card's resident warps (64
  // per SM) about once, and each warp walks up to kBwdPixPerSlot pixels
  const long long tasks = static_cast<long long>(B) * Hs * Ws * sp.nch_total;
  const long long m = std::max(1LL, std::min<long long>(
      kBwdPixPerSlot, tasks / (static_cast<long long>(n_sm) * 64)));
  int run = static_cast<int>(std::min<long long>(Ws, sp.ncl * m));
  while (run > 1 && stage_bwd_smem(run, Ih, Jw) > kSmemMax) {
    run = (run + 1) / 2;
  }
  const size_t smem = stage_bwd_smem(run, Ih, Jw);
  if (smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // runs of even length along the stage row
  const int n_even = (Ws + run - 1) / run;
  run = (Ws + n_even - 1) / n_even;
  const int n_runs = (Ws + run - 1) / run;
  const dim3 grid(B * Hs * n_runs, (sp.nch_total + sp.nch - 1) / sp.nch);
  const dim3 block(32 * sp.ncl * sp.nch);
  const T* ds = static_cast<const T*>(dsums);
  T* out = static_cast<T*>(dtaps);
  // 16-byte loads and stores: rows of C % 8 == 0 from aligned bases
  const bool vec = C % kLaneChans == 0 &&
                   reinterpret_cast<size_t>(ds) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  auto kernel = vec ? cell_pool_stage_bwd_kernel<T, true>
                    : cell_pool_stage_bwd_kernel<T, false>;
  if (smem > kSmemDefault) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, s>>>(
      static_cast<const T*>(mc), ds, out, ay, ax, Hs, Ws, C, Ih, Jw, Kh, Kw,
      rmin_y, rmin_x, run, sp.ncl, sp.nch);
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
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sg = static_cast<const int*>(seg);
  auto* o = static_cast<float*>(out);
  const auto* rl = static_cast<const int*>(row_lo);
  const auto* rh = static_cast<const int*>(row_hi);
  const auto* cl = static_cast<const int*>(col_lo);
  const auto* ch = static_cast<const int*>(col_hi);
  if (dtype == 0) {
    return launch_pool0<float>(sg, taps, o, rl, rh, cl, ch, B, H, W, C, Kh,
                               Kw, s);
  }
  if (dtype == 1) {
    return launch_pool0<__nv_bfloat16>(sg, taps, o, rl, rh, cl, ch, B, H, W,
                                       C, Kh, Kw, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// K4: dsums (B, Kh * Kw, C) already rounded to T, mc (B, Hs, Ih, Ws, Jw) in
// T -> dtaps (B, Hs, Ws, C) in T.
extern "C" int wesup_cell_pool_stage_bwd(
    const void* mc, const void* dsums, void* dtaps, const void* ay,
    const void* ax, int B, int Hs, int Ws, int C, int Ih, int Jw, int Kh,
    int Kw, int rmin_y, int rmin_x, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* y = static_cast<const int*>(ay);
  const auto* x = static_cast<const int*>(ax);
  if (dtype == 0) {
    return launch_stage_bwd<float>(mc, dsums, dtaps, y, x, B, Hs, Ws, C, Ih,
                                   Jw, Kh, Kw, rmin_y, rmin_x, s);
  }
  if (dtype == 1) {
    return launch_stage_bwd<__nv_bfloat16>(mc, dsums, dtaps, y, x, B, Hs, Ws,
                                           C, Ih, Jw, Kh, Kw, rmin_y, rmin_x,
                                           s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
