// Tile cut and tile stitch of tiled inference, for Hopper (sm_90a).  Built
// by wesup_tpu_torch/ops/_build.py with nvcc into the shared library that
// also holds csrc/cellpool.cu; the wrappers are wesup_tpu_torch/ops/tile.py
// (cut, stitch).
//
// Neither replaces a pallas_call: the JAX package cuts and stitches on the
// host in numpy (wesup_tpu/inference.py: divide_image_to_patches,
// dispatch_padded's canvas, combine_patches_to_image).  They are the port's
// own kernels, added so that a slide stays on the card from its upload to
// its stitched map.  Patches form the grid of get_top_left_coordinates,
// numbered row-major: patch p has its top-left corner at
// (tops[p / n_w], lefts[p % n_w]) and is h x w.
//
// wesup_tile_cut     one chunk's float32 canvas from the uint8 slide:
//       canvas[b, y, x, c] = slide[top + min(y, h-1), left + min(x, w-1), c]
//                            / 255 (IEEE division, as numpy's float32 /)
//     for the patch first + b of rows b < n_real; rows n_real.. are 0.  The
//     pad repeats the last column, then the last row, as the host canvas of
//     Predictor.predict_padded does.
// wesup_tile_stitch  the slide's (H0, W0) float64 running average over the
//     patches that cover each pixel, in patch order:
//     v = (v * c + p) / (c + 1), c = c + 1, from v = c = 0, with a float32
//     p optionally rounded half to even first, or a uint8 p.  That is
//     combine_patches_to_image's recurrence; the explicit _rn intrinsics
//     keep the compiler from contracting v * c + p into an FMA, so the bits
//     are numpy's.
//
// What bounds them on the H100: bytes.  The cut reads a chunk's patches
// (3.8 MB at 8 patches of 400) and writes its canvas (16.6 MB at 416 x 416);
// the stitch reads the slide's probabilities (10.2 MB at 16 patches of 400)
// and writes the map (18.3 MB at 1512 x 1516): microseconds each.
//
// Design (simple): a block row of threads spans one output row (a canvas
// row's W * 3 floats, a map row's W0 doubles), so neighbouring threads read
// and write neighbouring addresses and no thread divides a 64-bit index;
// blockIdx.y strides over the rows.  A stitch thread walks the grid's rows
// and columns that cover its pixel, a handful.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 65535;  // gridDim.y's limit

__global__ void __launch_bounds__(kThreads)
    cut_kernel(const unsigned char* __restrict__ slide,
               const int* __restrict__ tops, const int* __restrict__ lefts,
               float* __restrict__ out, int W0, int n_w, int first,
               int n_real, int n_rows, int h, int w, int H, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // x * 3 + c
  if (i >= W * 3) return;
  const int x = i / 3;
  const int col = (x < w ? x : w - 1) * 3 + (i - x * 3);
  for (int r = blockIdx.y; r < n_rows * H; r += gridDim.y) {
    const int b = r / H;
    const int y = r - b * H;
    float v = 0.f;
    if (b < n_real) {
      const int p = first + b;
      const int sy = tops[p / n_w] + (y < h ? y : h - 1);
      const long long at = static_cast<long long>(sy) * W0 * 3 +
                           lefts[p % n_w] * 3 + col;
      v = __fdiv_rn(static_cast<float>(slide[at]), 255.f);
    }
    out[static_cast<long long>(r) * W * 3 + i] = v;
  }
}

__device__ __forceinline__ double patch_value(const float* probs,
                                              long long i, bool to_even) {
  const float v = probs[i];
  return static_cast<double>(to_even ? rintf(v) : v);  // rint: half to even
}
__device__ __forceinline__ double patch_value(const unsigned char* probs,
                                              long long i, bool) {
  return static_cast<double>(probs[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stitch_kernel(const T* __restrict__ probs, const int* __restrict__ tops,
                  const int* __restrict__ lefts, double* __restrict__ out,
                  int H0, int W0, int n_h, int n_w, int h, int w,
                  bool to_even) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W0) return;
  for (int y = blockIdx.y; y < H0; y += gridDim.y) {
    double v = 0.0, c = 0.0;
    for (int i = 0; i < n_h; ++i) {
      const int dy = y - tops[i];
      if (dy < 0 || dy >= h) continue;
      for (int j = 0; j < n_w; ++j) {
        const int dx = x - lefts[j];
        if (dx < 0 || dx >= w) continue;
        const long long at =
            (static_cast<long long>(i * n_w + j) * h + dy) * w + dx;
        const double p = patch_value(probs, at, to_even);
        v = __ddiv_rn(__dadd_rn(__dmul_rn(v, c), p), __dadd_rn(c, 1.0));
        c = __dadd_rn(c, 1.0);
      }
    }
    out[static_cast<long long>(y) * W0 + x] = v;
  }
}

dim3 row_grid(int row_items, int rows) {
  return dim3((row_items + kThreads - 1) / kThreads,
              rows < kMaxRowBlocks ? rows : kMaxRowBlocks);
}

}  // namespace

// slide (H0, W0, 3) uint8, tops (n_h,) and lefts (n_w,) int32 with every
// patch inside the slide, out (n_rows, H, W, 3) float32; h <= H, w <= W,
// n_real <= n_rows.  Returns the cudaError_t of the launch.
extern "C" int wesup_tile_cut(const void* slide, const void* tops,
                              const void* lefts, void* out, int W0, int n_w,
                              int first, int n_real, int n_rows, int h, int w,
                              int H, int W, void* stream) {
  if (n_rows < 1 || H < 1 || W < 1 || h < 1 || h > H || w < 1 || w > W ||
      n_real < 0 || n_real > n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cut_kernel<<<row_grid(W * 3, n_rows * H), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(slide), static_cast<const int*>(tops),
      static_cast<const int*>(lefts), static_cast<float*>(out), W0, n_w,
      first, n_real, n_rows, h, w, H, W);
  return static_cast<int>(cudaGetLastError());
}

// probs (n_h * n_w, h, w) float32 (dtype 0) or uint8 (dtype 1), tops (n_h,)
// and lefts (n_w,) int32, out (H0, W0) float64.  to_even rounds float32
// values half to even.  Returns the cudaError_t of the launch.
extern "C" int wesup_tile_stitch(const void* probs, const void* tops,
                                 const void* lefts, void* out, int H0, int W0,
                                 int n_h, int n_w, int h, int w, int dtype,
                                 int to_even, void* stream) {
  if (H0 < 1 || W0 < 1 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = row_grid(W0, H0);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int*>(tops);
  const auto* l = static_cast<const int*>(lefts);
  auto* o = static_cast<double*>(out);
  if (dtype == 0) {
    stitch_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(probs), t, l, o, H0, W0, n_h, n_w, h, w,
        to_even != 0);
  } else if (dtype == 1) {
    stitch_kernel<unsigned char><<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(probs), t, l, o, H0, W0, n_h, n_w,
        h, w, false);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
