// Fused ReLU + 2x2/2 max pool + channel zero-pad, kernel K7 of the WESUP
// port, for Hopper (sm_90a).  Built by wesup_tpu_torch/ops/_build.py with
// nvcc into the shared library that also holds csrc/cellpool.cu; the
// wrapper is wesup_tpu_torch/ops/pool.py::fused_relu_pool_pad.
//
// K7  fused_relu_pool_pad  replaces wesup_tpu/ops/pool_pallas.py::
//                          fused_relu_pool_pad (Pallas _kernel via _impl,
//                          pallas_call at :121):
//       out[b, i, j, c] = relu(max(pre[b, 2i + di, 2j + dj, c]))  for c < C,
//                         0                                       for c >= C,
// pre (B, H, W, C) NHWC, out (B, H/2, W/2, Cout) NHWC, f32 or bf16; VALID
// pooling drops an odd last row or column.
//
// What bounds it on the H100: bytes.  It reads the stage-1 tap once (123 MB
// at B=8, 288x416, 64 channels, bf16) and writes the pooled, widened tensor
// once (61 MB at 128 channels), with three compares per output value.  The
// TPU kernel folded each W-pair into the lane dimension and rolled it to
// take the pair's max without gathers, Mosaic's layout constraints; a GPU
// thread simply reads the four window vectors.
//
// Design (simple): one thread per output 16-byte vector (8 bf16 or 4 f32
// channels; one channel when C, Cout or an address does not allow it),
// grid-stride.  A thread whose channels lie below C reads the window's four
// vectors (neighbouring threads read neighbouring addresses), applies relu
// to each value and keeps the first maximum in window order, with a NaN
// winning as in max_pool2d, so the result equals relu -> max_pool2d; a
// thread above C writes zeros.  Pure selections: no rounding anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

// relu, then max_pool2d's update rule "val > maxval || isnan(val)"
__device__ __forceinline__ float relu(float x) {
  return (x > 0.f || isnan(x)) ? x : 0.f;
}
__device__ __forceinline__ float pool4(float a, float b, float c, float d) {
  float m = relu(a);
  const float r[3] = {relu(b), relu(c), relu(d)};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (r[i] > m || isnan(r[i])) m = r[i];
  }
  return m;
}

// V values of T as one load / store; V = 1 is scalar
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float x, float* d) { *d = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* d) {
  *d = __float2bfloat16_rn(x);  // exact: x is one of the bf16 inputs or 0
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    relu_pool_pad_kernel(const T* __restrict__ pre, T* __restrict__ out,
                         int H, int W, int C, int Ho, int Wo, int Cout,
                         long long n_items) {
  const int n_vec = Cout / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n_items; t += stride) {
    const long long pix = t / n_vec;  // (b * Ho + i) * Wo + j
    const int c = static_cast<int>(t - pix * n_vec) * V;
    const int j = static_cast<int>(pix % Wo);
    const long long bi = pix / Wo;
    const int i = static_cast<int>(bi % Ho);
    const long long b = bi / Ho;
    Vec<T, V> res;
    if (c < C) {
      const T* p00 = pre + ((b * H + 2 * i) * W + 2 * j) * C + c;
      const T* p10 = p00 + static_cast<size_t>(W) * C;
      const Vec<T, V> x00 = load<T, V>(p00), x01 = load<T, V>(p00 + C);
      const Vec<T, V> x10 = load<T, V>(p10), x11 = load<T, V>(p10 + C);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        from_f32(pool4(to_f32(x00.v[k]), to_f32(x01.v[k]), to_f32(x10.v[k]),
                       to_f32(x11.v[k])),
                 &res.v[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) from_f32(0.f, &res.v[k]);
    }
    *reinterpret_cast<Vec<T, V>*>(out + pix * Cout + c) = res;
  }
}

template <typename T, int V>
int launch(const void* pre, void* out, int B, int H, int W, int C, int Cout,
           cudaStream_t s) {
  const int Ho = H / 2, Wo = W / 2;
  const long long n_items = static_cast<long long>(B) * Ho * Wo * (Cout / V);
  const long long want = (n_items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1 << 30) ? want : (1 << 30));
  if (blocks == 0) return 0;
  relu_pool_pad_kernel<T, V><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(pre), static_cast<T*>(out), H, W, C, Ho, Wo, Cout,
      n_items);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* pre, void* out, int B, int H, int W, int C, int Cout,
             cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = C % V == 0 && Cout % V == 0 &&
                   reinterpret_cast<size_t>(pre) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  if (vec) return launch<T, V>(pre, out, B, H, W, C, Cout, s);
  return launch<T, 1>(pre, out, B, H, W, C, Cout, s);
}

}  // namespace

// pre (B, H, W, C) and out (B, H / 2, W / 2, Cout) NHWC in T, Cout >= C.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int wesup_fused_relu_pool_pad(const void* pre, void* out, int B,
                                         int H, int W, int C, int Cout,
                                         int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (Cout < C) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch<float>(pre, out, B, H, W, C, Cout, s);
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(pre, out, B, H, W, C, Cout, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
