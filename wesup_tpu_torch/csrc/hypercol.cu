// The pixel head's hypercolumn upsample, for Hopper (sm_90a).  Built by
// wesup_tpu_torch/ops/_build.py with nvcc into the shared library that also
// holds csrc/cellpool.cu; the wrapper is
// wesup_tpu_torch/ops/hypercol.py::upsample.
//
// It replaces no pallas_call: the JAX package contracts dense matrices for
// this step (wesup_tpu/ops/resize.py: resize_w_only's einsum per stage, then
// fused_upsample_sum's one contraction of the stacked H-interpolation
// matrices with the concatenated maps), and XLA fuses what follows.  The port
// added it because on the card that composition moved 5.5 GB of
// concatenated maps and multiplied them by a matrix whose rows hold 9
// non-zeros of 806.
//
// wesup_hypercol_upsample  from the five projected stage maps P_0 (B, H, W, C)
//     and P_s (B, H_s, W_s, C), s = 1..4, and the (C,) bias, all in T:
//       Wr_s[h, x] = T(aw0_s[x] * P_s[h, x0_s(x)] + aw1_s[x] * P_s[h, x1_s(x)])
//       z[y, x]    = T(P_0[y, x] + sum_s ah0_s[y] * Wr_s[h0_s(y), x]
//                                      + ah1_s[y] * Wr_s[h1_s(y), x])
//       out[y, x]  = relu(T(z[y, x] + bias))
//     per image and channel, every sum in f32.  The taps (x0, x1, h0, h1)
//     and weights are the two entries of each row of the align-corners
//     interpolation matrices, the weights already rounded to T, so T rounds
//     where resize_w_only, fused_upsample_sum, the bias add and the ReLU
//     round.  The only difference from that composition is the order of the
//     f32 sum in z: 9 terms here, 806 (most of them exact zeros) there.
//
// What bounds it on the H100: bytes.  At the tile cell's chunk (B = 8,
// 416 x 416, C = 1024, bf16) it reads P_0 (2.83 GB) and P_1..P_4 (0.94 GB)
// and writes the map (2.83 GB): 6.61 GB, 1.97 ms at 3.35 TB/s; about 25
// f32 operations a value.
//
// Design: each needed byte is read once.  A thread owns one 16-byte vector
// of channels (8 bf16 or 4 f32; one channel when C or an address does not
// allow it) at one column x, so neighbouring threads read and write
// neighbouring addresses, and walks a band of output rows of one image
// (blockIdx.z the image, blockIdx.y the band).  It streams P_0 in, two
// rows ahead, and the map out with evict-first loads and stores.
// Neighbouring output rows share their source rows, so it keeps each
// stage's two W-resized source rows in registers (a bf16 pair to a 32-bit
// word, 32 registers in all) and computes a new one only when the band's
// rows move past it: about two 16-byte reads of the low-resolution maps an
// output vector, served from L2.  The band's row taps sit in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 4;     // the low-resolution stages 1..4
constexpr int kMaxRows = 128;  // output rows of a band, at most

struct Params {
  const void* p0;
  const void* ps[kStages];
  const void* bias;
  const int2* xidx;  // (kStages, W): x0, x1
  const float2* xw;  // (kStages, W): aw0, aw1
  const int2* yidx;  // (kStages, H): h0, h1
  const float2* yw;  // (kStages, H): ah0, ah1
  void* out;
  int H, W, C, rows;
  int hs[kStages], ws[kStages];
};

// V values of T in 32-bit words, a bf16 pair to a word, as they are
// loaded, kept in registers and stored; V = 1 is scalar
template <typename T, int V>
struct Lanes {
  static constexpr int kWords = (V * sizeof(T) + 3) / 4;
  unsigned w[kWords];
};

// ONCE: evict-first, for P_0 and the map, which pass through once and
// should not push the low-resolution maps out of L2
template <typename T, int V, bool ONCE>
__device__ __forceinline__ Lanes<T, V> load(const T* p) {
  Lanes<T, V> l;
  if constexpr (V * sizeof(T) == 16) {
    const auto* q = reinterpret_cast<const uint4*>(p);
    const uint4 u = ONCE ? __ldcs(q) : __ldg(q);
    l.w[0] = u.x;
    l.w[1] = u.y;
    l.w[2] = u.z;
    l.w[3] = u.w;
  } else if constexpr (sizeof(T) == 4) {
    l.w[0] = *reinterpret_cast<const unsigned*>(p);
  } else {
    l.w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
  return l;
}

template <typename T, int V>
__device__ __forceinline__ void store_once(T* p, const Lanes<T, V>& l) {
  if constexpr (V * sizeof(T) == 16) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(l.w[0], l.w[1], l.w[2], l.w[3]));
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<unsigned*>(p) = l.w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(l.w[0]);
  }
}

// value k of the lanes, exactly, in f32
template <typename T, int V>
__device__ __forceinline__ float lane(const Lanes<T, V>& l, int k) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(l.w[k]);
  } else {
    const unsigned u = l.w[k / 2];
    return __uint_as_float(k % 2 ? u & 0xffff0000u : u << 16);
  }
}

// f32 values rounded to T (to nearest even), as lanes
template <typename T, int V>
__device__ __forceinline__ Lanes<T, V> to_lanes(const float* f) {
  Lanes<T, V> l;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < V; ++k) l.w[k] = __float_as_uint(f[k]);
  } else if constexpr (V == 1) {
    l.w[0] = __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  } else {
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      l.w[j] = static_cast<unsigned>(__bfloat16_as_ushort(h.x)) |
               static_cast<unsigned>(__bfloat16_as_ushort(h.y)) << 16;
    }
  }
  return l;
}

// x rounded to T (to nearest even), in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 4) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// Wr_s at source row h for this thread's column and channels
template <typename T, int V, int S>
__device__ __forceinline__ Lanes<T, V> w_resize(const Params& p, int b, int h,
                                                int x, int c) {
  const int2 xi = p.xidx[S * p.W + x];
  const float2 aw = p.xw[S * p.W + x];
  const T* row = static_cast<const T*>(p.ps[S]) +
                 (static_cast<long long>(b) * p.hs[S] + h) * p.ws[S] * p.C +
                 c;
  const auto a = load<T, V, false>(row + static_cast<long long>(xi.x) * p.C);
  const auto e = load<T, V, false>(row + static_cast<long long>(xi.y) * p.C);
  float f[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    f[k] = fmaf(aw.y, lane(e, k), aw.x * lane(a, k));
  }
  return to_lanes<T, V>(f);
}

// stage S's two W-resized source rows for output row r of the band, kept
// from the rows before where they are the same; returns their weights
template <typename T, int V, int S>
__device__ __forceinline__ float2 stage_rows(const Params& p,
                                             const int2* s_hi,
                                             const float2* s_ah, int r, int b,
                                             int x, int c, int (&h_at)[2],
                                             Lanes<T, V> (&row)[2]) {
  const int2 h = s_hi[S * kMaxRows + r];
  if (h.x != h_at[0]) {
    row[0] = h.x == h_at[1] ? row[1] : w_resize<T, V, S>(p, b, h.x, x, c);
    h_at[0] = h.x;
  }
  if (h.y != h_at[1]) {
    row[1] = h.y == h.x ? row[0] : w_resize<T, V, S>(p, b, h.y, x, c);
    h_at[1] = h.y;
  }
  return s_ah[S * kMaxRows + r];
}

template <typename T, int V>
__device__ __forceinline__ float add_rows(float z, float2 a,
                                          const Lanes<T, V> (&row)[2], int k) {
  return fmaf(a.y, lane(row[1], k), fmaf(a.x, lane(row[0], k), z));
}

// The bf16 kernel is held to 80 registers, so that an SM keeps six blocks
// (768 threads) and enough loads in flight: uncapped it took 110 and four
// blocks, 3.35 ms at the tile cell's chunk on an H100 against 2.99 capped.
// The f32 one runs fastest uncapped (96 registers).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 6 : 1)
    hypercol_upsample_kernel(const Params p) {
  __shared__ int2 s_hi[kStages * kMaxRows];
  __shared__ float2 s_ah[kStages * kMaxRows];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * p.rows;
  const int ny = min(p.rows, p.H - y0);
  for (int i = threadIdx.x; i < kStages * ny; i += kThreads) {
    const int s = i / ny, r = i - s * ny;
    s_hi[s * kMaxRows + r] = p.yidx[s * p.H + y0 + r];
    s_ah[s * kMaxRows + r] = p.yw[s * p.H + y0 + r];
  }
  __syncthreads();
  const int n_vec = p.C / V;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(p.W) * n_vec) return;
  const int x = static_cast<int>(t / n_vec);
  const int c = static_cast<int>(t - static_cast<long long>(x) * n_vec) * V;

  const auto bias = load<T, V, false>(static_cast<const T*>(p.bias) + c);
  const long long row_stride = static_cast<long long>(p.W) * p.C;
  const long long at = (static_cast<long long>(b) * p.H + y0) * row_stride +
                       static_cast<long long>(x) * p.C + c;
  const T* src = static_cast<const T*>(p.p0) + at;
  T* dst = static_cast<T*>(p.out) + at;

  int h1[2] = {-1, -1}, h2[2] = {-1, -1}, h3[2] = {-1, -1}, h4[2] = {-1, -1};
  Lanes<T, V> w1[2], w2[2], w3[2], w4[2];
  // P_0 two rows ahead
  Lanes<T, V> cur = load<T, V, true>(src), next = cur;
  if (ny > 1) next = load<T, V, true>(src + row_stride);
  for (int r = 0; r < ny; ++r) {
    Lanes<T, V> after = next;
    if (r + 2 < ny) after = load<T, V, true>(src + (r + 2) * row_stride);
    const float2 a1 = stage_rows<T, V, 0>(p, s_hi, s_ah, r, b, x, c, h1, w1);
    const float2 a2 = stage_rows<T, V, 1>(p, s_hi, s_ah, r, b, x, c, h2, w2);
    const float2 a3 = stage_rows<T, V, 2>(p, s_hi, s_ah, r, b, x, c, h3, w3);
    const float2 a4 = stage_rows<T, V, 3>(p, s_hi, s_ah, r, b, x, c, h4, w4);
    // each value's sum in the composition's order, then its roundings
    float out[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float z = lane(cur, k);
      z = add_rows(z, a1, w1, k);
      z = add_rows(z, a2, w2, k);
      z = add_rows(z, a3, w3, k);
      z = add_rows(z, a4, w4, k);
      const float v = round_to<T>(round_to<T>(z) + lane(bias, k));
      out[k] = v < 0.f ? 0.f : v;  // relu; NaN stays NaN
    }
    store_once<T, V>(dst + r * row_stride, to_lanes<T, V>(out));
    cur = next;
    next = after;
  }
}

template <typename T, int V>
int launch(const Params& p, int B, cudaStream_t s) {
  const long long items = static_cast<long long>(p.W) * (p.C / V);
  const long long blocks = (items + kThreads - 1) / kThreads;
  const int bands = (p.H + p.rows - 1) / p.rows;
  if (blocks > 0x7fffffffLL || bands > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  hypercol_upsample_kernel<T, V>
      <<<dim3(static_cast<unsigned>(blocks), bands, B), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int B, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  bool vec = p.C % V == 0 && reinterpret_cast<size_t>(p.p0) % 16 == 0 &&
             reinterpret_cast<size_t>(p.bias) % 16 == 0 &&
             reinterpret_cast<size_t>(p.out) % 16 == 0;
  for (int i = 0; i < kStages; ++i) {
    vec = vec && reinterpret_cast<size_t>(p.ps[i]) % 16 == 0;
  }
  if (vec) return launch<T, V>(p, B, s);
  return launch<T, 1>(p, B, s);
}

}  // namespace

// p0 (B, H, W, C); p1..p4 (B, h_s, w_s, C); bias (C,); out (B, H, W, C); all
// in T (dtype 0 = float32, 1 = bfloat16).  xidx (4, W, 2) and yidx (4, H, 2)
// int32 hold each output column's and row's two source columns and rows in
// stages 1..4, xw and yw (same shapes, float32) their weights.  rows: output
// rows a block walks, 1..128.  Returns the cudaError_t of the launch.
extern "C" int wesup_hypercol_upsample(
    const void* p0, const void* p1, const void* p2, const void* p3,
    const void* p4, const void* bias, const void* xidx, const void* xw,
    const void* yidx, const void* yw, void* out, int B, int H, int W, int C,
    int h1, int h2, int h3, int h4, int w1, int w2, int w3, int w4, int dtype,
    int rows, void* stream) {
  Params p{p0,
           {p1, p2, p3, p4},
           bias,
           static_cast<const int2*>(xidx),
           static_cast<const float2*>(xw),
           static_cast<const int2*>(yidx),
           static_cast<const float2*>(yw),
           out,
           H,
           W,
           C,
           rows,
           {h1, h2, h3, h4},
           {w1, w2, w3, w4}};
  if (B < 1 || H < 1 || W < 1 || C < 1 || rows < 1 || rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < kStages; ++i) {
    if (p.hs[i] < 1 || p.ws[i] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
