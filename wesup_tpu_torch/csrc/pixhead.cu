// The pixel head after fc2, for Hopper (sm_90a).  Built by
// wesup_tpu_torch/native with nvcc into the kernels' shared library; the
// wrapper is wesup_tpu_torch/ops/pixhead.py::head.
//
// It replaces no pallas_call: the JAX package leaves the head's tail to XLA
// (wesup_tpu/models/wesup.py:_mlp_head, lines 156-169), which fuses it.  On
// the card the port ran it as PyTorch ops, which read fc2's (N, C) output
// three times (the bias add, the ReLU, fc3) and wrote it twice more.
//
// wesup_pixel_head  from z (N, C), fc2's output before its bias, and the
// parameters in T: b2 (C,), W3 (D, C), b3 (D,), Wc (n, D), bc (n,),
//       a[k]  = relu(T(z[k] + b2[k]))
//       f[d]  = T(sum_k a[k] * W3[d, k])          (an f32 sum)
//       g[d]  = relu(T(f[d] + b3[d]))
//       l[c]  = T(T(sum_d g[d] * Wc[c, d]) + bc[c])  (an f32 sum)
//       out   = softmax(l) in f32                 (N, n) float32
//     per row: the composition's rounding points; every add of two T values
//     converts both to f32, adds and rounds to nearest even, as PyTorch does.
//     Only the order of the f32 sums differs from the composition's.
//
// What bounds it on the H100: bytes.  At the tile cell's chunk (N = 8 x 416
// x 416, C = 1024, bf16) it reads z once, 2.835 GB (0.846 ms at 3.35 TB/s),
// and writes 8 bytes a row (11 MB).  fc3 is 90.7 GFLOP a chunk: on the CUDA
// cores (67 TFLOP/s in f32) that alone would take longer than the bytes, so
// in bf16 it runs on the tensor cores.
//
// Design (bf16): a persistent grid, one block of up to 16 warps per SM.  A
// warp owns a tile of 16 rows at a time and walks it in chunks of 64
// columns; cp.async streams each chunk (2 KB) into the warp's own ring of
// four shared-memory stages, evict-first, three chunks ahead, and the ring
// runs on across the warp's tiles.  Each thread copies exactly the bytes it
// later reads, so the ring needs no barrier.  The thread applies b2 and the
// ReLU as it forms its mma.sync m16n8k16 A fragments; W3 sits in shared
// memory (64 KB at C = 1024) in fragment order, so a warp's B fragments are
// 512 contiguous bytes.  The columns are permuted inside each chunk: a
// thread's two 16-byte pieces of a row are its A fragments for the chunk's
// four k-steps, and W3 is laid out with the same permutation, so the sum is
// over the same pairs.  Then fc3's bias and ReLU, the classifier (each of
// the row's four threads sums its eight features, two shuffles finish the
// sum) and the softmax run in registers, and each row writes n floats.
// The f32 kernel tiles 128 rows by 32 features through shared memory with
// f32 FMAs (no TF32), in order over k, and shares the per-row tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxD = 32;      // fc3's width, at most (four n8 tiles)
constexpr int kMaxClasses = 4;
constexpr int kChunk = 64;     // columns of a chunk (bf16 kernel)
constexpr int kStages = 4;     // shared-memory stages of a warp's ring
constexpr int kMaxWarps = 16;
constexpr int kTileRows = 16;
constexpr int kStageBytes = kTileRows * kChunk * 2;   // 2 KB
constexpr int kSmemLimit = 232448;                    // 227 KB

struct Params {
  const void* z;
  const void* b2;
  const void* w3;
  const void* b3;
  const void* wc;
  const void* bc;
  float* out;
  long long N;
  int C, D, n;
};

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// fc3's bias, the classifier's weight and bias as f32 values of T, zero
// past D and n, in shared memory
struct Tail {
  float b3[kMaxD];
  float wc[kMaxClasses][kMaxD];
  float bc[kMaxClasses];
};

template <typename T>
__device__ void load_tail(const Params& p, Tail* t) {
  for (int i = threadIdx.x; i < kMaxD; i += blockDim.x) {
    t->b3[i] = i < p.D ? to_f32(static_cast<const T*>(p.b3)[i]) : 0.f;
  }
  for (int i = threadIdx.x; i < kMaxClasses * kMaxD; i += blockDim.x) {
    const int c = i / kMaxD, d = i - c * kMaxD;
    t->wc[c][d] = c < p.n && d < p.D
                      ? to_f32(static_cast<const T*>(p.wc)[c * p.D + d])
                      : 0.f;
  }
  for (int i = threadIdx.x; i < kMaxClasses; i += blockDim.x) {
    t->bc[i] = i < p.n ? to_f32(static_cast<const T*>(p.bc)[i]) : 0.f;
  }
}

// The tail of one row, run by the row's four threads together (lanes 4q..
// 4q+3, q the lane's index t = lane & 3): f[i] is fc3's f32 sum of feature
// d(i) = 8 (i / 2) + 2 t + i % 2.  Returns the row's probabilities in prob.
template <typename T>
__device__ __forceinline__ void row_tail(const float (&f)[8], int t,
                                         const Tail& s, int n,
                                         float (&prob)[kMaxClasses]) {
  float l[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) l[c] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = 8 * (i / 2) + 2 * t + i % 2;
    float g = round_to<T>(round_to<T>(f[i]) + s.b3[d]);
    g = g < 0.f ? 0.f : g;  // relu; NaN stays NaN
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) l[c] = fmaf(g, s.wc[c][d], l[c]);
  }
  // (t0 + t1) + (t2 + t3), the same bits on all four lanes
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) {
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 1);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 2);
  }
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) {
    l[c] = round_to<T>(round_to<T>(l[c]) + s.bc[c]);
  }
  float m = l[0];
#pragma unroll
  for (int c = 1; c < kMaxClasses; ++c) {
    if (c < n) m = fmaxf(m, l[c]);
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) {
    prob[c] = c < n ? expf(l[c] - m) : 0.f;
    sum += prob[c];
  }
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) prob[c] = prob[c] / sum;
}

__device__ __forceinline__ void store_row(const Params& p, long long row,
                                          const float (&prob)[kMaxClasses]) {
  if (row >= p.N) return;
  float* o = p.out + row * p.n;
  if (p.n == 2) {
    __stcs(reinterpret_cast<float2*>(o), make_float2(prob[0], prob[1]));
    return;
  }
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) {
    if (c < p.n) o[c] = prob[c];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// relu(T(z + b)) of a bf16 pair, every add in f32
__device__ __forceinline__ unsigned bias_relu(unsigned z, unsigned b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(bf16_lo(z) + bf16_lo(b),
                                                 bf16_hi(z) + bf16_hi(b));
  const __nv_bfloat162 r =
      __hmax2_nan(v, __floats2bfloat162_rn(0.f, 0.f));  // NaN stays NaN
  return *reinterpret_cast<const unsigned*>(&r);
}

// The 16-byte piece (row r of a tile, half h, thread t) of a stage: eight
// pieces a row, the halves swapped on odd rows so that the eight threads of
// a quarter warp (two rows) read eight distinct bank groups
__device__ __forceinline__ int piece(int r, int h, int t) {
  return r * 8 + ((h ^ (r & 1)) * 4 + t);
}

// the warp's next chunk to copy: tile and chunk index, advanced in order
struct Cursor {
  long long tile;
  int kc;
};

__device__ __forceinline__ void advance(Cursor& c, int nkc, long long stride) {
  if (++c.kc == nkc) {
    c.kc = 0;
    c.tile += stride;
  }
}

// copy chunk (c.tile, c.kc) of this thread's rows g and g + 8 into a stage
// (zeros past N and past C); nothing past the last tile, but a group all
// the same, so that every wait counts the same groups
__device__ __forceinline__ void fetch(const Params& p, const Cursor& c,
                                      long long n_tiles, unsigned stage,
                                      int g, int t, uint64_t policy) {
  if (c.tile < n_tiles) {
    const auto* z = static_cast<const __nv_bfloat16*>(p.z);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = g + 8 * rr;
      const long long row = c.tile * kTileRows + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c.kc * kChunk + h * 32 + t * 8;
        const bool in = row < p.N && col < p.C;
        const void* src = in ? z + row * p.C + col : p.z;
        cp_async16(stage + piece(r, h, t) * 16, src, in ? 16 : 0, policy);
      }
    }
  }
  cp_commit();
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    pixel_head_bf16(const Params p, int nkc, long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  // W3 in fragment order: (chunk, n tile j, half h, lane) -> 16 bytes
  auto* s_w3 = reinterpret_cast<uint4*>(smem);
  auto* s_b2 = reinterpret_cast<uint4*>(smem + nkc * 4096);   // nkc * 64 bf16
  auto* s_tail = reinterpret_cast<Tail*>(smem + nkc * 4224);
  unsigned char* ring = smem + nkc * 4224 + sizeof(Tail);
  ring += (16 - reinterpret_cast<uintptr_t>(ring) % 16) % 16;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const unsigned my_ring = smem_addr(ring + warp * kStages * kStageBytes);
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));

  const long long stride = static_cast<long long>(gridDim.x) * warps;
  Cursor next{static_cast<long long>(blockIdx.x) * warps + warp, 0};
  Cursor cur = next;
  // the first chunks' copies run while the block fills W3 and the tails
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    fetch(p, next, n_tiles, my_ring + s * kStageBytes, g, t, policy);
    advance(next, nkc, stride);
  }

  const auto* w3 = static_cast<const uint4*>(p.w3);
  for (int i = threadIdx.x; i < nkc * 256; i += blockDim.x) {
    const int l = i % 32, h = (i / 32) % 2, j = (i / 64) % 4, kc = i / 256;
    const int d = 8 * j + l / 4, col = kc * kChunk + h * 32 + (l % 4) * 8;
    s_w3[i] = d < p.D && col < p.C ? w3[(d * p.C + col) / 8]
                                   : make_uint4(0, 0, 0, 0);
  }
  const auto* b2 = static_cast<const uint4*>(p.b2);
  for (int i = threadIdx.x; i < nkc * 8; i += blockDim.x) {
    s_b2[i] = i * 8 < p.C ? b2[i] : make_uint4(0, 0, 0, 0);
  }
  load_tail<__nv_bfloat16>(p, s_tail);
  __syncthreads();

  int slot = 0;  // the stage of chunk `cur`
  while (cur.tile < n_tiles) {
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    for (int kc = 0; kc < nkc; ++kc) {
      // refill the stage freed by the previous chunk, then wait for this one
      fetch(p, next, n_tiles,
            my_ring + ((slot + kStages - 1) % kStages) * kStageBytes, g, t,
            policy);
      advance(next, nkc, stride);
      cp_wait<kStages - 1>();
      const unsigned char* st = ring + (warp * kStages + slot) * kStageBytes;
      // a[rr][h]: rows g and g + 8, halves 0 and 1 (eight columns each)
      uint4 a[2][2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[rr][h] = *reinterpret_cast<const uint4*>(
              st + piece(g + 8 * rr, h, t) * 16);
        }
      }
      unsigned w[2][8];  // rows g, g + 8: eight bias-added, relu'd pairs
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 b = s_b2[kc * 8 + h * 4 + t];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          w[rr][4 * h + 0] = bias_relu(a[rr][h].x, b.x);
          w[rr][4 * h + 1] = bias_relu(a[rr][h].y, b.y);
          w[rr][4 * h + 2] = bias_relu(a[rr][h].z, b.z);
          w[rr][4 * h + 3] = bias_relu(a[rr][h].w, b.w);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 q0 = s_w3[((kc * 4 + j) * 2 + 0) * 32 + lane];
        const uint4 q1 = s_w3[((kc * 4 + j) * 2 + 1) * 32 + lane];
        const unsigned bw[8] = {q0.x, q0.y, q0.z, q0.w,
                                q1.x, q1.y, q1.z, q1.w};
        // k-step s takes pairs 2s and 2s + 1 of both the rows and W3
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const unsigned fa[4] = {w[0][2 * s], w[1][2 * s], w[0][2 * s + 1],
                                  w[1][2 * s + 1]};
          mma_bf16(acc[j], fa, bw[2 * s], bw[2 * s + 1]);
        }
      }
      slot = (slot + 1) % kStages;
    }
    // acc[j]: (g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, ...), (g + 8, ...)
    const float f0[8] = {acc[0][0], acc[0][1], acc[1][0], acc[1][1],
                         acc[2][0], acc[2][1], acc[3][0], acc[3][1]};
    const float f1[8] = {acc[0][2], acc[0][3], acc[1][2], acc[1][3],
                         acc[2][2], acc[2][3], acc[3][2], acc[3][3]};
    float p0[kMaxClasses], p1[kMaxClasses];
    row_tail<__nv_bfloat16>(f0, t, *s_tail, p.n, p0);
    row_tail<__nv_bfloat16>(f1, t, *s_tail, p.n, p1);
    const long long row0 = cur.tile * kTileRows + g;
    if (t == 0) store_row(p, row0, p0);
    if (t == 1) store_row(p, row0 + 8, p1);
    cur.tile += stride;
  }
  cp_wait<0>();
}

int launch_bf16(const Params& p, cudaStream_t s) {
  const int nkc = (p.C + kChunk - 1) / kChunk;
  const size_t fixed = static_cast<size_t>(nkc) * 4224 + sizeof(Tail) + 16;
  if (fixed + kStages * kStageBytes > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int warps = static_cast<int>(
      std::min<size_t>(kMaxWarps, (kSmemLimit - fixed) / (kStages *
                                                          kStageBytes)));
  const size_t smem = fixed + static_cast<size_t>(warps) * kStages *
                                  kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      pixel_head_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, pixel_head_bf16, warps * 32, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long n_tiles = (p.N + kTileRows - 1) / kTileRows;
  const long long blocks = std::min<long long>(
      static_cast<long long>(sms) * std::max(per_sm, 1),
      (n_tiles + warps - 1) / warps);
  pixel_head_bf16<<<static_cast<unsigned>(blocks), warps * 32, smem, s>>>(
      p, nkc, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: FMAs
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 128;   // rows of a block
constexpr int kF32K = 32;       // columns of a step
constexpr int kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
    pixel_head_f32(const Params p) {
  __shared__ float s_a[kF32K][kF32Rows + 1];  // relu(z + b2), transposed
  __shared__ __align__(16) float s_w[kF32K][kMaxD];  // W3^T, thread order
  __shared__ Tail s_tail;
  const int t = threadIdx.x % 4, rg = threadIdx.x / 4;   // rows rg, rg + 64
  const long long row0 = static_cast<long long>(blockIdx.x) * kF32Rows;
  const auto* z = static_cast<const float*>(p.z);
  const auto* b2 = static_cast<const float*>(p.b2);
  const auto* w3 = static_cast<const float*>(p.w3);
  load_tail<float>(p, &s_tail);

  float acc[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }
  for (int k0 = 0; k0 < p.C; k0 += kF32K) {
    for (int i = threadIdx.x; i < kF32Rows * kF32K; i += kF32Threads) {
      const int r = i / kF32K, k = i % kF32K;
      const long long row = row0 + r;
      float v = 0.f;
      if (row < p.N && k0 + k < p.C) {
        v = z[row * p.C + k0 + k] + b2[k0 + k];
        v = v < 0.f ? 0.f : v;  // relu; NaN stays NaN
      }
      s_a[k][r] = v;
    }
    for (int i = threadIdx.x; i < kMaxD * kF32K; i += kF32Threads) {
      const int d = i % kMaxD, k = i / kMaxD;
      // feature d is thread (d % 8) / 2's value 2 (d / 8) + d % 2
      s_w[k][(d % 8) / 2 * 8 + 2 * (d / 8) + d % 2] =
          d < p.D && k0 + k < p.C ? w3[d * p.C + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kF32K; ++k) {
      const float a0 = s_a[k][rg], a1 = s_a[k][rg + 64];
      const float4 wl = *reinterpret_cast<const float4*>(&s_w[k][t * 8]);
      const float4 wh = *reinterpret_cast<const float4*>(&s_w[k][t * 8 + 4]);
      const float wv[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[0][i] = fmaf(a0, wv[i], acc[0][i]);
        acc[1][i] = fmaf(a1, wv[i], acc[1][i]);
      }
    }
    __syncthreads();
  }
  float p0[kMaxClasses], p1[kMaxClasses];
  row_tail<float>(acc[0], t, s_tail, p.n, p0);
  row_tail<float>(acc[1], t, s_tail, p.n, p1);
  if (t == 0) store_row(p, row0 + rg, p0);
  if (t == 1) store_row(p, row0 + rg + 64, p1);
}

int launch_f32(const Params& p, cudaStream_t s) {
  const long long blocks = (p.N + kF32Rows - 1) / kF32Rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pixel_head_f32<<<static_cast<unsigned>(blocks), kF32Threads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z (N, C); b2 (C,); w3 (D, C); b3 (D,); wc (n, D); bc (n,); all contiguous
// in T (dtype 0 = float32, 1 = bfloat16); out (N, n) float32.  1 <= D <= 32,
// 1 <= n <= 4; in bf16, C % 8 == 0 and z and w3 16-byte aligned.  Returns the
// cudaError_t of the launch.
extern "C" int wesup_pixel_head(const void* z, const void* b2, const void* w3,
                                const void* b3, const void* wc, const void* bc,
                                void* out, long long N, int C, int D, int n,
                                int dtype, void* stream) {
  const Params p{z, b2, w3, b3, wc, bc, static_cast<float*>(out), N, C, D, n};
  if (N < 1 || C < 1 || D < 1 || D > kMaxD || n < 1 || n > kMaxClasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(p, s);
  if (dtype != 1 || C % 8 != 0 ||
      reinterpret_cast<uintptr_t>(z) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w3) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_bf16(p, s);
}
