// Native host-side kernels for WESUP-TPU.
//
// The reference leans on third-party native code (skimage's Cython CCL,
// scipy's O(|S|*|G|) directed_hausdorff) for its offline evaluation
// (utils/metrics.py:49-281).  These replacements are in-repo and faster:
//
//  - ccl_label:     two-pass union-find connected components labeling,
//                   8-connectivity (skimage.measure.label semantics)
//  - edt:           exact Euclidean distance transform
//                   (Felzenszwalb & Huttenlocher), O(N)
//  - hausdorff:     symmetric Hausdorff via two EDTs, O(N) instead of
//                   scipy's pairwise point-set scan
//  - flip_small_regions: CCL + size filter in one pass
//                   (scripts/evaluate_glas.py:29-42 postprocess)
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
// Large FINITE sentinel for "no point in this row/col" — true infinity makes
// the lower-envelope intersection s = (inf - inf)/... NaN/-inf and underflows
// the envelope index.  1e20 dwarfs any squared pixel distance.
constexpr float kFar = 1e20f;

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  }
};

// 1-D squared distance transform (lower envelope of parabolas).
void dt1d(const float* f, float* d, int n, std::vector<int>& v,
          std::vector<float>& z) {
  v.resize(n);
  z.resize(n + 1);
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; ++q) {
    float s;
    while (true) {
      int p = v[k];
      s = ((f[q] + q * q) - (f[p] + p * p)) / (2.0f * q - 2.0f * p);
      if (s <= z[k]) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    int p = v[k];
    d[q] = (q - p) * (q - p) + f[p];
  }
}

}  // namespace

extern "C" {

// 8-connectivity CCL.  mask: h*w uint8 (nonzero = foreground).
// out: h*w int32 labels (0 = background, 1..n components).  Returns n.
int32_t ccl_label(const uint8_t* mask, int32_t h, int32_t w, int32_t* out) {
  const int64_t n = static_cast<int64_t>(h) * w;
  std::vector<int32_t> provisional(n, 0);
  UnionFind uf(1);
  int32_t next = 1;
  uf.parent.reserve(1024);

  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t idx = static_cast<int64_t>(y) * w + x;
      if (!mask[idx]) continue;
      // neighbors already visited in raster order: W, NW, N, NE
      int32_t neigh[4];
      int cnt = 0;
      if (x > 0 && mask[idx - 1]) neigh[cnt++] = provisional[idx - 1];
      if (y > 0) {
        const int64_t up = idx - w;
        if (x > 0 && mask[up - 1]) neigh[cnt++] = provisional[up - 1];
        if (mask[up]) neigh[cnt++] = provisional[up];
        if (x + 1 < w && mask[up + 1]) neigh[cnt++] = provisional[up + 1];
      }
      if (cnt == 0) {
        provisional[idx] = next++;
        uf.parent.push_back(static_cast<int32_t>(uf.parent.size()));
      } else {
        int32_t m = neigh[0];
        for (int i = 1; i < cnt; ++i) m = std::min(m, neigh[i]);
        provisional[idx] = m;
        for (int i = 0; i < cnt; ++i) uf.unite(m, neigh[i]);
      }
    }
  }

  // flatten + relabel compactly
  std::vector<int32_t> remap(next, 0);
  int32_t n_labels = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i]) {
      out[i] = 0;
      continue;
    }
    int32_t root = uf.find(provisional[i]);
    if (remap[root] == 0) remap[root] = ++n_labels;
    out[i] = remap[root];
  }
  return n_labels;
}

// Exact squared EDT of the COMPLEMENT of mask: out[i] = squared distance
// from pixel i to the nearest nonzero pixel of mask (0 on the mask itself).
void edt_sq(const uint8_t* mask, int32_t h, int32_t w, float* out) {
  const int64_t n = static_cast<int64_t>(h) * w;
  std::vector<float> f(std::max(h, w));
  std::vector<float> d(std::max(h, w));
  std::vector<int> v;
  std::vector<float> z;

  for (int64_t i = 0; i < n; ++i) out[i] = mask[i] ? 0.0f : kFar;

  // columns
  for (int32_t x = 0; x < w; ++x) {
    for (int32_t y = 0; y < h; ++y) f[y] = out[static_cast<int64_t>(y) * w + x];
    dt1d(f.data(), d.data(), h, v, z);
    for (int32_t y = 0; y < h; ++y) out[static_cast<int64_t>(y) * w + x] = d[y];
  }
  // rows
  for (int32_t y = 0; y < h; ++y) {
    float* row = out + static_cast<int64_t>(y) * w;
    std::memcpy(f.data(), row, sizeof(float) * w);
    dt1d(f.data(), d.data(), w, v, z);
    std::memcpy(row, d.data(), sizeof(float) * w);
  }
}

// Symmetric Hausdorff distance between the nonzero sets of a and b.
// Returns -1 if both empty handled by caller; inf if exactly one empty.
double hausdorff_dist(const uint8_t* a, const uint8_t* b, int32_t h, int32_t w) {
  const int64_t n = static_cast<int64_t>(h) * w;
  bool any_a = false, any_b = false;
  for (int64_t i = 0; i < n && !(any_a && any_b); ++i) {
    any_a |= a[i] != 0;
    any_b |= b[i] != 0;
  }
  if (!any_a && !any_b) return 0.0;
  if (!any_a || !any_b) return std::numeric_limits<double>::infinity();

  std::vector<float> dist(n);
  double best = 0.0;
  edt_sq(b, h, w, dist.data());  // distance to B
  for (int64_t i = 0; i < n; ++i)
    if (a[i] && dist[i] > best) best = dist[i];
  edt_sq(a, h, w, dist.data());  // distance to A
  for (int64_t i = 0; i < n; ++i)
    if (b[i] && dist[i] > best) best = dist[i];
  return std::sqrt(best);
}

// Flip foreground regions smaller than threshold to background, then holes
// smaller than threshold to foreground.  In place on uint8 mask (0/1).
void flip_small_regions(uint8_t* mask, int32_t h, int32_t w,
                        int64_t threshold) {
  const int64_t n = static_cast<int64_t>(h) * w;
  std::vector<int32_t> labels(n);
  std::vector<int64_t> sizes;

  for (int pass = 0; pass < 2; ++pass) {
    const uint8_t target = pass == 0 ? 1 : 0;
    std::vector<uint8_t> sel(n);
    for (int64_t i = 0; i < n; ++i) sel[i] = mask[i] == target;
    int32_t k = ccl_label(sel.data(), h, w, labels.data());
    sizes.assign(k + 1, 0);
    for (int64_t i = 0; i < n; ++i) ++sizes[labels[i]];
    for (int64_t i = 0; i < n; ++i) {
      if (labels[i] > 0 && sizes[labels[i]] < threshold)
        mask[i] = 1 - target;
    }
  }
}

}  // extern "C"
