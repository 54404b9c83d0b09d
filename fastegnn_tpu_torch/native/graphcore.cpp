// graphcore: host-side graph construction for the port (counterpart of
// fastegnn_tpu/native/graphcore.cpp, without its TPU packer and its
// comparison sort).  A plain shared library with a C interface, built with
// g++ on first use and bound with ctypes (fastegnn_tpu_torch/native).
//
//   - radius_graph: uniform cell-list neighbour search, O(N * neighbours);
//     emits both directions of every pair with 0 < d^2 < r^2 (f32), no
//     self loops, in the cell walk's order;
//   - counting_argsort: stable argsort of small-range int32 keys,
//     O(n + n_bins), out-of-range keys last;
//   - bincount: per-key counts as f32, out-of-range keys dropped.
//
// The semantics and the emission order are the JAX package's, so both
// packages build the same graphs.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Count and emit the edges (i, j) with 0 < |x_i - x_j|^2 < r^2.  Two-phase:
// first call with out_dst == nullptr for the count, then with buffers of
// that capacity.  Returns the number of directed edges, -1 if the capacity
// is short.
int64_t radius_graph(const float* loc, int64_t n, float r,
                     int32_t* out_dst, int32_t* out_src,
                     int64_t capacity) {
  if (n <= 0) return 0;
  float min_c[3] = {loc[0], loc[1], loc[2]};
  float max_c[3] = {loc[0], loc[1], loc[2]};
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      const float v = loc[i * 3 + d];
      min_c[d] = std::min(min_c[d], v);
      max_c[d] = std::max(max_c[d], v);
    }
  }
  const float cell = std::max(r, 1e-12f);
  int64_t dims[3];
  for (int d = 0; d < 3; ++d) {
    dims[d] = std::max<int64_t>(
        1, static_cast<int64_t>((max_c[d] - min_c[d]) / cell) + 1);
    dims[d] = std::min<int64_t>(dims[d], 1 << 20);
  }
  const int64_t n_cells = dims[0] * dims[1] * dims[2];

  auto cell_of = [&](int64_t i, int64_t* c) {
    for (int d = 0; d < 3; ++d) {
      int64_t k = static_cast<int64_t>((loc[i * 3 + d] - min_c[d]) / cell);
      c[d] = std::min(std::max<int64_t>(k, 0), dims[d] - 1);
    }
  };

  // counting-sort the points into cells
  std::vector<int64_t> cell_id(n), head(n_cells + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    int64_t c[3];
    cell_of(i, c);
    cell_id[i] = (c[0] * dims[1] + c[1]) * dims[2] + c[2];
    head[cell_id[i] + 1]++;
  }
  std::partial_sum(head.begin(), head.end(), head.begin());
  std::vector<int64_t> order(n), cursor(head.begin(), head.end() - 1);
  for (int64_t i = 0; i < n; ++i) order[cursor[cell_id[i]]++] = i;

  const float r2 = r * r;
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t c[3];
    cell_of(i, c);
    for (int64_t dx = -1; dx <= 1; ++dx) {
      const int64_t cx = c[0] + dx;
      if (cx < 0 || cx >= dims[0]) continue;
      for (int64_t dy = -1; dy <= 1; ++dy) {
        const int64_t cy = c[1] + dy;
        if (cy < 0 || cy >= dims[1]) continue;
        for (int64_t dz = -1; dz <= 1; ++dz) {
          const int64_t cz = c[2] + dz;
          if (cz < 0 || cz >= dims[2]) continue;
          const int64_t cc = (cx * dims[1] + cy) * dims[2] + cz;
          for (int64_t p = head[cc]; p < head[cc + 1]; ++p) {
            const int64_t j = order[p];
            if (j == i) continue;
            const float ddx = loc[i * 3] - loc[j * 3];
            const float ddy = loc[i * 3 + 1] - loc[j * 3 + 1];
            const float ddz = loc[i * 3 + 2] - loc[j * 3 + 2];
            // the fused multiply-adds g++ makes of dx^2 + dy^2 + dz^2 on
            // an FMA host, written out so that every host rounds alike
            const float d2 = std::fma(ddz, ddz, std::fma(ddx, ddx, ddy * ddy));
            if (d2 < r2 && d2 > 0.0f) {
              if (out_dst != nullptr) {
                if (count >= capacity) return -1;
                out_dst[count] = static_cast<int32_t>(i);
                out_src[count] = static_cast<int32_t>(j);
              }
              ++count;
            }
          }
        }
      }
    }
  }
  return count;
}

// Stable counting argsort for keys in [0, n_bins): O(n + n_bins).
// Out-of-range keys sort last (stable among themselves).
void counting_argsort(const int32_t* keys, int64_t n, int64_t n_bins,
                      int32_t* out_perm) {
  std::vector<int64_t> off(n_bins + 2, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t k = keys[i];
    const int64_t b = (k >= 0 && k < n_bins) ? k : n_bins;
    ++off[b + 1];
  }
  for (int64_t b = 0; b <= n_bins; ++b) off[b + 1] += off[b];
  for (int64_t i = 0; i < n; ++i) {
    const int32_t k = keys[i];
    const int64_t b = (k >= 0 && k < n_bins) ? k : n_bins;
    out_perm[off[b]++] = static_cast<int32_t>(i);
  }
}

// out_counts[k] = the number of keys equal to k, for k in [0, n_bins);
// other keys are ignored.
void bincount(const int32_t* keys, int64_t n, int64_t n_bins,
              float* out_counts) {
  for (int64_t i = 0; i < n_bins; ++i) out_counts[i] = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t k = keys[i];
    if (k >= 0 && k < n_bins) out_counts[k] += 1.0f;
  }
}

}  // extern "C"
