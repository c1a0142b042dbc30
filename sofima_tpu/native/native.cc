// Native host-side kernels for sofima_tpu.
//
// The device compute path is JAX/XLA; these C++ routines cover the
// *host* hot paths that the reference delegated to native libraries
// (edt, OpenCV, connectomics C ops):
//   * exact 2d Euclidean distance transform (Felzenszwalb & Huttenlocher
//     separable lower-envelope algorithm) — tile-blending weights
//   * uint64 -> dense relabeling for segmentation warping
//   * multithreaded bilinear remap — CPU fallback rendering path
//
// Exposed with a plain C ABI for ctypes binding (no pybind11 needed).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

// 1d squared distance transform of a sampled function f (lower envelope
// of parabolas), after Felzenszwalb & Huttenlocher (2012).
void dt1d(const float* f, float* d, int* v, float* z, int n) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; ++q) {
    if (f[q] == kInf) continue;
    float s;
    while (true) {
      int p = v[k];
      if (f[p] == kInf) {
        // Previous vertex never contributes; drop it.
        if (k == 0) {
          v[0] = q;
          z[0] = -kInf;
          z[1] = kInf;
          s = -kInf;
          break;
        }
        --k;
        continue;
      }
      s = ((f[q] + q * (float)q) - (f[p] + p * (float)p)) / (2.0f * (q - p));
      if (s <= z[k]) {
        if (k == 0) {
          v[0] = q;
          z[0] = -kInf;
          z[1] = kInf;
          break;
        }
        --k;
      } else {
        ++k;
        v[k] = q;
        z[k] = s;
        z[k + 1] = kInf;
        break;
      }
    }
  }
  // Handle the all-inf row.
  if (f[v[0]] == kInf) {
    for (int q = 0; q < n; ++q) d[q] = kInf;
    return;
  }
  int k2 = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k2 + 1] < q) ++k2;
    int p = v[k2];
    float dq = q - (float)p;
    d[q] = dq * dq + f[p];
  }
}

void parallel_for(int n, int num_threads, const std::function<void(int)>& fn) {
  if (num_threads <= 1 || n < 2) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  int workers = std::min(num_threads, n);
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&]() {
      while (true) {
        int i = next.fetch_add(1);
        if (i >= n) break;
        fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Exact 2d EDT. mask: [h, w] uint8, nonzero = inside. out: [h, w] float32
// distances to the nearest zero pixel (black border optional).
void sofima_edt2d(const uint8_t* mask, float* out, int h, int w,
                  int black_border, int num_threads) {
  std::vector<float> g((size_t)h * w);

  // Pass 1: per-column 1d squared distances along y.
  parallel_for(w, num_threads, [&](int x) {
    std::vector<float> f(h), d(h), z(h + 1);
    std::vector<int> v(h);
    for (int y = 0; y < h; ++y)
      f[y] = mask[(size_t)y * w + x] ? kInf : 0.0f;
    dt1d(f.data(), d.data(), v.data(), z.data(), h);
    if (black_border) {
      for (int y = 0; y < h; ++y) {
        float b0 = (float)(y + 1);
        float b1 = (float)(h - y);
        float bd = std::min(b0, b1);
        d[y] = std::min(d[y], bd * bd);
      }
    }
    for (int y = 0; y < h; ++y) g[(size_t)y * w + x] = d[y];
  });

  // Pass 2: per-row lower envelope along x.
  parallel_for(h, num_threads, [&](int y) {
    std::vector<float> f(w), d(w), z(w + 1);
    std::vector<int> v(w);
    for (int x = 0; x < w; ++x) f[x] = g[(size_t)y * w + x];
    dt1d(f.data(), d.data(), v.data(), z.data(), w);
    for (int x = 0; x < w; ++x) {
      float val = d[x];
      if (black_border) {
        float b0 = (float)(x + 1);
        float b1 = (float)(w - x);
        float bd = std::min(b0, b1);
        val = std::min(val, bd * bd);
      }
      out[(size_t)y * w + x] =
          (val == kInf) ? kInf : std::sqrt(val);
    }
  });
}

// Maps uint64 ids to their index within the sorted unique-id array
// (ids must be sorted ascending). Binary search per voxel, threaded.
void sofima_relabel(const uint64_t* data, const uint64_t* sorted_ids,
                    int64_t n_ids, int32_t* out, int64_t n,
                    int num_threads) {
  int64_t chunk = std::max<int64_t>((n + num_threads - 1) /
                                    std::max(num_threads, 1), 1);
  int blocks = (int)((n + chunk - 1) / chunk);
  parallel_for(blocks, num_threads, [&](int b) {
    int64_t lo = (int64_t)b * chunk;
    int64_t hi = std::min(lo + chunk, n);
    for (int64_t i = lo; i < hi; ++i) {
      const uint64_t* it =
          std::lower_bound(sorted_ids, sorted_ids + n_ids, data[i]);
      out[i] = (int32_t)(it - sorted_ids);
    }
  });
}

// Bilinear remap: out[i] = img(sample_y[i], sample_x[i]); outside -> cval.
void sofima_remap_bilinear(const float* img, int h, int w,
                           const float* sy, const float* sx, float* out,
                           int64_t n, float cval, int num_threads) {
  int64_t chunk = std::max<int64_t>((n + num_threads - 1) /
                                    std::max(num_threads, 1), 1);
  int blocks = (int)((n + chunk - 1) / chunk);
  parallel_for(blocks, num_threads, [&](int b) {
    int64_t lo = (int64_t)b * chunk;
    int64_t hi = std::min(lo + chunk, n);
    for (int64_t i = lo; i < hi; ++i) {
      float y = sy[i], x = sx[i];
      if (!(y >= 0.0f) || !(x >= 0.0f) || y > h - 1 || x > w - 1) {
        out[i] = cval;
        continue;
      }
      int y0 = (int)y, x0 = (int)x;
      int y1 = std::min(y0 + 1, h - 1), x1 = std::min(x0 + 1, w - 1);
      float fy = y - y0, fx = x - x0;
      float v00 = img[(size_t)y0 * w + x0];
      float v01 = img[(size_t)y0 * w + x1];
      float v10 = img[(size_t)y1 * w + x0];
      float v11 = img[(size_t)y1 * w + x1];
      out[i] = (1 - fy) * ((1 - fx) * v00 + fx * v01) +
               fy * ((1 - fx) * v10 + fx * v11);
    }
  });
}

}  // extern "C"
