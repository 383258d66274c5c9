// dls_native — native (C++) host data-plane kernels of the port.
//
// The port's copy of the JAX package's csrc/dls_native.cc, line for line in
// its arithmetic, so that both packages give the same bytes from the same
// images. These kernels run on the host, not on the card: image
// augmentation (crop, flip, resize, normalize) and a host-side reduction
// that would otherwise serialize on the Python GIL inside the input
// pipeline.
//
// Exposed as a plain C ABI consumed via ctypes (see utils/native.py). All
// kernels release the GIL by construction (ctypes drops it around foreign
// calls) and parallelize via parallel_for below.
//
// Layout conventions match the Python pipeline: images are HWC uint8 or
// float32, batches are NHWC; normalize output is (x/255 - mean)/std float32
// (vision.py normalize()); resize is the same half-pixel-center bilinear as
// vision.py resize_bilinear().

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

int default_threads() {
  unsigned hc = std::thread::hardware_concurrency();
  int nt = hc ? static_cast<int>(std::min(hc, 16u)) : 4;
  // DLS_NATIVE_THREADS caps per-call fan-out DOWNWARD only (same semantics
  // as dls_jpeg.cc; read per call, not cached: a forked input-pipeline
  // worker sets it to 1 AFTER the fork so N worker processes don't each
  // spawn hardware_concurrency threads — N×HC runnable threads on HC cores
  // measured ~35% slower than N×1 on the 2-core CI box).
  if (const char* env = std::getenv("DLS_NATIVE_THREADS")) {
    int v = std::atoi(env);
    if (v > 0 && v < nt) nt = v;
  }
  return nt;
}

// Parallel-for over [0, n): per-call thread spawn with dynamic (atomic)
// work claiming. Per-call spawn keeps the kernels trivially reentrant —
// ctypes releases the GIL, so the prefetch background thread and the main
// thread may invoke kernels concurrently; a shared persistent pool would
// need cross-call synchronization to be safe for that.
void parallel_for(int64_t n, const std::function<void(int64_t)>& fn) {
  if (n <= 0) return;
  int nt = std::min<int64_t>(default_threads(), n);
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next{0};
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

inline float u8_to_unit(uint8_t v) { return static_cast<float>(v) * (1.0f / 255.0f); }

// One image: crop at (y0,x0) size (ch,cw), optional horizontal flip, then
// (x/255 - mean)/std. in: HWC uint8, out: ch*cw*C float32.
void crop_flip_normalize_one(const uint8_t* in, int h, int w, int c,
                             int y0, int x0, int ch, int cw, int flip,
                             const float* mean, const float* inv_std,
                             float* out) {
  (void)h;
  for (int y = 0; y < ch; ++y) {
    const uint8_t* row = in + (static_cast<int64_t>(y0 + y) * w + x0) * c;
    float* orow = out + static_cast<int64_t>(y) * cw * c;
    if (!flip) {
      for (int x = 0; x < cw; ++x)
        for (int k = 0; k < c; ++k)
          orow[x * c + k] = (u8_to_unit(row[x * c + k]) - mean[k]) * inv_std[k];
    } else {
      for (int x = 0; x < cw; ++x)
        for (int k = 0; k < c; ++k)
          orow[(cw - 1 - x) * c + k] =
              (u8_to_unit(row[x * c + k]) - mean[k]) * inv_std[k];
    }
  }
}

}  // namespace

extern "C" {

int dls_version() { return 1; }

int dls_num_threads() { return default_threads(); }

// Batch fused augment: N images, each cropped at (ys[i], xs[i]) to (ch, cw),
// flipped when flips[i], normalized. in: [N,H,W,C] u8 → out: [N,ch,cw,C] f32.
void dls_crop_flip_normalize_batch(const uint8_t* in, int64_t n, int h, int w,
                                   int c, const int32_t* ys, const int32_t* xs,
                                   const uint8_t* flips, int ch, int cw,
                                   const float* mean, const float* std,
                                   float* out) {
  std::vector<float> inv_std(c);
  for (int k = 0; k < c; ++k) inv_std[k] = 1.0f / std[k];
  const int64_t in_stride = static_cast<int64_t>(h) * w * c;
  const int64_t out_stride = static_cast<int64_t>(ch) * cw * c;
  // Parallelize over (image, row-group) so n=1 calls (the per-example
  // transform path) still use every core, not just batch-level callers.
  const int kRowGroup = 32;
  const int64_t groups_per_img = (ch + kRowGroup - 1) / kRowGroup;
  parallel_for(n * groups_per_img, [&](int64_t g) {
    const int64_t i = g / groups_per_img;
    const int y0 = static_cast<int>(g % groups_per_img) * kRowGroup;
    const int rows = std::min(kRowGroup, ch - y0);
    crop_flip_normalize_one(in + i * in_stride, h, w, c, ys[i] + y0, xs[i],
                            rows, cw, flips[i], mean, inv_std.data(),
                            out + i * out_stride +
                                static_cast<int64_t>(y0) * cw * c);
  });
}

// Batch normalize without crop/flip: [N,H,W,C] u8 → f32, (x/255 - mean)/std.
void dls_normalize_u8_batch(const uint8_t* in, int64_t n, int h, int w, int c,
                            const float* mean, const float* std, float* out) {
  std::vector<int32_t> zeros(static_cast<size_t>(n), 0);
  std::vector<uint8_t> noflip(static_cast<size_t>(n), 0);
  dls_crop_flip_normalize_batch(in, n, h, w, c, zeros.data(), zeros.data(),
                                noflip.data(), h, w, mean, std, out);
}

// Bilinear resize, half-pixel centers, edge-clamped — the exact math of
// vision.py resize_bilinear so native/numpy paths are interchangeable.
// in: [H,W,C] f32 → out: [OH,OW,C] f32. Parallel over output rows.
void dls_resize_bilinear(const float* in, int h, int w, int c, int oh, int ow,
                         float* out) {
  // source coordinates in double, matching numpy's float64 — float32 here
  // could floor() to a different pixel near integer boundaries on large
  // images, breaking native/numpy interchangeability
  std::vector<int> x0s(ow), x1s(ow);
  std::vector<float> wxs(ow);
  for (int x = 0; x < ow; ++x) {
    double src = (static_cast<double>(x) + 0.5) * w / ow - 0.5;
    int x0 = std::clamp(static_cast<int>(std::floor(src)), 0, w - 1);
    x0s[x] = x0;
    x1s[x] = std::min(x0 + 1, w - 1);
    wxs[x] = static_cast<float>(std::clamp(src - static_cast<double>(x0), 0.0, 1.0));
  }
  parallel_for(oh, [&](int64_t y) {
    double src = (static_cast<double>(y) + 0.5) * h / oh - 0.5;
    int y0 = std::clamp(static_cast<int>(std::floor(src)), 0, h - 1);
    int y1 = std::min(y0 + 1, h - 1);
    float wy = static_cast<float>(std::clamp(src - static_cast<double>(y0), 0.0, 1.0));
    const float* top = in + static_cast<int64_t>(y0) * w * c;
    const float* bot = in + static_cast<int64_t>(y1) * w * c;
    float* orow = out + y * ow * c;
    for (int x = 0; x < ow; ++x) {
      const float wx = wxs[x];
      const float* tl = top + x0s[x] * c;
      const float* tr = top + x1s[x] * c;
      const float* bl = bot + x0s[x] * c;
      const float* br = bot + x1s[x] * c;
      for (int k = 0; k < c; ++k) {
        float t = tl[k] * (1.0f - wx) + tr[k] * wx;
        float b = bl[k] * (1.0f - wx) + br[k] * wx;
        orow[x * c + k] = t * (1.0f - wy) + b * wy;
      }
    }
  });
}

// Fused random-resized-crop: crop (y0,x0,ch,cw) of a uint8 HWC image,
// bilinear-resize the crop to (oh,ow) (half-pixel centers, edge-clamped
// within the crop), optional horizontal flip, then (x/255 - mean)/std —
// all in one pass with no float intermediate image. Interpolating raw u8
// then scaling is the same linear map as scaling-then-interpolating, so
// this matches the Python crop→resize→normalize chain to fp rounding.
// Parallel over output rows.
void dls_rrc_flip_normalize(const uint8_t* in, int h, int w, int c,
                            int y0, int x0, int ch, int cw, int flip,
                            int oh, int ow, const float* mean,
                            const float* std, float* out) {
  (void)h;
  std::vector<float> inv_std(c);
  for (int k = 0; k < c; ++k) inv_std[k] = (1.0f / 255.0f) / std[k];
  std::vector<float> bias(c);
  for (int k = 0; k < c; ++k) bias[k] = mean[k] * 255.0f;
  std::vector<int> x0s(ow), x1s(ow);
  std::vector<float> wxs(ow);
  for (int x = 0; x < ow; ++x) {
    double src = (static_cast<double>(x) + 0.5) * cw / ow - 0.5;
    int cx0 = std::clamp(static_cast<int>(std::floor(src)), 0, cw - 1);
    x0s[x] = x0 + cx0;
    x1s[x] = x0 + std::min(cx0 + 1, cw - 1);
    // weight relative to the CLAMPED tap — same convention as
    // dls_resize_bilinear / vision.resize_bilinear
    wxs[x] = static_cast<float>(std::clamp(src - static_cast<double>(cx0), 0.0, 1.0));
  }
  parallel_for(oh, [&](int64_t y) {
    double src = (static_cast<double>(y) + 0.5) * ch / oh - 0.5;
    int cy0 = std::clamp(static_cast<int>(std::floor(src)), 0, ch - 1);
    int cy1 = std::min(cy0 + 1, ch - 1);
    float wy = static_cast<float>(
        std::clamp(src - static_cast<double>(cy0), 0.0, 1.0));
    const uint8_t* top = in + (static_cast<int64_t>(y0 + cy0) * w) * c;
    const uint8_t* bot = in + (static_cast<int64_t>(y0 + cy1) * w) * c;
    float* orow = out + y * ow * c;
    for (int x = 0; x < ow; ++x) {
      const float wx = wxs[x];
      const uint8_t* tl = top + x0s[x] * c;
      const uint8_t* tr = top + x1s[x] * c;
      const uint8_t* bl = bot + x0s[x] * c;
      const uint8_t* br = bot + x1s[x] * c;
      const int xo = flip ? (ow - 1 - x) : x;
      for (int k = 0; k < c; ++k) {
        float t = tl[k] * (1.0f - wx) + tr[k] * wx;
        float b = bl[k] * (1.0f - wx) + br[k] * wx;
        orow[xo * c + k] = (t * (1.0f - wy) + b * wy - bias[k]) * inv_std[k];
      }
    }
  });
}

// Batched fused random-resized-crop over VARIABLE-SIZE images (the record
// input path: shorter-side-resized uint8 frames of differing aspect).
// One call augments a whole batch — per-image crop regions/flips sampled by
// the caller (content-seeded rng stays in Python), pixels move here:
// crop → bilinear resize → flip → normalize, PARALLEL OVER IMAGES (column
// taps computed once per image; training batches ≥ core count keep every
// core busy — sub-core-count batches underfill, an accepted trade for the
// tap reuse). No GIL churn, no per-image ctypes overhead, and output is
// written directly into the caller's [N, OH, OW, C] batch buffer — the
// batch never passes through a separate np.stack copy.
void dls_rrc_flip_normalize_varbatch(
    const void* const* imgs, const int32_t* hs, const int32_t* ws, int c,
    const int32_t* ys, const int32_t* xs, const int32_t* chs,
    const int32_t* cws, const uint8_t* flips, int64_t n, int oh, int ow,
    const float* mean, const float* std, float* out) {
  const int64_t out_stride = static_cast<int64_t>(oh) * ow * c;
  std::vector<float> inv_std(c), bias(c);
  for (int k = 0; k < c; ++k) {
    inv_std[k] = (1.0f / 255.0f) / std[k];
    bias[k] = mean[k] * 255.0f;
  }
  // Parallel over IMAGES (a 256-image batch keeps ≤16 threads saturated);
  // column taps are computed once per image, not per row.
  parallel_for(n, [&](int64_t i) {
    const uint8_t* in = static_cast<const uint8_t*>(imgs[i]);
    const int w = ws[i], ch = chs[i], cw = cws[i];
    const int y0 = ys[i], x0 = xs[i];
    const int flip = flips[i];
    float* obase = out + i * out_stride;
    std::vector<int> tx0(ow), tx1(ow);
    std::vector<float> wxs(ow);
    for (int x = 0; x < ow; ++x) {
      double srcx = (static_cast<double>(x) + 0.5) * cw / ow - 0.5;
      int cx0 = std::clamp(static_cast<int>(std::floor(srcx)), 0, cw - 1);
      tx0[x] = (x0 + cx0) * c;
      tx1[x] = (x0 + std::min(cx0 + 1, cw - 1)) * c;
      wxs[x] = static_cast<float>(
          std::clamp(srcx - static_cast<double>(cx0), 0.0, 1.0));
    }
    for (int y = 0; y < oh; ++y) {
      double srcy = (static_cast<double>(y) + 0.5) * ch / oh - 0.5;
      int cy0 = std::clamp(static_cast<int>(std::floor(srcy)), 0, ch - 1);
      int cy1 = std::min(cy0 + 1, ch - 1);
      float wy = static_cast<float>(
          std::clamp(srcy - static_cast<double>(cy0), 0.0, 1.0));
      const uint8_t* top = in + (static_cast<int64_t>(y0 + cy0) * w) * c;
      const uint8_t* bot = in + (static_cast<int64_t>(y0 + cy1) * w) * c;
      float* orow = obase + static_cast<int64_t>(y) * ow * c;
      for (int x = 0; x < ow; ++x) {
        const float wx = wxs[x];
        const uint8_t* tl = top + tx0[x];
        const uint8_t* tr = top + tx1[x];
        const uint8_t* bl = bot + tx0[x];
        const uint8_t* br = bot + tx1[x];
        const int xo = flip ? (ow - 1 - x) : x;
        for (int k = 0; k < c; ++k) {
          float t = tl[k] * (1.0f - wx) + tr[k] * wx;
          float b = bl[k] * (1.0f - wx) + br[k] * wx;
          orow[xo * c + k] =
              (t * (1.0f - wy) + b * wy - bias[k]) * inv_std[k];
        }
      }
    }
  });
}

// dst += src elementwise — the host gradient-aggregation primitive.
// Parallel over chunks.
void dls_sum_into_f32(float* dst, const float* src, int64_t n) {
  constexpr int64_t kChunk = 1 << 16;
  int64_t chunks = (n + kChunk - 1) / kChunk;
  parallel_for(chunks, [&](int64_t ci) {
    int64_t lo = ci * kChunk, hi = std::min(n, lo + kChunk);
    for (int64_t i = lo; i < hi; ++i) dst[i] += src[i];
  });
}

}  // extern "C"
