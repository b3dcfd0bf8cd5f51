// Native image preprocessing for the PyTorch port of GlimpsePrune.
//
// A copy of native/gp_preproc.cpp, kept in the port so that its build reads
// nothing outside glimpseprune_torch/. Resize + normalize + patchify in one
// pass per output patch row, behind a plain C ABI for ctypes: the port's
// images of any size are preprocessed without PIL.
//
// Resize matches PIL's bicubic convention: a = -0.5 Keys kernel, support 2,
// separable, with the same half-pixel center mapping PIL uses.
//
// Built at first use by glimpseprune_torch/preprocessing/native.py with
// g++ -O3 -fPIC -shared -std=c++17 (no -march=native: the same results on
// any x86-64 host) into build/glimpseprune_torch/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double bicubic_weight(double x) {
  // Keys cubic, a = -0.5 (PIL's BICUBIC filter)
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precomputed sampling plan for one output axis (PIL-style).
struct AxisPlan {
  std::vector<int> start;        // first source index per output position
  std::vector<int> size;         // taps per output position
  std::vector<double> weights;   // flattened [out, max_taps]
  int max_taps = 0;
};

AxisPlan make_plan(int in_size, int out_size) {
  AxisPlan plan;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;  // bicubic support = 2
  plan.max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  plan.start.resize(out_size);
  plan.size.resize(out_size);
  plan.weights.assign(static_cast<size_t>(out_size) * plan.max_taps, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    double* w = &plan.weights[static_cast<size_t>(xx) * plan.max_taps];
    double total = 0.0;
    for (int i = 0; i < n; ++i) {
      const double ww = bicubic_weight((xmin + i - center + 0.5) / filterscale);
      w[i] = ww;
      total += ww;
    }
    if (total != 0.0) {
      for (int i = 0; i < n; ++i) w[i] /= total;
    }
    plan.start[xx] = xmin;
    plan.size[xx] = n;
  }
  return plan;
}

inline uint8_t clip8(double v) {
  if (v <= 0.0) return 0;
  if (v >= 255.0) return 255;
  return static_cast<uint8_t>(v + 0.5);
}

}  // namespace

extern "C" {

// Bicubic resize uint8 HWC -> uint8 HWC (PIL-compatible two-pass).
void gp_resize_bicubic(const uint8_t* img, int h, int w, int c,
                       uint8_t* out, int th, int tw) {
  AxisPlan xplan = make_plan(w, tw);
  AxisPlan yplan = make_plan(h, th);

  // horizontal pass: [h, tw, c] (keep f64 intermediates like PIL's 2-pass u8)
  std::vector<double> tmp(static_cast<size_t>(h) * tw * c);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = img + static_cast<size_t>(y) * w * c;
    for (int x = 0; x < tw; ++x) {
      const double* wts = &xplan.weights[static_cast<size_t>(x) * xplan.max_taps];
      const int x0 = xplan.start[x];
      const int n = xplan.size[x];
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int i = 0; i < n; ++i) acc += row[(x0 + i) * c + ch] * wts[i];
        tmp[(static_cast<size_t>(y) * tw + x) * c + ch] = acc;
      }
    }
  }
  // vertical pass
  for (int y = 0; y < th; ++y) {
    const double* wts = &yplan.weights[static_cast<size_t>(y) * yplan.max_taps];
    const int y0 = yplan.start[y];
    const int n = yplan.size[y];
    for (int x = 0; x < tw; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int i = 0; i < n; ++i)
          acc += tmp[(static_cast<size_t>(y0 + i) * tw + x) * c + ch] * wts[i];
        out[(static_cast<size_t>(y) * tw + x) * c + ch] = clip8(acc);
      }
    }
  }
}

// Normalize + merge-block patchify: uint8 HWC (already resized) ->
// float32 patches [grid_h*grid_w, c*tps*ps*ps] in Qwen2.5-VL row order
// (preprocessing/image.py patchify_image semantics, temporal frame repeated).
void gp_normalize_patchify(const uint8_t* img, int h, int w, int c,
                           const float* mean, const float* stdv,
                           int ps, int tps, int merge,
                           float* out) {
  const int grid_h = h / ps;
  const int grid_w = w / ps;
  const int row_len = c * tps * ps * ps;
  // patch row ordering: (gh_block, gw_block, merge_y, merge_x) raster;
  // within a row: (c, t, py, px)
  int patch_idx = 0;
  for (int bh = 0; bh < grid_h / merge; ++bh) {
    for (int bw = 0; bw < grid_w / merge; ++bw) {
      for (int my = 0; my < merge; ++my) {
        for (int mx = 0; mx < merge; ++mx) {
          const int gy = bh * merge + my;
          const int gx = bw * merge + mx;
          float* dst = out + static_cast<size_t>(patch_idx) * row_len;
          for (int ch = 0; ch < c; ++ch) {
            const float m = mean[ch];
            const float s = 1.0f / stdv[ch];
            for (int t = 0; t < tps; ++t) {       // repeated temporal frame
              for (int py = 0; py < ps; ++py) {
                const uint8_t* src =
                    img + (static_cast<size_t>(gy * ps + py) * w + gx * ps) * c + ch;
                for (int px = 0; px < ps; ++px) {
                  *dst++ = (src[px * c] * (1.0f / 255.0f) - m) * s;
                }
              }
            }
          }
          ++patch_idx;
        }
      }
    }
  }
}

// Fused pipeline: resize (if needed) + normalize + patchify.
void gp_preprocess(const uint8_t* img, int h, int w, int c,
                   int th, int tw,
                   const float* mean, const float* stdv,
                   int ps, int tps, int merge,
                   float* out_patches) {
  if (h == th && w == tw) {
    gp_normalize_patchify(img, h, w, c, mean, stdv, ps, tps, merge, out_patches);
    return;
  }
  std::vector<uint8_t> resized(static_cast<size_t>(th) * tw * c);
  gp_resize_bicubic(img, h, w, c, resized.data(), th, tw);
  gp_normalize_patchify(resized.data(), th, tw, c, mean, stdv, ps, tps, merge,
                        out_patches);
}

}  // extern "C"
