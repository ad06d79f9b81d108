// Serial reference-semantics oracle for snesimage.
//
// A from-spec C++ reimplementation of the reference pipeline's per-pixel
// scan semantics (aexoden/snesimage src/lib.rs:425-501 `optimize`,
// src/lib.rs:762-795 `get_closest_color_index`, src/lib.rs:1080-1100
// distance functions), in f64 like the original. It exists so the batched
// JAX ops (parallel argmin remap, wavefront dither scan, vectorized
// CIEDE2000) can be validated against an independent scalar implementation
// in tests. Built with g++ and loaded via ctypes (see
// snesimage/native.py).
//
// This is NOT on the production compute path.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// 5-bit -> 8-bit channel expansion: c*8 + c/4 (src/lib.rs:662-669).
inline int expand5(int c) { return c * 8 + c / 4; }

// Red-mean weighted distance (src/lib.rs:1080-1088).
double red_mean_distance(const int c1[3], const int c2[3]) {
  double red_mean = (static_cast<double>(c1[0]) + c2[0]) / 2.0;
  double r = static_cast<double>(c1[0]) - c2[0];
  double g = static_cast<double>(c1[1]) - c2[1];
  double b = static_cast<double>(c1[2]) - c2[2];
  return std::sqrt(((512.0 + red_mean) * r * r) / 256.0 + 4.0 * g * g +
                   ((767.0 - red_mean) * b * b) / 256.0);
}

// sRGB u8 -> CIELAB (D65), same constants as the `palette` crate.
void srgb_to_lab(const int rgb[3], double lab[3]) {
  double lin[3];
  for (int i = 0; i < 3; ++i) {
    double c = rgb[i] / 255.0;
    lin[i] = (c <= 0.04045) ? c / 12.92 : std::pow((c + 0.055) / 1.055, 2.4);
  }
  const double m[3][3] = {{0.4124564, 0.3575761, 0.1804375},
                          {0.2126729, 0.7151522, 0.0721750},
                          {0.0193339, 0.1191920, 0.9503041}};
  const double wp[3] = {0.95047, 1.0, 1.08883};
  double f[3];
  for (int i = 0; i < 3; ++i) {
    double v = (m[i][0] * lin[0] + m[i][1] * lin[1] + m[i][2] * lin[2]) / wp[i];
    const double d = 6.0 / 29.0;
    f[i] = (v > d * d * d) ? std::cbrt(v) : v / (3 * d * d) + 4.0 / 29.0;
  }
  lab[0] = 116.0 * f[1] - 16.0;
  lab[1] = 500.0 * (f[0] - f[1]);
  lab[2] = 200.0 * (f[1] - f[2]);
}

constexpr double kPi = 3.14159265358979323846;
inline double deg2rad(double d) { return d * kPi / 180.0; }
inline double rad2deg(double r) { return r * 180.0 / kPi; }

// CIEDE2000 (Sharma et al. 2005), matching palette::Ciede2000.
double ciede2000(const double lab1[3], const double lab2[3]) {
  double l1 = lab1[0], a1 = lab1[1], b1 = lab1[2];
  double l2 = lab2[0], a2 = lab2[1], b2 = lab2[2];
  double c1 = std::hypot(a1, b1), c2 = std::hypot(a2, b2);
  double cbar = 0.5 * (c1 + c2);
  double cbar7 = std::pow(cbar, 7.0);
  double g = 0.5 * (1.0 - std::sqrt(cbar7 / (cbar7 + std::pow(25.0, 7.0))));
  double a1p = (1.0 + g) * a1, a2p = (1.0 + g) * a2;
  double c1p = std::hypot(a1p, b1), c2p = std::hypot(a2p, b2);
  double h1p = (b1 == 0.0 && a1p == 0.0) ? 0.0 : rad2deg(std::atan2(b1, a1p));
  double h2p = (b2 == 0.0 && a2p == 0.0) ? 0.0 : rad2deg(std::atan2(b2, a2p));
  if (h1p < 0) h1p += 360.0;
  if (h2p < 0) h2p += 360.0;
  double dlp = l2 - l1, dcp = c2p - c1p;
  double dhp;
  if (c1p * c2p == 0.0) {
    dhp = 0.0;
  } else {
    double diff = h2p - h1p;
    if (std::fabs(diff) <= 180.0)
      dhp = diff;
    else if (diff > 180.0)
      dhp = diff - 360.0;
    else
      dhp = diff + 360.0;
  }
  double dHp = 2.0 * std::sqrt(c1p * c2p) * std::sin(deg2rad(dhp) / 2.0);
  double lbar = 0.5 * (l1 + l2), cbarp = 0.5 * (c1p + c2p);
  double hsum = h1p + h2p, hbarp;
  if (c1p * c2p == 0.0) {
    hbarp = hsum;
  } else if (std::fabs(h1p - h2p) <= 180.0) {
    hbarp = 0.5 * hsum;
  } else if (hsum < 360.0) {
    hbarp = 0.5 * (hsum + 360.0);
  } else {
    hbarp = 0.5 * (hsum - 360.0);
  }
  double t = 1.0 - 0.17 * std::cos(deg2rad(hbarp - 30.0)) +
             0.24 * std::cos(deg2rad(2.0 * hbarp)) +
             0.32 * std::cos(deg2rad(3.0 * hbarp + 6.0)) -
             0.20 * std::cos(deg2rad(4.0 * hbarp - 63.0));
  double dtheta = 30.0 * std::exp(-std::pow((hbarp - 275.0) / 25.0, 2.0));
  double cbarp7 = std::pow(cbarp, 7.0);
  double rc = 2.0 * std::sqrt(cbarp7 / (cbarp7 + std::pow(25.0, 7.0)));
  double lm50 = (lbar - 50.0) * (lbar - 50.0);
  double sl = 1.0 + 0.015 * lm50 / std::sqrt(20.0 + lm50);
  double sc = 1.0 + 0.045 * cbarp;
  double sh = 1.0 + 0.015 * cbarp * t;
  double rt = -std::sin(deg2rad(2.0 * dtheta)) * rc;
  double tl = dlp / sl, tc = dcp / sc, th = dHp / sh;
  return std::sqrt(tl * tl + tc * tc + th * th + rt * tc * th);
}

// Nearest entry within one subpalette: clamp+round the f64 target to u8,
// strict-less-than scan, first index wins (src/lib.rs:762-795).
int closest_color_index(const int* entries8, int sub_size,
                        const double target[3], bool cielab) {
  int t[3];
  for (int i = 0; i < 3; ++i) {
    double v = target[i];
    if (v < 0.0) v = 0.0;
    if (v > 255.0) v = 255.0;
    t[i] = static_cast<int>(std::floor(v + 0.5));  // round half away (v>=0)
  }
  double tlab[3];
  if (cielab) srgb_to_lab(t, tlab);
  int best_index = 0;
  double best_error = 1e300;
  for (int idx = 0; idx < sub_size; ++idx) {
    const int* e = entries8 + idx * 3;
    int ec[3] = {e[0], e[1], e[2]};
    double err;
    if (cielab) {
      double elab[3];
      srgb_to_lab(ec, elab);
      err = ciede2000(elab, tlab);
    } else {
      err = red_mean_distance(ec, t);
    }
    if (err < best_error) {
      best_error = err;
      best_index = idx;
    }
  }
  return best_index;
}

// CIELAB (D65) -> 8-bit sRGB, matching ops/color.py lab_to_srgb_u8 /
// the palette crate's clamp-then-round conversion (src/lib.rs:368-371).
void lab_to_srgb_u8(const double lab[3], int rgb[3]) {
  double fy = (lab[0] + 16.0) / 116.0;
  double f[3] = {fy + lab[1] / 500.0, fy, fy - lab[2] / 200.0};
  const double d = 6.0 / 29.0;
  const double wp[3] = {0.95047, 1.0, 1.08883};
  double xyz[3];
  for (int i = 0; i < 3; ++i) {
    double v = (f[i] > d) ? f[i] * f[i] * f[i] : 3 * d * d * (f[i] - 4.0 / 29.0);
    xyz[i] = v * wp[i];
  }
  const double m[3][3] = {{3.2404542, -1.5371385, -0.4985314},
                          {-0.9692660, 1.8760108, 0.0415560},
                          {0.0556434, -0.2040259, 1.0572252}};
  for (int i = 0; i < 3; ++i) {
    double lin = m[i][0] * xyz[0] + m[i][1] * xyz[1] + m[i][2] * xyz[2];
    if (lin < 0.0) lin = 0.0;
    double s = (lin <= 0.0031308) ? lin * 12.92
                                  : 1.055 * std::pow(lin, 1.0 / 2.4) - 0.055;
    if (s < 0.0) s = 0.0;
    if (s > 1.0) s = 1.0;
    rgb[i] = static_cast<int>(std::lround(s * 255.0));
  }
}

// NES master palette, 5-bit (src/lib.rs:684-745).
const int kNes[56][3] = {
    {13, 13, 13}, {0, 2, 16},  {3, 0, 17},   {7, 0, 15},   {10, 0, 10},
    {11, 0, 3},   {9, 2, 0},   {7, 3, 0},    {4, 6, 0},    {0, 7, 0},
    {0, 8, 0},    {0, 7, 4},   {0, 5, 10},   {0, 0, 0},    {23, 23, 23},
    {3, 10, 24},  {9, 6, 28},  {14, 4, 26},  {18, 3, 21},  {19, 5, 11},
    {19, 6, 0},   {15, 9, 0},  {11, 12, 0},  {4, 14, 0},   {0, 15, 0},
    {0, 14, 8},   {0, 13, 17}, {0, 0, 0},    {31, 31, 31}, {13, 20, 31},
    {17, 19, 31}, {22, 16, 31}, {27, 14, 31}, {28, 14, 23}, {28, 17, 13},
    {26, 19, 5},  {22, 21, 1}, {15, 24, 2},  {10, 25, 8},  {8, 25, 16},
    {8, 24, 24},  {9, 9, 9},   {31, 31, 31}, {25, 29, 31}, {27, 27, 31},
    {29, 27, 31}, {31, 26, 31}, {31, 26, 30}, {31, 27, 25}, {31, 28, 22},
    {30, 30, 21}, {27, 31, 21}, {25, 31, 23}, {24, 31, 26}, {24, 30, 30},
    {23, 24, 23}};

// Cluster mean -> 5-bit SNES color (src/lib.rs:140-171, 368-401; JAX twin
// core/init.py _quantize_center): perceptual converts Lab->sRGB then
// truncates /8, RGB rounds mean/8 half-away; NES snaps by first-min scan.
void quantize_center(const double c[3], int perceptual, int nes,
                     int32_t out5[3]) {
  int rgb5[3];
  if (perceptual) {
    int rgb8[3];
    lab_to_srgb_u8(c, rgb8);
    for (int i = 0; i < 3; ++i) rgb5[i] = rgb8[i] / 8;
  } else {
    for (int i = 0; i < 3; ++i) {
      double v = c[i] / 8.0;
      int q = static_cast<int>(std::floor(v + 0.5));
      if (q < 0) q = 0;
      if (q > 31) q = 31;
      rgb5[i] = q;
    }
  }
  if (nes) {
    int rgb8[3] = {expand5(rgb5[0]), expand5(rgb5[1]), expand5(rgb5[2])};
    double tlab[3];
    if (perceptual) srgb_to_lab(rgb8, tlab);
    int best = 0;
    double bd = 1e300;
    for (int j = 0; j < 56; ++j) {
      int n8[3] = {expand5(kNes[j][0]), expand5(kNes[j][1]),
                   expand5(kNes[j][2])};
      double err;
      if (perceptual) {
        double nlab[3];
        srgb_to_lab(n8, nlab);
        err = ciede2000(tlab, nlab);
      } else {
        err = red_mean_distance(rgb8, n8);
      }
      if (err < bd) {
        bd = err;
        best = j;
      }
    }
    for (int i = 0; i < 3; ++i) out5[i] = kNes[best][i];
  } else {
    for (int i = 0; i < 3; ++i) out5[i] = rgb5[i];
  }
}

// Lloyd's k-means with deterministic first-k-valid init (JAX twin
// ops/kmeans.py lloyd_kmeans: 100-iteration cap, tol 1e-6 on max squared
// center movement, empty clusters keep their center, surplus centers 0).
void lloyd_kmeans(const double* data, const uint8_t* mask, int n, int k,
                  const int32_t* order, double* centers_out,
                  int32_t* assign_out) {
  std::vector<double> c(static_cast<size_t>(k) * 3, 0.0);
  int got = 0;
  for (int oi = 0; oi < n && got < k; ++oi) {
    int idx = order ? order[oi] : oi;
    if (mask[idx]) {
      for (int d = 0; d < 3; ++d) c[got * 3 + d] = data[idx * 3 + d];
      ++got;
    }
  }
  auto assign1 = [&](const double* pt) {
    int best = 0;
    double bd = 1e300;
    for (int j = 0; j < k; ++j) {
      double s = 0;
      for (int d = 0; d < 3; ++d) {
        double df = pt[d] - c[j * 3 + d];
        s += df * df;
      }
      if (s < bd) {
        bd = s;
        best = j;
      }
    }
    return best;
  };
  for (int it = 0; it < 100; ++it) {
    std::vector<double> sums(static_cast<size_t>(k) * 3, 0.0);
    std::vector<double> cnt(k, 0.0);
    for (int i = 0; i < n; ++i) {
      if (!mask[i]) continue;
      int a = assign1(data + static_cast<size_t>(i) * 3);
      for (int d = 0; d < 3; ++d) sums[a * 3 + d] += data[i * 3 + d];
      cnt[a] += 1.0;
    }
    double shift = 0.0;
    for (int j = 0; j < k; ++j) {
      if (cnt[j] <= 0.0) continue;
      double s = 0.0;
      for (int d = 0; d < 3; ++d) {
        double nc = sums[j * 3 + d] / cnt[j];
        double df = nc - c[j * 3 + d];
        s += df * df;
        c[j * 3 + d] = nc;
      }
      if (s > shift) shift = s;
    }
    if (shift <= 1e-6) break;
  }
  for (int i = 0; i < n; ++i)
    assign_out[i] = mask[i] ? assign1(data + static_cast<size_t>(i) * 3) : 0;
  for (int j = 0; j < k * 3; ++j) centers_out[j] = c[j];
}

// Pixel coordinates for clustering: RGB or CIELAB (src/lib.rs:100-111).
void pixel_coord(const uint8_t* px, int perceptual, double out[3]) {
  if (perceptual) {
    int c[3] = {px[0], px[1], px[2]};
    srgb_to_lab(c, out);
  } else {
    out[0] = px[0];
    out[1] = px[1];
    out[2] = px[2];
  }
}

}  // namespace

extern "C" {

double oracle_red_mean(int r1, int g1, int b1, int r2, int g2, int b2) {
  int c1[3] = {r1, g1, b1}, c2[3] = {r2, g2, b2};
  return red_mean_distance(c1, c2);
}

double oracle_ciede2000(int r1, int g1, int b1, int r2, int g2, int b2) {
  int c1[3] = {r1, g1, b1}, c2[3] = {r2, g2, b2};
  double lab1[3], lab2[3];
  srgb_to_lab(c1, lab1);
  srgb_to_lab(c2, lab2);
  return ciede2000(lab1, lab2);
}

void oracle_srgb_to_lab(int r, int g, int b, double* out) {
  int c[3] = {r, g, b};
  srgb_to_lab(c, out);
}

// Full remap scan with optional Floyd-Steinberg dithering
// (src/lib.rs:425-501). palette5: (sub_count, sub_size, 3) 5-bit values.
// tile_palettes: (h/8, w/8) row-major. out_map: (h, w) entry indices.
void oracle_remap(int w, int h, const uint8_t* rgba,
                  const int32_t* tile_palettes, const int32_t* palette5,
                  int sub_count, int sub_size, int dither, int perceptual,
                  int32_t* out_map) {
  std::vector<int> entries8(sub_count * sub_size * 3);
  for (int i = 0; i < sub_count * sub_size * 3; ++i)
    entries8[i] = expand5(palette5[i]);

  double weights[4] = {0, 0, 0, 0};
  if (dither) {
    weights[0] = 7.0 / 16.0;
    weights[1] = 3.0 / 16.0;
    weights[2] = 5.0 / 16.0;
    weights[3] = 1.0 / 16.0;
  }
  const double mult = 0.8;
  std::vector<double> error(static_cast<size_t>(w) * h * 3, 0.0);
  int wt = w / 8;

  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      size_t pi = static_cast<size_t>(y) * w + x;
      const uint8_t* px = rgba + pi * 4;
      int pal = tile_palettes[(y / 8) * wt + (x / 8)];
      double target[3] = {px[0] + error[pi * 3 + 0], px[1] + error[pi * 3 + 1],
                          px[2] + error[pi * 3 + 2]};
      int ci = closest_color_index(entries8.data() + pal * sub_size * 3,
                                   sub_size, target, perceptual != 0);
      out_map[pi] = (px[3] > 0) ? ci : 0;
      const int* nc = entries8.data() + (pal * sub_size + ci) * 3;
      double perr[3];
      if (px[3] > 0) {
        for (int i = 0; i < 3; ++i) perr[i] = target[i] - nc[i];
      } else {
        for (int i = 0; i < 3; ++i) perr[i] = error[pi * 3 + i];
      }
      for (int i = 0; i < 3; ++i) {
        double v = perr[i] * mult;
        if (x + 1 < w) error[(pi + 1) * 3 + i] += v * weights[0];
        if (y + 1 < h) {
          if (x > 0) error[(pi + w - 1) * 3 + i] += v * weights[1];
          error[(pi + w) * 3 + i] += v * weights[2];
          if (x + 1 < w) error[(pi + w + 1) * 3 + i] += v * weights[3];
        }
      }
    }
  }
}

// Tile->subpalette assignment + flat palette fill (src/lib.rs:79-189
// minus the final remap; JAX twin core/init.py assign_tiles): per-tile
// mean coords over opaque pixels, tiles with zero coord-sum excluded,
// k-means of tile means with first-k-valid init in tile_x-major push
// order (src/lib.rs:89-90), every entry of each subpalette filled with
// the quantized cluster mean.
void oracle_assign_tiles(int w, int h, const uint8_t* rgba, int sub_count,
                         int sub_size, int perceptual, int nes,
                         int32_t* out_tp, int32_t* out_pal) {
  int wt = w / 8, ht = h / 8, T = wt * ht;
  std::vector<double> means(static_cast<size_t>(T) * 3, 0.0);
  std::vector<uint8_t> valid(T, 0);
  for (int t = 0; t < T; ++t) {
    int ty = t / wt, tx = t % wt;
    double sum[3] = {0, 0, 0};
    double cnt = 0;
    for (int x = 0; x < 8; ++x) {
      for (int y = 0; y < 8; ++y) {
        const uint8_t* px =
            rgba + ((static_cast<size_t>(ty * 8 + y)) * w + tx * 8 + x) * 4;
        if (px[3] == 0) continue;
        double coord[3];
        pixel_coord(px, perceptual, coord);
        for (int d = 0; d < 3; ++d) sum[d] += coord[d];
        cnt += 1.0;
      }
    }
    valid[t] = (sum[0] + sum[1] + sum[2]) > 0.0 ? 1 : 0;
    for (int d = 0; d < 3; ++d)
      means[t * 3 + d] = sum[d] / (cnt > 0 ? cnt : 1.0);
  }
  std::vector<int32_t> order(T);
  int oi = 0;
  for (int tx = 0; tx < wt; ++tx)
    for (int ty = 0; ty < ht; ++ty) order[oi++] = ty * wt + tx;
  std::vector<double> centers(static_cast<size_t>(sub_count) * 3);
  std::vector<int32_t> assign(T);
  lloyd_kmeans(means.data(), valid.data(), T, sub_count, order.data(),
               centers.data(), assign.data());
  for (int t = 0; t < T; ++t) out_tp[t] = valid[t] ? assign[t] : 0;
  for (int p = 0; p < sub_count; ++p) {
    int32_t c5[3];
    quantize_center(centers.data() + static_cast<size_t>(p) * 3, perceptual,
                    nes, c5);
    for (int s = 0; s < sub_size; ++s)
      for (int d = 0; d < 3; ++d) out_pal[(p * sub_size + s) * 3 + d] = c5[d];
  }
}

// Per-subpalette pixel k-means into sub_size colors (src/lib.rs:330-415
// minus the remap; JAX twin core/init.py recalculate_palettes). Pixel
// order: tiles row-major, within each tile x outer / y inner
// (src/lib.rs:338-339).
void oracle_recalculate(int w, int h, const uint8_t* rgba,
                        const int32_t* tile_palettes, int sub_count,
                        int sub_size, int perceptual, int nes,
                        int32_t* out_pal) {
  int wt = w / 8, ht = h / 8, T = wt * ht;
  size_t n = static_cast<size_t>(T) * 64;
  std::vector<double> coords(n * 3);
  std::vector<int32_t> tile_of(n);
  std::vector<uint8_t> opaque(n);
  size_t i = 0;
  for (int t = 0; t < T; ++t) {
    int ty = t / wt, tx = t % wt;
    for (int x = 0; x < 8; ++x) {
      for (int y = 0; y < 8; ++y, ++i) {
        const uint8_t* px =
            rgba + ((static_cast<size_t>(ty * 8 + y)) * w + tx * 8 + x) * 4;
        pixel_coord(px, perceptual, coords.data() + i * 3);
        tile_of[i] = t;
        opaque[i] = px[3] > 0 ? 1 : 0;
      }
    }
  }
  std::vector<uint8_t> mask(n);
  std::vector<double> centers(static_cast<size_t>(sub_size) * 3);
  std::vector<int32_t> assign(n);
  for (int p = 0; p < sub_count; ++p) {
    for (size_t j = 0; j < n; ++j)
      mask[j] = (opaque[j] && tile_palettes[tile_of[j]] == p) ? 1 : 0;
    lloyd_kmeans(coords.data(), mask.data(), static_cast<int>(n), sub_size,
                 nullptr, centers.data(), assign.data());
    for (int s = 0; s < sub_size; ++s) {
      int32_t c5[3];
      quantize_center(centers.data() + static_cast<size_t>(s) * 3, perceptual,
                      nes, c5);
      for (int d = 0; d < 3; ++d) out_pal[(p * sub_size + s) * 3 + d] = c5[d];
    }
  }
}

}  // extern "C"
