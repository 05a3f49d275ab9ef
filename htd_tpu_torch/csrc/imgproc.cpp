// OpenCV's float32 filters and warps that the image corruptions use, on the
// host, bit-equal to OpenCV 5 as it runs on x86-64 (its AVX2 dispatch,
// with FMA). The summation orders below were read off OpenCV's output
// element by element; each function says what it reproduces.
//
// - htd_sep_filter_f32: sepFilter2D (GaussianBlur's float path). Rows: a
//   3-tap symmetric kernel as fma(c, k0, (l + r) k1), a 5-tap one as
//   fma(p2, k2, fma(c, k0, p1 k1)), both with a last element of their own
//   form when the row holds an odd number of values; longer kernels as a
//   sequential fma from the leftmost tap over the row's first multiple of
//   4 values, the rest in plain products and sums, the tap loop unrolled by
//   4 and its remainder fused. Columns: the centre tap, then each symmetric
//   pair (summed first) from the centre out, fused over the row's first
//   multiple of 8 values (all of it for 3 taps), plain after.
// - htd_filter2d_f32: filter2D. A kernel of fewer than 130 taps takes the
//   direct path: its nonzero taps in row-major order, a sequential fma over
//   the row's first multiple of 8 values, plain after. 130 taps or more take
//   OpenCV's DFT in float64; here the float64 sum rounded once, which is
//   what that gives.
// - htd_warp_affine_f32 and htd_remap_f32: INTER_LINEAR in float
//   coordinates, x = fma(u, m0, v m1 + m2) over each row's first multiple
//   of 16 pixels and fma(u, m0, v m1) + m2 after; each sample as two
//   horizontal lerps fma(a, p01 - p00, p00) and one vertical lerp.
// - htd_resize_linear_f32: resize INTER_LINEAR, source positions
//   (d + 0.5) s / d' - 0.5 in double, a horizontal then a vertical lerp; a
//   source of one row or one column as OpenCV's older generic path does it
//   (float positions, weights 1 - a and a in plain products and sums).
//
// Borders: OpenCV's BORDER_CONSTANT (0, value 0), BORDER_REFLECT (2) and
// BORDER_REFLECT_101 (4), reflected as often as a kernel wider than the
// image needs (borderInterpolate). Images are (H, W, cn) float32, contiguous.
// Products and sums that OpenCV does not fuse stay apart because the host
// library is built with -ffp-contract=off; fmaf is fused everywhere, in
// hardware where the CPU has FMA (a clone of each loop built for AVX2 and
// FMA, picked at run time) and in libm otherwise, with the same result.
//
// Plain C interface for ctypes; no Python or PyTorch headers.

#include <math.h>
#include <stdint.h>

#include <new>
#include <vector>

namespace {

#if defined(__GNUC__)
#define HTD_INLINE inline __attribute__((always_inline))
#else
#define HTD_INLINE inline
#endif

enum Border { kConstant = 0, kReflect = 2, kReflect101 = 4 };

// cv::borderInterpolate; -1 for a constant border's outside.
int border_index(int p, int n, int border) {
  if ((unsigned)p < (unsigned)n) return p;
  if (border == kConstant) return -1;
  if (n == 1) return 0;
  const int delta = border == kReflect101;
  do {
    p = p < 0 ? -p - 1 + delta : n - 1 - (p - n) - delta;
  } while ((unsigned)p >= (unsigned)n);
  return p;
}

// One row of `width` values from a padded row p of (width + (n - 1) cn).
HTD_INLINE void row_filter(const float* p, const float* k, int n, int width, int cn, float* out) {
  if (n == 1) {
    for (int i = 0; i < width; ++i) out[i] = p[i] * k[0];
  } else if (n == 3) {
    for (int i = 0; i < width; ++i)
      out[i] = fmaf(p[i + cn], k[1], (p[i] + p[i + 2 * cn]) * k[2]);
    if (width & 1) {
      const int i = width - 1;
      out[i] = fmaf(p[i] + p[i + 2 * cn], k[2], p[i + cn] * k[1]);
    }
  } else if (n == 5) {
    for (int i = 0; i < width; ++i) {
      const float c = p[i + 2 * cn], p1 = p[i + cn] + p[i + 3 * cn], p2 = p[i] + p[i + 4 * cn];
      out[i] = fmaf(p2, k[4], fmaf(c, k[2], p1 * k[3]));
    }
    if (width & 1) {
      const int i = width - 1;
      const float c = p[i + 2 * cn], p1 = p[i + cn] + p[i + 3 * cn], p2 = p[i] + p[i + 4 * cn];
      out[i] = (c * k[2] + p1 * k[3]) + p2 * k[4];
    }
  } else {
    const int nv = width / 4 * 4, m = (n - 1) / 4 * 4;
    for (int i = 0; i < width; ++i) out[i] = p[i] * k[0];
    for (int j = 1; j < n; ++j) {
      const float* q = p + j * cn;
      const float kj = k[j];
      for (int i = 0; i < nv; ++i) out[i] = fmaf(q[i], kj, out[i]);
      if (j > m)
        for (int i = nv; i < width; ++i) out[i] = fmaf(q[i], kj, out[i]);
      else
        for (int i = nv; i < width; ++i) out[i] = out[i] + q[i] * kj;
    }
  }
}

HTD_INLINE void sep_filter(const float* src, int H, int W, int cn, const float* kx, int nx,
                       const float* ky, int ny, int border, float* dst) {
  const int rx = nx / 2, width = W * cn;
  std::vector<float> padded((size_t)(W + nx - 1) * cn);
  std::vector<float> rows((size_t)H * width);
  std::vector<int> xi(W + nx - 1);
  for (int j = 0; j < W + nx - 1; ++j) xi[j] = border_index(j - rx, W, border);
  for (int y = 0; y < H; ++y) {
    const float* s = src + (size_t)y * width;
    for (int j = 0; j < W + nx - 1; ++j)
      for (int c = 0; c < cn; ++c) padded[(size_t)j * cn + c] = s[(size_t)xi[j] * cn + c];
    row_filter(padded.data(), kx, nx, width, cn, &rows[(size_t)y * width]);
  }
  const int r = ny / 2, nv = ny == 3 ? width : width / 8 * 8;
  std::vector<const float*> S(ny);
  for (int y = 0; y < H; ++y) {
    for (int d = -r; d <= r; ++d) S[d + r] = &rows[(size_t)border_index(y + d, H, border) * width];
    float* o = dst + (size_t)y * width;
    const float kc = ky[r];
    for (int i = 0; i < width; ++i) o[i] = S[r][i] * kc;
    for (int j = 1; j <= r; ++j) {
      const float *a = S[r + j], *b = S[r - j];
      const float kj = ky[r + j];
      for (int i = 0; i < nv; ++i) o[i] = fmaf(a[i] + b[i], kj, o[i]);
      for (int i = nv; i < width; ++i) o[i] = o[i] + (a[i] + b[i]) * kj;
    }
  }
}

HTD_INLINE void filter2d(const float* src, int H, int W, int cn, const float* kern, int kh, int kw,
                     int border, float* dst) {
  const int ay = kh / 2, ax = kw / 2, width = W * cn, pw = (W + kw - 1) * cn;
  std::vector<float> pad((size_t)(H + kh - 1) * pw);
  for (int y = 0; y < H + kh - 1; ++y) {
    const int sy = border_index(y - ay, H, border);
    for (int x = 0; x < W + kw - 1; ++x) {
      const int sx = border_index(x - ax, W, border);
      for (int c = 0; c < cn; ++c)
        pad[(size_t)y * pw + (size_t)x * cn + c] =
            sy < 0 || sx < 0 ? 0.f : src[((size_t)sy * W + sx) * cn + c];
    }
  }
  std::vector<int> off;
  std::vector<float> tap;
  for (int i = 0; i < kh; ++i)
    for (int j = 0; j < kw; ++j)
      if (kern[i * kw + j] != 0.f) {
        off.push_back(i * pw + j * cn);
        tap.push_back(kern[i * kw + j]);
      }
  const int nz = (int)tap.size();
  if (kh * kw >= 130) {  // OpenCV's DFT path: float64
    std::vector<double> acc(width);
    for (int y = 0; y < H; ++y) {
      const float* row = &pad[(size_t)y * pw];
      for (int i = 0; i < width; ++i) acc[i] = 0.0;
      for (int t = 0; t < nz; ++t) {
        const float* q = row + off[t];
        const double kt = tap[t];
        for (int i = 0; i < width; ++i) acc[i] += (double)q[i] * kt;
      }
      for (int i = 0; i < width; ++i) dst[(size_t)y * width + i] = (float)acc[i];
    }
    return;
  }
  const int nv = width / 8 * 8;
  for (int y = 0; y < H; ++y) {
    const float* row = &pad[(size_t)y * pw];
    float* o = dst + (size_t)y * width;
    if (!nz) {
      for (int i = 0; i < width; ++i) o[i] = 0.f;
      continue;
    }
    for (int i = 0; i < width; ++i) o[i] = row[off[0] + i] * tap[0];
    for (int t = 1; t < nz; ++t) {
      const float* q = row + off[t];
      const float kt = tap[t];
      for (int i = 0; i < nv; ++i) o[i] = fmaf(q[i], kt, o[i]);
      for (int i = nv; i < width; ++i) o[i] = o[i] + q[i] * kt;
    }
  }
}

// One bilinear sample of every channel at (sx, sy) into out.
HTD_INLINE void sample(const float* src, int H, int W, int cn, float sx, float sy, int border,
                   float* out) {
  const float fx = floorf(sx), fy = floorf(sy);
  const float a = sx - fx, b = sy - fy;
  const float lim = 1 << 30;
  const int x0 = (int)(fx < -lim ? -lim : (fx > lim ? lim : fx));
  const int y0 = (int)(fy < -lim ? -lim : (fy > lim ? lim : fy));
  const int xs[2] = {border_index(x0, W, border), border_index(x0 + 1, W, border)};
  const int ys[2] = {border_index(y0, H, border), border_index(y0 + 1, H, border)};
  for (int c = 0; c < cn; ++c) {
    float p[2][2];
    for (int v = 0; v < 2; ++v)
      for (int h = 0; h < 2; ++h)
        p[v][h] = ys[v] < 0 || xs[h] < 0 ? 0.f : src[((size_t)ys[v] * W + xs[h]) * cn + c];
    const float u = fmaf(a, p[0][1] - p[0][0], p[0][0]);
    const float w = fmaf(a, p[1][1] - p[1][0], p[1][0]);
    out[c] = fmaf(b, w - u, u);
  }
}

HTD_INLINE void warp_affine(const float* src, int H, int W, int cn, const float* m, int dh, int dw,
                        int border, float* dst) {
  const int nv = dw / 16 * 16;
  for (int y = 0; y < dh; ++y) {
    const float fy = (float)y;
    const float ty0 = fy * m[1], ty1 = fy * m[4];
    const float row0 = ty0 + m[2], row1 = ty1 + m[5];
    for (int x = 0; x < dw; ++x) {
      const float fx = (float)x;
      float sx, sy;
      if (x < nv) {
        sx = fmaf(fx, m[0], row0);
        sy = fmaf(fx, m[3], row1);
      } else {
        sx = fmaf(fx, m[0], ty0) + m[2];
        sy = fmaf(fx, m[3], ty1) + m[5];
      }
      sample(src, H, W, cn, sx, sy, border, dst + ((size_t)y * dw + x) * cn);
    }
  }
}

HTD_INLINE void remap(const float* src, int H, int W, int cn, const float* mx, const float* my,
                  int dh, int dw, int border, float* dst) {
  for (size_t i = 0; i < (size_t)dh * dw; ++i)
    sample(src, H, W, cn, mx[i], my[i], border, dst + i * cn);
}

// resize's INTER_LINEAR table for one axis: first source index and weight.
void linear_table(int ssize, int dsize, std::vector<int>& ofs, std::vector<float>& alpha) {
  const double scale = (double)ssize / dsize;
  ofs.resize(dsize);
  alpha.resize(dsize);
  for (int d = 0; d < dsize; ++d) {
    double f = (d + 0.5) * scale - 0.5;
    int s = (int)floor(f);
    f -= s;
    if (s < 0) f = 0, s = 0;
    if (s >= ssize - 1) f = 0, s = ssize - 1;
    ofs[d] = s;
    alpha[d] = (float)f;
  }
}

// The older table OpenCV keeps for a source of one row or one column: the
// position in float from the reciprocal of the ratio, clamped along x only.
void generic_table(int ssize, int dsize, bool clamp, std::vector<int>& ofs,
                   std::vector<float>& alpha) {
  const double inv = 1.0 / ((double)dsize / ssize);
  ofs.resize(dsize);
  alpha.resize(dsize);
  for (int d = 0; d < dsize; ++d) {
    float f = (float)((d + 0.5) * inv - 0.5);
    int s = (int)floorf(f);
    f -= (float)s;
    if (clamp && s < 0) f = 0, s = 0;
    if (clamp && s >= ssize - 1) f = 0, s = ssize - 1;
    ofs[d] = s;
    alpha[d] = f;
  }
}

inline int clampi(int v, int n) { return v < 0 ? 0 : (v >= n ? n - 1 : v); }

// Lerps fma(a, p1 - p0, p0), a horizontal pass then a vertical one; for a
// source of one row or one column OpenCV's older generic path instead,
// p0 (1 - a) + p1 a in plain products and sums along both axes.
HTD_INLINE void resize_linear(const float* src, int H, int W, int cn, int dh, int dw,
                              float* dst) {
  const bool generic = H == 1 || W == 1;
  std::vector<int> xo, yo;
  std::vector<float> xa, ya;
  if (generic) {
    generic_table(W, dw, true, xo, xa);
    generic_table(H, dh, false, yo, ya);
  } else {
    linear_table(W, dw, xo, xa);
    linear_table(H, dh, yo, ya);
  }
  const size_t dwidth = (size_t)dw * cn;
  std::vector<float> rows((size_t)H * dwidth);
  for (int y = 0; y < H; ++y) {
    const float* s = src + (size_t)y * W * cn;
    float* r = &rows[(size_t)y * dwidth];
    for (int d = 0; d < dw; ++d) {
      const int x0 = clampi(xo[d], W), x1 = clampi(xo[d] + 1, W);
      const float a = xa[d], a0 = 1.f - a;
      for (int c = 0; c < cn; ++c) {
        const float p0 = s[(size_t)x0 * cn + c], p1 = s[(size_t)x1 * cn + c];
        r[(size_t)d * cn + c] = generic ? p0 * a0 + p1 * a : fmaf(a, p1 - p0, p0);
      }
    }
  }
  for (int d = 0; d < dh; ++d) {
    const float* r0 = &rows[(size_t)clampi(yo[d], H) * dwidth];
    const float* r1 = &rows[(size_t)clampi(yo[d] + 1, H) * dwidth];
    float* o = dst + (size_t)d * dwidth;
    const float b = ya[d], b0 = 1.f - b;
    if (generic)
      for (size_t i = 0; i < dwidth; ++i) o[i] = r0[i] * b0 + r1[i] * b;
    else
      for (size_t i = 0; i < dwidth; ++i) o[i] = fmaf(b, r1[i] - r0[i], r0[i]);
  }
}

#if defined(__x86_64__) && defined(__GNUC__)
#define HTD_HAVE_FMA_CLONE 1
#define HTD_FMA_TARGET __attribute__((target("avx2,fma")))
#else
#define HTD_HAVE_FMA_CLONE 0
#endif

bool cpu_has_fma() {
#if HTD_HAVE_FMA_CLONE
  static const bool has = __builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma");
  return has;
#else
  return false;
#endif
}

// Each entry point in two builds of the same loops: for AVX2 and FMA (fmaf
// a single instruction, the loops vectorised) and for any CPU (fmaf from
// libm); both give the same bits.
#if HTD_HAVE_FMA_CLONE
#define HTD_DISPATCH(name, params, args)       \
  HTD_FMA_TARGET void name##_fma params { name args; } \
  void name##_any params { name args; }         \
  void name##_run params {                      \
    if (cpu_has_fma())                          \
      name##_fma args;                          \
    else                                        \
      name##_any args;                          \
  }
#else
#define HTD_DISPATCH(name, params, args) \
  void name##_run params { name args; }
#endif

HTD_DISPATCH(sep_filter,
             (const float* s, int H, int W, int cn, const float* kx, int nx, const float* ky,
              int ny, int border, float* d),
             (s, H, W, cn, kx, nx, ky, ny, border, d))
HTD_DISPATCH(filter2d,
             (const float* s, int H, int W, int cn, const float* k, int kh, int kw, int border,
              float* d),
             (s, H, W, cn, k, kh, kw, border, d))
HTD_DISPATCH(warp_affine,
             (const float* s, int H, int W, int cn, const float* m, int dh, int dw, int border,
              float* d),
             (s, H, W, cn, m, dh, dw, border, d))
HTD_DISPATCH(remap,
             (const float* s, int H, int W, int cn, const float* mx, const float* my, int dh,
              int dw, int border, float* d),
             (s, H, W, cn, mx, my, dh, dw, border, d))
HTD_DISPATCH(resize_linear, (const float* s, int H, int W, int cn, int dh, int dw, float* d),
             (s, H, W, cn, dh, dw, d))

bool bad_border(int border) {
  return border != kConstant && border != kReflect && border != kReflect101;
}

// 0 on success, 1 on bad arguments, 2 when a buffer could not be allocated.
template <typename F>
int guarded(F&& f) {
  try {
    f();
    return 0;
  } catch (const std::bad_alloc&) {
    return 2;
  }
}

}  // namespace

// GaussianBlur / sepFilter2D: kx (nx taps) along rows, ky (ny taps) along
// columns, both odd and symmetric; border 2 or 4. Returns 0, 1 or 2.
extern "C" int htd_sep_filter_f32(const float* src, int32_t H, int32_t W, int32_t cn,
                                  const float* kx, int32_t nx, const float* ky, int32_t ny,
                                  int32_t border, float* dst) {
  if (H < 1 || W < 1 || cn < 1 || nx < 1 || ny < 1 || !(nx & 1) || !(ny & 1) ||
      (border != kReflect && border != kReflect101))
    return 1;
  for (int i = 0; i < nx / 2; ++i)
    if (kx[i] != kx[nx - 1 - i]) return 1;
  for (int i = 0; i < ny / 2; ++i)
    if (ky[i] != ky[ny - 1 - i]) return 1;
  return guarded([&] { sep_filter_run(src, H, W, cn, kx, nx, ky, ny, border, dst); });
}

// filter2D with a (kh, kw) kernel, anchor at its centre. Returns 0, 1 or 2.
extern "C" int htd_filter2d_f32(const float* src, int32_t H, int32_t W, int32_t cn,
                                const float* kern, int32_t kh, int32_t kw, int32_t border,
                                float* dst) {
  if (H < 1 || W < 1 || cn < 1 || kh < 1 || kw < 1 || bad_border(border)) return 1;
  return guarded([&] { filter2d_run(src, H, W, cn, kern, kh, kw, border, dst); });
}

// warpAffine (INTER_LINEAR) by the inverse map m (float32, 2x3): dst pixel
// (x, y) samples the source at m (x, y, 1). Returns 0, 1 or 2.
extern "C" int htd_warp_affine_f32(const float* src, int32_t H, int32_t W, int32_t cn,
                                   const float* m, int32_t dh, int32_t dw, int32_t border,
                                   float* dst) {
  if (H < 1 || W < 1 || cn < 1 || dh < 1 || dw < 1 || bad_border(border)) return 1;
  return guarded([&] { warp_affine_run(src, H, W, cn, m, dh, dw, border, dst); });
}

// remap (INTER_LINEAR) with float32 maps of (dh, dw). Returns 0, 1 or 2.
extern "C" int htd_remap_f32(const float* src, int32_t H, int32_t W, int32_t cn,
                             const float* mx, const float* my, int32_t dh, int32_t dw,
                             int32_t border, float* dst) {
  if (H < 1 || W < 1 || cn < 1 || dh < 1 || dw < 1 || bad_border(border)) return 1;
  return guarded([&] { remap_run(src, H, W, cn, mx, my, dh, dw, border, dst); });
}

// resize (INTER_LINEAR) to (dh, dw). Returns 0, 1 or 2.
extern "C" int htd_resize_linear_f32(const float* src, int32_t H, int32_t W, int32_t cn,
                                     int32_t dh, int32_t dw, float* dst) {
  if (H < 1 || W < 1 || cn < 1 || dh < 1 || dw < 1) return 1;
  return guarded([&] { resize_linear_run(src, H, W, cn, dh, dw, dst); });
}
