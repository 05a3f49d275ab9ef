"""OpenCV's image routines that the corruptions use, on the host, bit for
bit with OpenCV 5 as it runs on x86-64.

uint8, in numpy:
- `bgr_to_hsv`: `cv2.cvtColor(img, COLOR_BGR2HSV)` for uint8 (H in 0-179):
  the fixed-point division tables `sdiv_table` and `hdiv_table180` with
  `hsv_shift = 12` and their rounding.
- `hsv_to_bgr`: `COLOR_HSV2BGR` for uint8: float32 arithmetic on S and V
  scaled by 1/255 with OpenCV's fused multiply-adds, each channel times
  255 truncated in OpenCV's vector loop and rounded in its scalar tail.
- `bgr_to_gray`: `COLOR_BGR2GRAY` for uint8, (3735 B + 19235 G + 9798 R +
  2**14) >> 15.
- `resize_area`: `cv2.resize(..., INTER_AREA)` when shrinking: the
  whole-factor fast path (2x2 as `(a + b + c + d + 2) >> 2`, other factors
  as the int sum times the float reciprocal of the area) and the general
  path with float32 area weights summed in OpenCV's order.
- `resize_nearest`: `cv2.resize(..., INTER_NEAREST)`, source index
  `floor(x * (1 / fx))` in double precision.

float32, the loops in C++ (`csrc/imgproc.cpp`, in the host library that
`ops._build.load_host` builds, whose header gives each routine's order of
operations):
- `gaussian_blur`: `cv2.GaussianBlur` (sepFilter2D with `gaussian_kernel`'s
  taps; a one-row or one-column image is not filtered across it);
- `filter2d`: `cv2.filter2D`, direct under 130 taps, in float64 from 130;
- `warp_affine`, `remap`: INTER_LINEAR in float coordinates;
- `resize_linear`: `cv2.resize(..., INTER_LINEAR)`.

float64, in Python: `gaussian_kernel` (`getGaussianKernel` for CV_32F),
`rotation_matrix_2d` (`getRotationMatrix2D`), `affine_transform`
(`getAffineTransform`: OpenCV's LU solve of the 6x6 system).
"""

from __future__ import annotations

import math

import numpy as np

_HSV_SHIFT = 12
_HSV_VECTOR_PIXELS = 32   # pixels per iteration of HSV2RGB_b's AVX2 loop


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    # saturate_cast<int>(double) rounds half to even, as np.rint
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> uint8 HSV, as `cv2.cvtColor(img, COLOR_BGR2HSV)`."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], axis=-1).astype(np.uint8)


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 HSV (H in 0-179) -> uint8 BGR, as `cv2.cvtColor(hsv,
    COLOR_HSV2BGR)` gives it on an x86-64 CPU with AVX2 and FMA: float32 S
    and V (times 1/255), the sector's tab entries v (1 - s),
    v fma(-s, h, 1) and v fma(-s, 1 - h, 1), each times 255. OpenCV's
    vector loop takes each row's pixels 32 at a time and truncates; the
    scalar loop after it takes the rest of the row and rounds half to even.
    Checked on every uint8 HSV triple with H < 180, in both loops."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = h - sector
    one = f32(1.0)

    def one_minus_s_times(x):   # fma(-s, x, 1): the product exact in float64, one rounding
        return (1.0 - s.astype(np.float64) * x.astype(np.float64)).astype(f32)

    tab = np.stack([v, v * (one - s), v * one_minus_s_times(h), v * one_minus_s_times(one - h)],
                   axis=-1)
    # per sector, the tab entries of b, g, r (OpenCV's sector_data)
    sector_data = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    bgr = np.take_along_axis(tab, sector_data[sector.astype(np.int64) % 6], axis=-1) * f32(255.0)
    vector_cols = hsv.shape[1] // _HSV_VECTOR_PIXELS * _HSV_VECTOR_PIXELS
    out = np.rint(bgr)
    out[:, :vector_cols] = np.trunc(bgr[:, :vector_cols])
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_tab(ssize: int, dsize: int, scale: float):
    """OpenCV's computeResizeAreaTab as (dsize, k) source indices and float32
    weights, each destination's entries in OpenCV's order (zero weights pad)."""
    entries = [[] for _ in range(dsize)]
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            entries[dx].append((sx1 - 1, (sx1 - fsx1) / cell))
        for sx in range(sx1, sx2):
            entries[dx].append((sx, 1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            entries[dx].append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
    k = max(len(e) for e in entries)
    idx = np.zeros((dsize, k), np.int64)
    alpha = np.zeros((dsize, k), np.float32)
    for dx, e in enumerate(entries):
        for j, (si, a) in enumerate(e):
            idx[dx, j], alpha[dx, j] = si, a
    return idx, alpha


def resize_area(img: np.ndarray, dsize) -> np.ndarray:
    """Shrink a (H, W, C) uint8 image to `dsize` = (width, height), as
    `cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)`; both sides no
    larger than the source's."""
    sh, sw = img.shape[:2]
    dw, dh = dsize
    if not (1 <= dw <= sw and 1 <= dh <= sh):
        raise ValueError(f"resize_area shrinks only: {sw}x{sh} -> {dw}x{dh}")
    if (dw, dh) == (sw, sh):
        return img.copy()
    scale_x, scale_y = 1.0 / (dw / sw), 1.0 / (dh / sh)
    ix, iy = int(round(scale_x)), int(round(scale_y))
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        # whole factors: each output a full ix x iy cell of the source
        cells = img[:dh * iy, :dw * ix].reshape(dh, iy, dw, ix, -1).astype(np.int64)
        total = cells.sum(axis=(1, 3))
        if ix == 2 and iy == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        area_scale = np.float32(1.0 / (ix * iy))
        out = total.astype(np.float32) * area_scale
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    xi, xa = _area_tab(sw, dw, scale_x)
    yi, ya = _area_tab(sh, dh, scale_y)
    src = img.astype(np.float32)
    # horizontal: buf[dy-row][dx] = sum over the entries in order of S * alpha
    rows = np.zeros((sh, dw) + img.shape[2:], np.float32)
    for j in range(xi.shape[1]):
        a = xa[:, j].reshape((1, dw) + (1,) * (img.ndim - 2))
        rows = rows + src[:, xi[:, j]] * a
    out = np.zeros((dh, dw) + img.shape[2:], np.float32)
    for j in range(yi.shape[1]):
        b = ya[:, j].reshape((dh,) + (1,) * (img.ndim - 1))
        term = b * rows[yi[:, j]]
        out = term if j == 0 else out + term
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, dsize) -> np.ndarray:
    """`cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST)`, dsize =
    (width, height)."""
    sh, sw = img.shape[:2]
    dw, dh = dsize
    ifx, ify = 1.0 / (dw / sw), 1.0 / (dh / sh)
    xs = np.minimum(np.floor(np.arange(dw) * ifx).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(dh) * ify).astype(np.int64), sh - 1)
    return np.ascontiguousarray(img[ys[:, None], xs[None, :]])


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H, W) uint8, as `cv2.cvtColor(img, COLOR_BGR2GRAY)`."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


# ---------------------------------------------------------------- float32

# OpenCV's border codes
BORDER_CONSTANT, BORDER_REFLECT, BORDER_REFLECT_101 = 0, 2, 4

# getGaussianKernel's fixed kernels for sigma <= 0
_SMALL_GAUSSIANS = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
                    9: [4 / 256, 13 / 256, 30 / 256, 51 / 256, 60 / 256, 51 / 256, 30 / 256,
                        13 / 256, 4 / 256]}


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """`cv2.getGaussianKernel(ksize, sigma, CV_32F)` as (ksize,) float32:
    OpenCV's float64 taps (x doubled, so exp(x^2 * -0.125 / sigma^2)), each
    divided by their sum, then rounded to float32."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIANS:
        return np.array(_SMALL_GAUSSIANS[ksize], np.float32)
    s = sigma if sigma > 0 else ksize * 0.15 + 0.35
    scale = -0.125 / (s * s)
    half = (ksize - 1) // 2
    taps = [math.exp(float(x * x) * scale) for x in range(1 - ksize, 1 - ksize + 2 * half, 2)]
    total = 0.0
    for t in taps:
        total += t
    total = total * 2 + 1 + (ksize % 2 == 0)
    mul = 1.0 / total
    out = np.full(ksize, mul)
    for i, t in enumerate(taps):
        out[i] = out[ksize - 1 - i] = t * mul
    return out.astype(np.float32)


def _host():
    from htd_tpu_torch.ops import _build

    return _build.load_host()[0]


def _f32_image(x: np.ndarray):
    """A C-contiguous float32 copy of x as (H, W, cn), and whether x was 2-D."""
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim not in (2, 3) or 0 in x.shape:
        raise ValueError(f"expected a non-empty (H, W) or (H, W, C) image, got {x.shape}")
    return (x[..., None] if x.ndim == 2 else x), x.ndim == 2


def _call(name: str, *args) -> None:
    code = getattr(_host(), name)(*args)
    if code:
        raise (MemoryError if code == 2 else ValueError)(f"{name}: bad arguments ({code})")


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def gaussian_blur(x: np.ndarray, ksize, sigma_x: float, sigma_y: float = 0.0,
                  border: int = BORDER_REFLECT_101) -> np.ndarray:
    """`cv2.GaussianBlur(x, ksize, sigma_x, sigmaY=sigma_y, borderType=border)`
    for float32, ksize = (width, height) odd; border BORDER_REFLECT or
    BORDER_REFLECT_101 (OpenCV's default), reflected as often as a kernel
    wider than the image needs."""
    img, squeeze = _f32_image(x)
    h, w, cn = img.shape
    kw, kh = ksize
    kx = gaussian_kernel(kw, sigma_x) if w > 1 else np.ones(1, np.float32)
    ky = gaussian_kernel(kh, sigma_y if sigma_y > 0 else sigma_x) if h > 1 else np.ones(
        1, np.float32)
    out = np.empty_like(img)
    _call("htd_sep_filter_f32", _ptr(img), h, w, cn, _ptr(kx), kx.size, _ptr(ky), ky.size,
          border, _ptr(out))
    return out[..., 0] if squeeze else out


def filter2d(x: np.ndarray, kernel: np.ndarray, border: int = BORDER_REFLECT_101) -> np.ndarray:
    """`cv2.filter2D(x, -1, kernel, borderType=border)` for float32: the
    correlation with `kernel`, anchored at its centre."""
    img, squeeze = _f32_image(x)
    k = np.ascontiguousarray(kernel, np.float32)
    if k.ndim != 2:
        raise ValueError(f"expected a 2-D kernel, got {k.shape}")
    out = np.empty_like(img)
    _call("htd_filter2d_f32", _ptr(img), *img.shape, _ptr(k), *k.shape, border, _ptr(out))
    return out[..., 0] if squeeze else out


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """`cv2.getRotationMatrix2D(center, angle, scale)`: (2, 3) float64, the
    centre rounded to float32 as OpenCV's Point2f holds it."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def affine_transform(src, dst) -> np.ndarray:
    """`cv2.getAffineTransform(src, dst)` for three float32 points each:
    (2, 3) float64 from OpenCV's LU solve (partial pivoting, no fused
    products), zeros where the points are collinear."""
    src = np.asarray(src, np.float32).astype(np.float64)
    dst = np.asarray(dst, np.float32).astype(np.float64)
    a = [[0.0] * 6 for _ in range(6)]
    b = [0.0] * 6
    for i in range(3):
        a[2 * i][0:3] = a[2 * i + 1][3:6] = [float(src[i, 0]), float(src[i, 1]), 1.0]
        b[2 * i], b[2 * i + 1] = float(dst[i, 0]), float(dst[i, 1])
    eps = np.finfo(np.float64).eps * 100
    for i in range(6):
        k = max(range(i, 6), key=lambda j: (abs(a[j][i]), -j))
        if abs(a[k][i]) < eps:
            return np.zeros((2, 3))
        a[i], a[k], b[i], b[k] = a[k], a[i], b[k], b[i]
        d = -1 / a[i][i]
        for j in range(i + 1, 6):
            alpha = a[j][i] * d
            for c in range(i + 1, 6):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(5, -1, -1):
        s = b[i]
        for c in range(i + 1, 6):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.array(b).reshape(2, 3)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """warpAffine's inversion of the forward map, in float64."""
    m = [float(v) for v in np.asarray(m, np.float64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m)


def warp_affine(x: np.ndarray, m: np.ndarray, dsize, border: int = BORDER_CONSTANT) -> np.ndarray:
    """`cv2.warpAffine(x, m, dsize, flags=INTER_LINEAR, borderMode=border)`
    for float32 (a constant border is 0): the inverse of m in float64, then
    rounded to float32 for the per-pixel arithmetic."""
    img, squeeze = _f32_image(x)
    w, h = dsize
    inv = _invert_affine(m).astype(np.float32)
    out = np.empty((h, w, img.shape[2]), np.float32)
    _call("htd_warp_affine_f32", _ptr(img), *img.shape, _ptr(inv), h, w, border, _ptr(out))
    return out[..., 0] if squeeze else out


def remap(x: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          border: int = BORDER_CONSTANT) -> np.ndarray:
    """`cv2.remap(x, map_x, map_y, INTER_LINEAR, borderMode=border)` for
    float32 images and float32 maps of the output's (H, W)."""
    img, squeeze = _f32_image(x)
    mx = np.ascontiguousarray(map_x, np.float32)
    my = np.ascontiguousarray(map_y, np.float32)
    if mx.ndim != 2 or mx.shape != my.shape:
        raise ValueError(f"maps must be two equal (H, W) arrays, got {mx.shape}, {my.shape}")
    out = np.empty(mx.shape + (img.shape[2],), np.float32)
    _call("htd_remap_f32", _ptr(img), *img.shape, _ptr(mx), _ptr(my), *mx.shape, border,
          _ptr(out))
    return out[..., 0] if squeeze else out


def resize_linear(x: np.ndarray, dsize) -> np.ndarray:
    """`cv2.resize(x, dsize, interpolation=INTER_LINEAR)` for float32, dsize =
    (width, height)."""
    img, squeeze = _f32_image(x)
    w, h = dsize
    out = np.empty((h, w, img.shape[2]), np.float32)
    _call("htd_resize_linear_f32", _ptr(img), *img.shape, h, w, _ptr(out))
    return out[..., 0] if squeeze else out
