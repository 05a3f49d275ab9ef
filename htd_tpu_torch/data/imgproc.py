"""OpenCV's uint8 colour conversions and resizes that the corruptions use,
in numpy on the host, bit for bit.

- `bgr_to_hsv`: `cv2.cvtColor(img, COLOR_BGR2HSV)` for uint8 (H in 0-179):
  the fixed-point division tables `sdiv_table` and `hdiv_table180` with
  `hsv_shift = 12` and their rounding.
- `hsv_to_bgr`: `COLOR_HSV2BGR` for uint8: float32 arithmetic on S and V
  scaled by 1/255 with OpenCV's fused multiply-adds, each channel times
  255 truncated in OpenCV's vector loop and rounded in its scalar tail.
- `resize_area`: `cv2.resize(..., INTER_AREA)` when shrinking: the
  whole-factor fast path (2x2 as `(a + b + c + d + 2) >> 2`, other factors
  as the int sum times the float reciprocal of the area) and the general
  path with float32 area weights summed in OpenCV's order.
- `resize_nearest`: `cv2.resize(..., INTER_NEAREST)`, source index
  `floor(x * (1 / fx))` in double precision.
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
