"""Image corruptions for robustness testing: the port of
`htd_tpu/data/corruptions.py` (the ImageNet-C corruptions of Hendrycks &
Dietterich, ICLR 2019, as the reference's `Corrupt` pipeline step applies
them to the raw image before Resize).

All 19 corruptions of the registry (`BENCHMARK_CORRUPTIONS`,
`HOLDOUT_CORRUPTIONS`, `ALL_CORRUPTIONS`, `GROUPS`) are here, each a copy of
the JAX package's function with the same `RandomState` draws in the same
order, bit-equal to it on uint8 BGR images. Where the reference calls
OpenCV or PIL, the port calls its own copy of the routine:
- the noises, `fog`, `contrast` and the pixel swaps of `glass_blur`: the
  same numpy arithmetic;
- `brightness`, `saturate`: OpenCV's uint8 BGR/HSV conversions,
  `data.imgproc.bgr_to_hsv` / `hsv_to_bgr`;
- `pixelate`: `imgproc.resize_area` / `resize_nearest`;
- `jpeg_compression`: PIL's JPEG round trip, `data.jpeg.compress_roundtrip`;
- the blurs, `snow`, `frost`, `elastic_transform`, `spatter`: OpenCV's
  float32 `GaussianBlur`, `filter2D`, `warpAffine`, `remap` and INTER_LINEAR
  `resize`, `getRotationMatrix2D`, `getAffineTransform` and uint8
  `BGR2GRAY`, as `data.imgproc` reproduces them.
"""

from __future__ import annotations

import numpy as np

from htd_tpu_torch.data import imgproc
from htd_tpu_torch.data.jpeg import compress_roundtrip

# corruption name groups (reference tools/test_robustness.py:203-236)
BENCHMARK_CORRUPTIONS = [
    "gaussian_noise", "shot_noise", "impulse_noise",
    "defocus_blur", "glass_blur", "motion_blur", "zoom_blur",
    "snow", "frost", "fog", "brightness",
    "contrast", "elastic_transform", "pixelate", "jpeg_compression",
]
HOLDOUT_CORRUPTIONS = ["speckle_noise", "gaussian_blur", "spatter", "saturate"]
ALL_CORRUPTIONS = BENCHMARK_CORRUPTIONS + HOLDOUT_CORRUPTIONS
GROUPS = {
    "noise": ["gaussian_noise", "shot_noise", "impulse_noise"],
    "blur": ["defocus_blur", "glass_blur", "motion_blur", "zoom_blur"],
    "weather": ["snow", "frost", "fog", "brightness"],
    "digital": ["contrast", "elastic_transform", "pixelate", "jpeg_compression"],
    "benchmark": BENCHMARK_CORRUPTIONS,
    "holdout": HOLDOUT_CORRUPTIONS,
    "all": ALL_CORRUPTIONS,
}


def _to_float(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def _rng(seed: int) -> np.random.RandomState:
    return np.random.RandomState(seed)


# ---------------------------------------------------------------- noise


def gaussian_noise(img, severity, seed=0):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    x = _to_float(img)
    return _to_uint8(x + _rng(seed).normal(size=x.shape, scale=c))


def shot_noise(img, severity, seed=0):
    c = [60, 25, 12, 5, 3][severity - 1]
    x = _to_float(img)
    return _to_uint8(_rng(seed).poisson(x * c) / float(c))


def impulse_noise(img, severity, seed=0):
    """Salt & pepper: fraction c of pixels forced to 0 or 1."""
    c = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    x = _to_float(img)
    r = _rng(seed)
    flip = r.uniform(size=x.shape) < c
    salt = r.uniform(size=x.shape) < 0.5
    x = np.where(flip, np.where(salt, 1.0, 0.0), x)
    return _to_uint8(x)


def speckle_noise(img, severity, seed=0):
    c = [0.15, 0.2, 0.35, 0.45, 0.6][severity - 1]
    x = _to_float(img)
    return _to_uint8(x + x * _rng(seed).normal(size=x.shape, scale=c))


# ---------------------------------------------------------------- blur


def _gaussian_blur(x: np.ndarray, sigma: float) -> np.ndarray:
    k = int(2 * round(3.5 * sigma) + 1)
    return imgproc.gaussian_blur(x, (k, k), sigma, border=imgproc.BORDER_REFLECT)


def gaussian_blur(img, severity, seed=0):
    c = [1, 2, 3, 4, 6][severity - 1]
    return _to_uint8(_gaussian_blur(_to_float(img), c))


def _disk_kernel(radius: int, alias_blur: float) -> np.ndarray:
    if radius <= 8:
        coords = np.arange(-8, 8 + 1)
        ksize = (3, 3)
    else:
        coords = np.arange(-radius, radius + 1)
        ksize = (5, 5)
    xx, yy = np.meshgrid(coords, coords)
    disk = ((xx ** 2 + yy ** 2) <= radius ** 2).astype(np.float32)
    disk /= disk.sum()
    return imgproc.gaussian_blur(disk, ksize, alias_blur)


def defocus_blur(img, severity, seed=0):
    radius, alias = [(3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5), (10, 0.5)][severity - 1]
    x = _to_float(img)
    kern = _disk_kernel(radius, alias)
    return _to_uint8(imgproc.filter2d(x, kern, border=imgproc.BORDER_REFLECT))


def glass_blur(img, severity, seed=0):
    """Gaussian blur + iterated local pixel swaps (vectorized: each pass
    swaps every interior pixel with a random neighbour within max_delta)."""
    sigma, max_delta, iters = [
        (0.7, 1, 2), (0.9, 2, 1), (1.0, 2, 3), (1.1, 3, 2), (1.5, 4, 2)
    ][severity - 1]
    r = _rng(seed)
    x = _gaussian_blur(_to_float(img), sigma)
    h, w = x.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(iters):
        dy = r.randint(-max_delta, max_delta + 1, size=(h, w))
        dx = r.randint(-max_delta, max_delta + 1, size=(h, w))
        ny = np.clip(ys + dy, 0, h - 1)
        nx = np.clip(xs + dx, 0, w - 1)
        swapped = x[ny, nx]
        # the reference's two fancy-index assignments, repeated indices and
        # all (numpy keeps the last write)
        x[ys, xs], x[ny, nx] = swapped, x[ys, xs].copy()
    return _to_uint8(_gaussian_blur(x, sigma))


def motion_blur(img, severity, seed=0):
    size, sigma = [(10, 3), (15, 5), (15, 8), (15, 12), (20, 15)][severity - 1]
    angle = _rng(seed).uniform(-45, 45)
    # line kernel of length `size` blurred along its axis with `sigma`
    k = np.zeros((size, size), np.float32)
    k[size // 2, :] = 1.0
    k = imgproc.gaussian_blur(k, (1, 2 * int(sigma) + 1), 0, sigma)
    rot = imgproc.rotation_matrix_2d((size / 2 - 0.5, size / 2 - 0.5), angle, 1.0)
    k = imgproc.warp_affine(k, rot, (size, size))
    k /= max(k.sum(), 1e-8)
    x = _to_float(img)
    return _to_uint8(imgproc.filter2d(x, k, border=imgproc.BORDER_REFLECT))


def zoom_blur(img, severity, seed=0):
    c = [
        np.arange(1, 1.11, 0.01), np.arange(1, 1.16, 0.01),
        np.arange(1, 1.21, 0.02), np.arange(1, 1.26, 0.02),
        np.arange(1, 1.31, 0.03),
    ][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    out = np.zeros_like(x)
    for zoom in c:
        zh, zw = int(np.ceil(h * zoom)), int(np.ceil(w * zoom))
        z = imgproc.resize_linear(x, (zw, zh))
        top, left = (zh - h) // 2, (zw - w) // 2
        out += z[top : top + h, left : left + w]
    return _to_uint8((x + out) / (len(c) + 1))


# ---------------------------------------------------------------- weather


def _plasma_fractal(h: int, w: int, wibbledecay: float, r: np.random.RandomState):
    """Diamond-square fractal noise in [0, 1] at the next pow2 size >= (h, w)."""
    size = 1
    while size < max(h, w):
        size *= 2
    arr = np.zeros((size + 1, size + 1), np.float32)
    step, wibble = size, 100.0

    def wibbled(shape):
        return r.uniform(-wibble, wibble, shape).astype(np.float32)

    while step > 1:
        half = step // 2
        # diamond
        sq = arr[0:size:step, 0:size:step]
        diag = (
            sq + np.roll(sq, -1, 0) + np.roll(sq, -1, 1) + np.roll(np.roll(sq, -1, 0), -1, 1)
        ) / 4.0
        arr[half:size:step, half:size:step] = diag + wibbled(diag.shape)
        # square
        d = arr[half:size:step, half:size:step]
        up = (np.roll(d, 1, 0) + d + np.roll(sq, -1, 1) + sq) / 4.0
        arr[0:size:step, half:size:step] = up + wibbled(up.shape)
        left = (np.roll(d, 1, 1) + d + np.roll(sq, -1, 0) + sq) / 4.0
        arr[half:size:step, 0:size:step] = left + wibbled(left.shape)
        step, wibble = half, wibble / wibbledecay
    arr = arr[:h, :w]
    arr -= arr.min()
    return arr / max(arr.max(), 1e-8)


def fog(img, severity, seed=0):
    c, decay = [(1.5, 2), (2.0, 2), (2.5, 1.7), (2.5, 1.5), (3.0, 1.4)][severity - 1]
    x = _to_float(img)
    mx = x.max()
    layer = _plasma_fractal(x.shape[0], x.shape[1], decay, _rng(seed))
    x = x + c * layer[..., None]
    return _to_uint8(x * mx / max(mx + c, 1e-8))


def frost(img, severity, seed=0):
    """Procedural frost (the reference's: no bundled textures)."""
    xw, fw = [(1.0, 0.4), (0.8, 0.6), (0.7, 0.7), (0.65, 0.7), (0.6, 0.75)][
        severity - 1
    ]
    x = _to_float(img)
    r = _rng(seed)
    h, w = x.shape[:2]
    base = _plasma_fractal(h, w, 1.8, r)
    crystals = _gaussian_blur(r.uniform(size=(h, w)).astype(np.float32), 1.0)
    layer = np.clip((base * 0.6 + crystals * 0.6) - 0.35, 0, 1) * 1.6
    layer = np.clip(layer, 0, 1)[..., None] * np.array([1.0, 0.98, 0.94], np.float32)
    return _to_uint8(xw * x + fw * layer)


def snow(img, severity, seed=0):
    loc, scale, zoom, thr, blur_sigma, blend = [
        (0.1, 0.3, 3.0, 0.5, 4, 0.8),
        (0.2, 0.3, 2.0, 0.5, 4, 0.7),
        (0.55, 0.3, 4.0, 0.9, 8, 0.7),
        (0.55, 0.3, 4.5, 0.85, 8, 0.65),
        (0.55, 0.3, 2.5, 0.85, 12, 0.55),
    ][severity - 1]
    r = _rng(seed)
    x = _to_float(img)
    h, w = x.shape[:2]
    layer = r.normal(size=(h, w), loc=loc, scale=scale).astype(np.float32)
    zh, zw = int(np.ceil(h * zoom)), int(np.ceil(w * zoom))
    layer = imgproc.resize_linear(layer, (zw, zh))[:h, :w]
    layer[layer < thr] = 0.0
    # streak the flakes like the motion-blurred reference layer
    k = np.zeros((blur_sigma * 2 + 1, blur_sigma * 2 + 1), np.float32)
    k[:, blur_sigma] = 1.0
    ang = imgproc.rotation_matrix_2d((blur_sigma, blur_sigma), r.uniform(-135, -45), 1.0)
    k = imgproc.warp_affine(k, ang, k.shape[::-1])
    k /= max(k.sum(), 1e-8)
    layer = imgproc.filter2d(layer, k)[..., None]
    gray = imgproc.bgr_to_gray(_to_uint8(x)).astype(np.float32) / 255.0
    whitened = blend * x + (1 - blend) * np.maximum(x, gray[..., None] * 1.5 + 0.5)
    return _to_uint8(np.clip(whitened + layer + np.rot90(layer, 2), 0, 1))


def brightness(img, severity, seed=0):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    hsv = imgproc.bgr_to_hsv(img).astype(np.float32)
    hsv[..., 2] = np.clip(hsv[..., 2] + c * 255.0, 0, 255)
    return imgproc.hsv_to_bgr(hsv.astype(np.uint8))


def saturate(img, severity, seed=0):
    mul, add = [(0.3, 0), (0.1, 0), (2.0, 0), (5.0, 0.1), (20.0, 0.2)][severity - 1]
    hsv = imgproc.bgr_to_hsv(img).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * mul + add * 255.0, 0, 255)
    return imgproc.hsv_to_bgr(hsv.astype(np.uint8))


# ---------------------------------------------------------------- digital


def contrast(img, severity, seed=0):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    x = _to_float(img)
    mean = x.mean(axis=(0, 1), keepdims=True)
    return _to_uint8((x - mean) * c + mean)


def elastic_transform(img, severity, seed=0):
    """Affine jitter + gaussian-smoothed random displacement field."""
    h, w = img.shape[:2]
    shape_size = np.array([h, w], np.float32)
    # (displacement alpha, field sigma, affine sigma) as fractions of size
    a, s, aff = [
        (0.05, 0.3, 0.06), (0.065, 0.3, 0.06), (0.085, 0.22, 0.045),
        (0.11, 0.16, 0.03), (0.16, 0.1, 0.02),
    ][severity - 1]
    alpha = a * min(h, w)
    sigma = s * min(h, w)
    r = _rng(seed)

    center = shape_size[::-1] / 2.0  # (x, y)
    sq = min(h, w) // 3
    pts1 = np.float32([
        center + sq, [center[0] + sq, center[1] - sq], center - sq
    ])
    pts2 = pts1 + r.uniform(-aff * min(h, w), aff * min(h, w), pts1.shape).astype(
        np.float32
    )
    m = imgproc.affine_transform(pts1, pts2)
    x = imgproc.warp_affine(_to_float(img), m, (w, h), border=imgproc.BORDER_REFLECT_101)

    k = int(2 * round(3 * sigma) + 1)
    dx = imgproc.gaussian_blur(r.uniform(-1, 1, (h, w)).astype(np.float32), (k, k), sigma) * alpha
    dy = imgproc.gaussian_blur(r.uniform(-1, 1, (h, w)).astype(np.float32), (k, k), sigma) * alpha
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    out = imgproc.remap(x, xs + dx, ys + dy, border=imgproc.BORDER_REFLECT_101)
    return _to_uint8(out)


def pixelate(img, severity, seed=0):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w = img.shape[:2]
    small = imgproc.resize_area(img, (max(int(w * c), 1), max(int(h * c), 1)))
    return imgproc.resize_nearest(small, (w, h))


def jpeg_compression(img, severity, seed=0):
    c = [25, 18, 15, 10, 7][severity - 1]
    return compress_roundtrip(img, c)


def spatter(img, severity, seed=0):
    """Water (sev 1-3: glossy highlight blobs) / mud (sev 4-5: brown blobs)."""
    loc, scale, sigma, thr, mud = [
        (0.65, 0.3, 4, 0.69, False), (0.65, 0.3, 3, 0.68, False),
        (0.65, 0.3, 2, 0.68, False), (0.65, 0.3, 1, 0.65, True),
        (0.67, 0.4, 1, 0.65, True),
    ][severity - 1]
    r = _rng(seed)
    x = _to_float(img)
    h, w = x.shape[:2]
    liquid = r.normal(size=(h, w), loc=loc, scale=scale).astype(np.float32)
    liquid = _gaussian_blur(liquid, sigma)
    mask = (liquid > thr).astype(np.float32)
    mask = _gaussian_blur(mask, 0.8)
    if not mud:
        # water: bluish translucent sheen
        color = np.array([0.85, 0.7, 0.55], np.float32)  # BGR light blue
        return _to_uint8(x * (1 - 0.55 * mask[..., None]) +
                         0.55 * mask[..., None] * color)
    color = np.array([0.24, 0.42, 0.63], np.float32)  # BGR mud brown
    return _to_uint8(x * (1 - mask[..., None]) + mask[..., None] * color)


_CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "speckle_noise": speckle_noise,
    "gaussian_blur": gaussian_blur,
    "defocus_blur": defocus_blur,
    "glass_blur": glass_blur,
    "motion_blur": motion_blur,
    "zoom_blur": zoom_blur,
    "snow": snow,
    "frost": frost,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
    "spatter": spatter,
    "saturate": saturate,
}


def corrupt(
    img: np.ndarray, corruption: str, severity: int, seed: int = 0
) -> np.ndarray:
    """Apply `corruption` at `severity` in [1, 5] to a uint8 BGR image.

    Severity 0 returns the image unchanged (reference test_robustness.py:243
    treats severity 0 as the clean baseline)."""
    if severity == 0:
        return img
    if not 1 <= severity <= 5:
        raise ValueError(f"severity must be in [0, 5], got {severity}")
    if corruption not in _CORRUPTIONS:
        raise ValueError(
            f"unknown corruption {corruption!r}; options: {sorted(_CORRUPTIONS)}"
        )
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 HWC BGR image, got {img.dtype} {img.shape}")
    return _CORRUPTIONS[corruption](img, severity, seed=seed)


class CorruptedDataset:
    """Dataset proxy applying a corruption to every loaded image.

    Equivalent to the reference inserting `dict(type='Corrupt', ...)` right
    after image loading in the test pipeline (test_robustness.py:251-258) —
    the corruption sees the raw full-resolution image, before Resize.
    The per-image seed is derived from the img_id so results are
    deterministic and independent of batch order.
    """

    def __init__(self, dataset, corruption: str, severity: int, seed: int = 0):
        self._dataset = dataset
        self.corruption = corruption
        self.severity = severity
        self.seed = seed

    def __getattr__(self, name):
        return getattr(self._dataset, name)

    def __len__(self):
        return len(self._dataset)

    def load_image(self, rec) -> np.ndarray:
        img = self._dataset.load_image(rec)
        return corrupt(
            img, self.corruption, self.severity,
            seed=(self.seed * 1_000_003 + int(rec.img_id)) % (2 ** 31),
        )
