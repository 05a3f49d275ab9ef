"""Image corruptions for robustness testing: the port of
`htd_tpu/data/corruptions.py` (the ImageNet-C corruptions of Hendrycks &
Dietterich, ICLR 2019, as the reference's `Corrupt` pipeline step applies
them to the raw image before Resize).

The registry (`BENCHMARK_CORRUPTIONS`, `HOLDOUT_CORRUPTIONS`,
`ALL_CORRUPTIONS`, `GROUPS`), `corrupt` and `CorruptedDataset` name all 19
corruptions. Ten of them are ported (`PORTED_CORRUPTIONS`), each bit-equal
to the JAX package's on uint8 BGR images:
- the four noises, `fog` and `contrast`: the same numpy arithmetic and
  `RandomState` draws;
- `brightness` and `saturate`: OpenCV's uint8 BGR/HSV conversions, here
  `data.imgproc.bgr_to_hsv` / `hsv_to_bgr`;
- `pixelate`: OpenCV's `INTER_AREA` and `INTER_NEAREST` resizes, here
  `data.imgproc.resize_area` / `resize_nearest`;
- `jpeg_compression`: PIL's JPEG round trip, here
  `data.jpeg.compress_roundtrip` (libjpeg-turbo's arithmetic, the decoder's
  back end in C++).
The other nine (the blurs, `snow`, `frost`, `elastic_transform`,
`spatter`) rest on OpenCV's float32 filters and warps, which the port has
not reproduced yet: `corrupt` raises `NotImplementedError` for them.
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


def pixelate(img, severity, seed=0):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w = img.shape[:2]
    small = imgproc.resize_area(img, (max(int(w * c), 1), max(int(h * c), 1)))
    return imgproc.resize_nearest(small, (w, h))


def jpeg_compression(img, severity, seed=0):
    c = [25, 18, 15, 10, 7][severity - 1]
    return compress_roundtrip(img, c)


_CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "speckle_noise": speckle_noise,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
    "saturate": saturate,
}
PORTED_CORRUPTIONS = [c for c in ALL_CORRUPTIONS if c in _CORRUPTIONS]


def corrupt(
    img: np.ndarray, corruption: str, severity: int, seed: int = 0
) -> np.ndarray:
    """Apply `corruption` at `severity` in [1, 5] to a uint8 BGR image.

    Severity 0 returns the image unchanged (reference test_robustness.py:243
    treats severity 0 as the clean baseline). A corruption of the registry
    that is not ported yet raises `NotImplementedError`."""
    if severity == 0:
        return img
    if not 1 <= severity <= 5:
        raise ValueError(f"severity must be in [0, 5], got {severity}")
    if corruption not in ALL_CORRUPTIONS:
        raise ValueError(
            f"unknown corruption {corruption!r}; options: {sorted(ALL_CORRUPTIONS)}"
        )
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 HWC BGR image, got {img.dtype} {img.shape}")
    if corruption not in _CORRUPTIONS:
        raise NotImplementedError(
            f"corruption {corruption!r} is not ported yet; ported: {PORTED_CORRUPTIONS}"
        )
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
