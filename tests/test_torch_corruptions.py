"""The port's corruptions (`htd_tpu_torch.data.corruptions`) against the
JAX package's (`htd_tpu.data.corruptions`), bit for bit: all 19 at every
severity on two seeds and on odd and even sizes, down to 1x1 and below
`elastic_transform`'s kernel; the registry; `corrupt`'s errors;
`CorruptedDataset`'s per-image seed and attribute proxy. Also the OpenCV
routines behind them (`data.imgproc`) against cv2 itself, bit for bit, on
the sizes, sigmas, kernels and borders the corruptions use and on row
widths that pick each routine's vector loop and scalar tail."""

import cv2
import numpy as np
import pytest
import torch

from htd_tpu.data import corruptions as J
from htd_tpu_torch.data import corruptions as P
from htd_tpu_torch.data import imgproc
from tests.jpeg_fixtures import pattern

torch.set_num_threads(1)
SIZES = [(1, 1), (5, 3), (37, 50), (64, 48), (101, 130)]


@pytest.mark.parametrize("name", P.ALL_CORRUPTIONS)
def test_corruption_matches_jax(name):
    for i, (h, w) in enumerate(SIZES):
        img = pattern(i, h, w)
        for severity in range(1, 6):
            for seed in (0, 1234567):
                np.testing.assert_array_equal(P.corrupt(img, name, severity, seed),
                                              J.corrupt(img, name, severity, seed),
                                              err_msg=f"{name} {h}x{w} {severity} {seed}")


def test_registry_matches_jax():
    assert P.BENCHMARK_CORRUPTIONS == J.BENCHMARK_CORRUPTIONS
    assert P.HOLDOUT_CORRUPTIONS == J.HOLDOUT_CORRUPTIONS
    assert P.ALL_CORRUPTIONS == J.ALL_CORRUPTIONS
    assert P.GROUPS == J.GROUPS
    img = pattern(0, 8, 8)
    for name in P.ALL_CORRUPTIONS:
        assert P.corrupt(img, name, 1).shape == img.shape


@pytest.mark.parametrize("name,severity,dtype,shape", [
    ("gaussian_noise", 6, np.uint8, (8, 8, 3)), ("gaussian_noise", -1, np.uint8, (8, 8, 3)),
    ("no_such_thing", 1, np.uint8, (8, 8, 3)), ("fog", 1, np.float32, (8, 8, 3)),
    ("fog", 1, np.uint8, (8, 8)), ("motion_blur", 1, np.uint8, (8, 8))])
def test_corrupt_errors_match_jax(name, severity, dtype, shape):
    """The same ValueErrors as the JAX package, with the same messages;
    severity 0 is the image itself."""
    img = np.zeros(shape, dtype)
    with pytest.raises(ValueError) as want:
        J.corrupt(img, name, severity)
    with pytest.raises(ValueError) as got:
        P.corrupt(img, name, severity)
    assert str(got.value) == str(want.value)
    assert P.corrupt(img, name, 0) is img


class _Records:
    """A dataset stub: records with img_id, images from a seed per id."""

    class Rec:
        def __init__(self, img_id):
            self.img_id = img_id

    records = [Rec(5), Rec(2**40 + 7)]
    extra = "proxied"

    def __len__(self):
        return len(self.records)

    def load_image(self, rec):
        return pattern(rec.img_id % 97, 21, 34)


@pytest.mark.parametrize("name", ["gaussian_noise", "fog", "elastic_transform"])
def test_corrupted_dataset_matches_jax(name):
    """The per-image seed (seed * 1_000_003 + img_id) mod 2**31 and the
    attribute proxy, against the JAX package's CorruptedDataset."""
    ds = _Records()
    p, j = P.CorruptedDataset(ds, name, 3, seed=11), J.CorruptedDataset(ds, name, 3, seed=11)
    assert len(p) == 2 and p.records is ds.records and p.extra == "proxied"
    for rec in ds.records:
        np.testing.assert_array_equal(p.load_image(rec), j.load_image(rec))
        want = P.corrupt(ds.load_image(rec), name, 3, seed=(11 * 1_000_003 + rec.img_id) % 2**31)
        np.testing.assert_array_equal(p.load_image(rec), want)


@pytest.mark.parametrize("hw", [(7, 9), (33, 48), (64, 96), (427, 640)])
def test_imgproc_matches_cv2(hw):
    """The HSV round trip (OpenCV's vector loop and scalar tail per row),
    both resizes (the 2x2 and other whole-factor fast paths and the general
    area path, picked by the sizes) and BGR2GRAY against cv2 itself."""
    h, w = hw
    img = pattern(h, h, w, noise=90)
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    np.testing.assert_array_equal(imgproc.bgr_to_hsv(img), hsv)
    np.testing.assert_array_equal(imgproc.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    for c in (0.6, 0.5, 0.4, 0.3, 0.25, 1 / 3):
        dsize = (max(int(w * c), 1), max(int(h * c), 1))
        small = cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(imgproc.resize_area(img, dsize), small, err_msg=str(c))
        np.testing.assert_array_equal(imgproc.resize_nearest(small, (w, h)),
                                      cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST))
    np.testing.assert_array_equal(imgproc.bgr_to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


def test_bgr_to_gray_every_level():
    """COLOR_BGR2GRAY's fixed point on every B and G level and a third of the R levels."""
    v = np.arange(256)
    b, g, r = np.meshgrid(v, v, v[::3], indexing="ij")
    img = np.stack([b, g, r], -1).reshape(-1, 1, 3).astype(np.uint8)
    np.testing.assert_array_equal(imgproc.bgr_to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


# ---------------------------------------------------------------- float32 routines

# the corruptions' blur sigmas (gaussian_blur, glass_blur, frost, spatter,
# the defocus kernel's alias blur) and two of elastic_transform's
SIGMAS = [0.1, 0.5, 0.7, 0.8, 0.9, 1.0, 1.1, 1.5, 2, 3, 4, 6, 11.1, 19.2]
# row widths (W * channels) that leave every vector loop a scalar tail, or none
SHAPES = [(37, 53, 3), (64, 96, 1), (20, 21, 1), (61, 83, 3), (17, 17, 1), (21, 21, 1),
          (96, 128, 3), (5, 3, 3), (1, 9, 1), (2, 1, 3)]


def _image(shape, seed):
    x = np.random.RandomState(seed).uniform(0, 1, shape).astype(np.float32)
    return x[..., 0] if shape[2] == 1 else x


def test_gaussian_kernel_matches_cv2():
    for ksize in range(1, 62):
        for sigma in (0, 0.3, 0.8, 1, 2.5, 7, 40):
            np.testing.assert_array_equal(imgproc.gaussian_kernel(ksize, sigma),
                                          cv2.getGaussianKernel(ksize, sigma, cv2.CV_32F).ravel(),
                                          err_msg=f"{ksize} {sigma}")


@pytest.mark.parametrize("border", [imgproc.BORDER_REFLECT, imgproc.BORDER_REFLECT_101])
@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_blur_matches_cv2(shape, border):
    """GaussianBlur with the corruptions' kernel sizes (2 round(3.5 sigma) + 1,
    elastic_transform's 2 round(3 sigma) + 1, the disk kernel's 3 and 5),
    kernels wider than the image, one-row and one-column images, and
    motion_blur's vertical-only (1, 2 sigma + 1) kernels."""
    x = _image(shape, len(shape) + shape[0])
    for sigma in SIGMAS:
        for k in {int(2 * round(3.5 * sigma) + 1), int(2 * round(3 * sigma) + 1), 3, 5}:
            np.testing.assert_array_equal(
                imgproc.gaussian_blur(x, (k, k), sigma, border=border),
                cv2.GaussianBlur(x, (k, k), sigmaX=sigma, borderType=border), err_msg=f"{sigma} {k}")
    for s in (3, 5, 8, 12, 15):
        np.testing.assert_array_equal(imgproc.gaussian_blur(x, (1, 2 * s + 1), 0, s, border),
                                      cv2.GaussianBlur(x, (1, 2 * s + 1), sigmaX=0, sigmaY=s,
                                                       borderType=border))


@pytest.mark.parametrize("border", [imgproc.BORDER_REFLECT, imgproc.BORDER_REFLECT_101])
@pytest.mark.parametrize("shape", SHAPES)
def test_filter2d_matches_cv2(shape, border):
    """filter2D with sparse kernels of 9x9 to 11x11 (the direct path:
    motion_blur's 10x10, snow's 9x9) and of 12x12 to 25x25 (OpenCV's float64
    DFT: the disk kernels, motion_blur's and snow's larger ones)."""
    x = _image(shape, 7 + shape[1])
    r = np.random.RandomState(shape[0])
    for k in (9, 10, 11, 12, 17, 21, 25):
        kern = r.uniform(0, 1, (k, k)).astype(np.float32)
        kern[r.uniform(size=(k, k)) < 0.5] = 0
        kern /= kern.sum()
        np.testing.assert_array_equal(imgproc.filter2d(x, kern, border),
                                      cv2.filter2D(x, -1, kern, borderType=border), err_msg=str(k))


@pytest.mark.parametrize("border", [imgproc.BORDER_CONSTANT, imgproc.BORDER_REFLECT_101])
@pytest.mark.parametrize("shape", SHAPES + [(33, 75, 3), (9, 9, 1), (25, 25, 1)])
def test_warp_affine_and_remap_match_cv2(shape, border):
    """warpAffine by rotation matrices (motion_blur's and snow's kernels,
    constant border) and by affine_transform's jittered maps
    (elastic_transform, BORDER_REFLECT_101), the forward maps inverted as
    OpenCV inverts them; remap with maps of the displaced grid."""
    h, w = shape[:2]
    x = _image(shape, 3 * h + w)
    r = np.random.RandomState(w)
    for _ in range(3):
        m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), r.uniform(-135, 135), 1.0)
        np.testing.assert_array_equal(imgproc.warp_affine(x, m, (w, h), border),
                                      cv2.warpAffine(x, m, (w, h), borderMode=border))
        c, sq = np.float32([w, h]) / 2, min(h, w) // 3
        p1 = np.float32([c + sq, [c[0] + sq, c[1] - sq], c - sq])
        p2 = (p1 + r.uniform(-3, 3, p1.shape)).astype(np.float32)
        m = cv2.getAffineTransform(p1, p2)
        np.testing.assert_array_equal(imgproc.warp_affine(x, m, (w, h), border),
                                      cv2.warpAffine(x, m, (w, h), borderMode=border))
        xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        mx = xs + r.uniform(-4, 4, (h, w)).astype(np.float32)
        my = ys + r.uniform(-4, 4, (h, w)).astype(np.float32)
        np.testing.assert_array_equal(imgproc.remap(x, mx, my, border),
                                      cv2.remap(x, mx, my, cv2.INTER_LINEAR, borderMode=border))


@pytest.mark.parametrize("shape", SHAPES + [(1, 40, 1), (9, 1, 1), (1, 1, 3), (1, 2, 1)])
def test_resize_linear_matches_cv2(shape):
    """resize INTER_LINEAR upscaling by zoom_blur's ratios (1.01-1.3) and
    snow's (2-4.5), to ceil(side * ratio) as they ask for it; sources of
    one row or one column too (OpenCV's older generic path)."""
    h, w = shape[:2]
    x = _image(shape, h * w)
    for z in (1.01, 1.07, 1.1, 1.13, 1.2, 1.29, 2.0, 2.5, 3.0, 4.5):
        dsize = (int(np.ceil(w * z)), int(np.ceil(h * z)))
        np.testing.assert_array_equal(imgproc.resize_linear(x, dsize),
                                      cv2.resize(x, dsize, interpolation=cv2.INTER_LINEAR),
                                      err_msg=str(z))


def test_matrices_match_cv2():
    """getRotationMatrix2D and getAffineTransform (OpenCV's LU solve, and
    zeros for collinear points) bit for bit."""
    r = np.random.RandomState(11)
    for _ in range(300):
        center, angle = (r.uniform(0, 50), r.uniform(0, 50)), r.uniform(-180, 180)
        np.testing.assert_array_equal(imgproc.rotation_matrix_2d(center, angle, 1.0),
                                      cv2.getRotationMatrix2D(center, angle, 1.0))
        h, w = r.randint(1, 900, 2)
        c, sq = np.float32([w, h]) / 2, min(h, w) // 3
        p1 = np.float32([c + sq, [c[0] + sq, c[1] - sq], c - sq])
        p2 = (p1 + r.uniform(-0.06, 0.06, p1.shape) * min(h, w)).astype(np.float32)
        np.testing.assert_array_equal(imgproc.affine_transform(p1, p2),
                                      cv2.getAffineTransform(p1, p2))
