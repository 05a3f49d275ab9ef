"""The port's corruptions (`htd_tpu_torch.data.corruptions`) against the
JAX package's (`htd_tpu.data.corruptions`), bit for bit: every ported
corruption at every severity on two seeds and on odd and even sizes; the
registry; `corrupt`'s errors; `NotImplementedError` for the nine
corruptions not ported; `CorruptedDataset`'s per-image seed and attribute
proxy. Also the OpenCV routines behind them (`data.imgproc`) against cv2
itself on the shapes that pick their other code paths."""

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
UNPORTED = ["defocus_blur", "glass_blur", "motion_blur", "zoom_blur", "snow", "frost",
            "elastic_transform", "gaussian_blur", "spatter"]


@pytest.mark.parametrize("name", P.PORTED_CORRUPTIONS)
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
    assert sorted(P.PORTED_CORRUPTIONS + UNPORTED) == sorted(P.ALL_CORRUPTIONS)


@pytest.mark.parametrize("name,severity,dtype,shape", [
    ("gaussian_noise", 6, np.uint8, (8, 8, 3)), ("gaussian_noise", -1, np.uint8, (8, 8, 3)),
    ("no_such_thing", 1, np.uint8, (8, 8, 3)), ("fog", 1, np.float32, (8, 8, 3)),
    ("fog", 1, np.uint8, (8, 8)), ("motion_blur", 1, np.uint8, (8, 8))])
def test_corrupt_errors_match_jax(name, severity, dtype, shape):
    """The same ValueErrors as the JAX package, with the same messages (an
    unported corruption's bad image too); severity 0 is the image itself."""
    img = np.zeros(shape, dtype)
    with pytest.raises(ValueError) as want:
        J.corrupt(img, name, severity)
    with pytest.raises(ValueError) as got:
        P.corrupt(img, name, severity)
    assert str(got.value) == str(want.value)
    assert P.corrupt(img, name, 0) is img


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_raise(name):
    with pytest.raises(NotImplementedError, match=name):
        P.corrupt(pattern(0, 8, 8), name, 1)


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


@pytest.mark.parametrize("name", ["gaussian_noise", "fog"])
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
    """The HSV round trip (OpenCV's vector loop and scalar tail per row) and
    both resizes (the 2x2 and other whole-factor fast paths and the general
    area path, picked by the sizes) against cv2 itself."""
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
