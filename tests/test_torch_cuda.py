"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA Hopper GPU and nvcc; without a GPU every test skips. This
file imports neither JAX nor the JAX package, so that it runs on a
machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from htd_tpu_torch.ops.boxes import map_roi_levels
from htd_tpu_torch.ops.pyramid import pack_pyramid, pack_pyramid_plain
from htd_tpu_torch.ops.roi_align import roi_align_levels, roi_align_plain, roi_align_pyramid

STRIDES = (4, 8, 16, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, b=2, h=64, w=96, c=64, r=24, seed=0):
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.normal(0, 1, (b, h >> i, w >> i, c)).astype(np.float32))
             .to(dev, dtype) for i in range(4)]
    xy = rng.uniform(-10, [w, h], (b, r, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 120, (b, r, 2))], -1).astype(np.float32)
    rois[:, 0] = [10, 10, 10, 30]               # zero width
    rois[:, 1] = [-20, -15, w + 25, h + 10]     # crosses every border
    rois[:, 2] = [2, 20, w - 2, 26]             # elongated
    return feats, torch.from_numpy(rois).to(dev)


def _rel_err(k, p):
    return (k.float() - p.float()).abs().max().item() / max(1.0, p.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, dtype):
    """K1 bit-equal to its plain version; K2 per-roi levels (S=4) and the
    all-level pass (S=1) within 1e-5 (float32) / 1e-2 (bfloat16) of the
    plain version, relative to its largest magnitude. Both accumulate in
    float32; they differ in summation order and, in bfloat16, in one final
    rounding."""
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    feats, rois = _inputs(cuda, dtype)
    reset_launch_counts()
    pyr = pack_pyramid(feats)
    assert torch.equal(pyr.buf, pack_pyramid_plain(feats, pyr.geom))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    lv = map_roi_levels(rois, 4)
    for s in (4, 1):
        k = roi_align_pyramid(pyr, rois, lv, STRIDES, 7, 0, s)
        assert _rel_err(k, roi_align_plain(pyr, rois, lv, STRIDES, 7, 0, s)) <= tol
    k = roi_align_levels(pyr, rois, STRIDES, 7, 0, 1)
    for lvl in range(4):
        p = roi_align_plain(pyr, rois, torch.full_like(lv, lvl), STRIDES, 7, 0, 1)
        assert _rel_err(k[lvl], p) <= tol
    torch.cuda.synchronize()
    assert launch_counts == {"pyramid_pack": 1, "roi_align": 3}


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    feats, rois = _inputs(cuda, torch.float32)
    with pytest.raises(ValueError):
        pack_pyramid([f.permute(0, 2, 1, 3) for f in feats])    # not contiguous NHWC
    with pytest.raises(ValueError):
        pack_pyramid([f.double() for f in feats])
    pyr = pack_pyramid(feats)
    with pytest.raises(ValueError):
        roi_align_pyramid(pyr, rois.cpu(), map_roi_levels(rois, 4).cpu(), STRIDES)
