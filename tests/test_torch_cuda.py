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
    assert launch_counts == {"pyramid_pack": 1, "roi_align": 3, "deform_conv": 0}


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


def _dcn_inputs(dev, dtype, stride, groups, scale=2.5, n=2, h=23, w=37, seed=0):
    """x (N, H, W, Cin), anisotropic offsets (some samples outside the
    image), grouped HWIO weight. 1 group: 128 -> 96 channels (a ragged
    output tile); 64 groups: 512 -> 512, 8 channels a group (X-101-DCN's
    layer 2)."""
    cin, cout = (128, 96) if groups == 1 else (512, 512)
    rng = np.random.RandomState(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    off = rng.normal(0, 1, (n, ho, wo, 9, 2)) * [scale, scale / 2] + [0.0, 0.4]
    arrs = (rng.normal(0, 1, (n, h, w, cin)), off.reshape(n, ho, wo, 18),
            rng.normal(0, (9 * cin / groups) ** -0.5, (3, 3, cin // groups, cout)))
    x, off, w = [torch.from_numpy(a.astype(np.float32)).to(dev, dtype) for a in arrs]
    # K3 reads the weight in (Cout, 3, 3, Cin/groups) memory order
    return x, off, w.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 64])
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_matches_plain(cuda, stride, groups, dtype):
    """K3 against its plain version: within 1e-4 (float32) / 1e-2
    (bfloat16) of the plain version's largest magnitude. Both sum in
    float32, in different orders; in bfloat16 the outputs differ by one
    final rounding."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_plain
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    x, off, wgt = _dcn_inputs(cuda, dtype, stride, groups)
    reset_launch_counts()
    k = deform_conv2d(x, off, wgt, stride=stride, groups=groups)
    torch.cuda.synchronize()
    assert launch_counts["deform_conv"] == 1
    p = deform_conv2d_plain(x, off, wgt, stride=stride, groups=groups)
    assert k.shape == p.shape and k.dtype == dtype
    assert _rel_err(k, p) <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 64])
def test_deform_conv_zero_offsets_is_conv2d(cuda, groups):
    """With zero offsets K3 computes the regular conv (float32, TF32 off)."""
    import torch.nn.functional as F

    from htd_tpu_torch.ops.dcn import deform_conv2d

    x, off, wgt = _dcn_inputs(cuda, torch.float32, 2, groups)
    k = deform_conv2d(x, torch.zeros_like(off), wgt, stride=2, groups=groups)
    ref = F.conv2d(x.permute(0, 3, 1, 2), wgt.permute(3, 2, 0, 1), stride=2, padding=1,
                   groups=groups).permute(0, 2, 3, 1)
    assert _rel_err(k, ref) <= 1e-4


@pytest.mark.cuda
def test_deform_conv_rejects_what_it_does_not_take(cuda):
    """A non-contiguous input raises rather than falling back or copying;
    so do an HWIO-contiguous weight, two deform groups and a dtype
    mismatch."""
    from htd_tpu_torch.ops.dcn import deform_conv2d

    x, off, wgt = _dcn_inputs(cuda, torch.float32, 1, 1)
    nchw = x.permute(0, 3, 1, 2).contiguous()    # not channels_last
    with pytest.raises(ValueError, match="contiguous"):
        deform_conv2d(nchw.permute(0, 2, 3, 1), off, wgt)
    with pytest.raises(ValueError, match="memory order"):
        deform_conv2d(x, off, wgt.contiguous())
    with pytest.raises(ValueError):
        deform_conv2d(x, off.repeat(1, 1, 1, 2), wgt, deform_groups=2)
    with pytest.raises(ValueError):
        deform_conv2d(x, off.bfloat16(), wgt)
