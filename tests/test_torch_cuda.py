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
from tests.roi_cases import crowded_rois, special_rois

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


def _roi_case(dev, dtype, case):
    """K2 / K4 inputs: "small" (`_inputs`, 64 channels), "special"
    (`special_rois`: sub-pixel bins, samples in [-1, 0) and (size - 1,
    size], a roi wider than every level, zero width and height; 256
    channels) and "crowded" (a training step's 512 rois per image, batch 2,
    on the pyramid of the 800x1344 bucket, 256 channels)."""
    if case == "small":
        return _inputs(dev, dtype)
    h, w, r = (64, 96, 24) if case == "special" else (200, 336, 512)
    feats, _ = _inputs(dev, dtype, h=h, w=w, c=256, seed=1)
    rng = np.random.RandomState(2)
    make = special_rois if case == "special" else crowded_rois
    return feats, torch.from_numpy(make(rng, 2, r, 4.0 * h, 4.0 * w)).to(dev)


def _rel_err(k, p):
    return (k.float() - p.float()).abs().max().item() / max(1.0, p.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "special", "crowded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, dtype, case):
    """K1 bit-equal to its plain version; K2 per-roi levels (S=4, 2, 1) and
    the all-level pass (S=1) within 1e-5 (float32) / 1e-2 (bfloat16) of the
    plain version, relative to its largest magnitude, on each of
    `_roi_case`'s roi sets, and on the special rois inverted (x2 < x1, y2 <
    y1) under a fixed grid of 2. Both accumulate in float32; they differ in
    summation order and, in bfloat16, in one final rounding."""
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    feats, rois = _roi_case(cuda, dtype, case)
    reset_launch_counts()
    pyr = pack_pyramid(feats)
    assert torch.equal(pyr.buf, pack_pyramid_plain(feats, pyr.geom))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    lv = map_roi_levels(rois, 4)
    for s in (4, 2, 1):
        k = roi_align_pyramid(pyr, rois, lv, STRIDES, 7, 0, s)
        assert _rel_err(k, roi_align_plain(pyr, rois, lv, STRIDES, 7, 0, s)) <= tol
    k = roi_align_levels(pyr, rois, STRIDES, 7, 0, 1)
    for lvl in range(4):
        p = roi_align_plain(pyr, rois, torch.full_like(lv, lvl), STRIDES, 7, 0, 1)
        assert _rel_err(k[lvl], p) <= tol
    if case == "special":
        assert k[:, :, 6:8].abs().max().item() == 0.0    # zero width and height
        # corners swapped under a fixed grid: sample coordinates decrease
        inv = rois[..., [2, 3, 0, 1]].contiguous()
        k = roi_align_pyramid(pyr, inv, lv, STRIDES, 7, 2, 4)
        assert _rel_err(k, roi_align_plain(pyr, inv, lv, STRIDES, 7, 2, 4)) <= tol
    torch.cuda.synchronize()
    assert launch_counts == {"pyramid_pack": 1, "roi_align": 4 + (case == "special"),
                             "deform_conv": 0,
                             "roi_align_bwd": 0, "deform_conv_bwd_input": 0,
                             "deform_conv_bwd_offset_weight": 0, "upsample_add": 0,
                             "layout_fence": 0}


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
    # K2 and K4 keep each roi's sample tables in shared memory: out_size <= 8
    # and out_size * samples <= 64
    with pytest.raises(ValueError, match="out_size"):
        roi_align_pyramid(pyr, rois, map_roi_levels(rois, 4), STRIDES, 9)
    with pytest.raises(ValueError, match="out_size"):
        roi_align_levels(pyr, rois, STRIDES, 7, 0, 10)


def _dcn_inputs(dev, dtype, stride, groups, scale=2.5, n=2, h=23, w=37, seed=0,
                deform_groups=1, channels=None):
    """x (N, H, W, Cin), anisotropic offsets (some samples outside the
    image) for each deform group, grouped HWIO weight. 1 group: 128 -> 96
    channels (a ragged output tile); 64 groups: 512 -> 512, 8 channels a
    group (X-101-DCN's layer 2); `channels` (Cin, Cout) overrides both."""
    cin, cout = channels or ((128, 96) if groups == 1 else (512, 512))
    rng = np.random.RandomState(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    off = rng.normal(0, 1, (n, ho, wo, deform_groups * 9, 2)) * [scale, scale / 2] + [0.0, 0.4]
    arrs = (rng.normal(0, 1, (n, h, w, cin)), off.reshape(n, ho, wo, deform_groups * 18),
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
    final rounding. bfloat16 with one weight group takes the tensor
    cores, everything else the CUDA cores."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_plain
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, path_counts, reset_launch_counts

    x, off, wgt = _dcn_inputs(cuda, dtype, stride, groups)
    reset_launch_counts()
    k = deform_conv2d(x, off, wgt, stride=stride, groups=groups)
    torch.cuda.synchronize()
    assert launch_counts["deform_conv"] == 1
    tc = dtype == torch.bfloat16 and groups == 1
    assert (path_counts["deform_conv_tc"], path_counts["deform_conv_cc"]) == (tc, not tc)
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
    so do an HWIO-contiguous weight, deform groups of fewer than 64
    channels (128 channels in 4 groups: a kernel block's channels would
    span more than two) and a dtype mismatch."""
    from htd_tpu_torch.ops.dcn import deform_conv2d

    x, off, wgt = _dcn_inputs(cuda, torch.float32, 1, 1)
    nchw = x.permute(0, 3, 1, 2).contiguous()    # not channels_last
    with pytest.raises(ValueError, match="contiguous"):
        deform_conv2d(nchw.permute(0, 2, 3, 1), off, wgt)
    with pytest.raises(ValueError, match="memory order"):
        deform_conv2d(x, off, wgt.contiguous())
    with pytest.raises(ValueError, match="multiple of 64"):
        deform_conv2d(x, off.repeat(1, 1, 1, 4), wgt, deform_groups=4)
    with pytest.raises(ValueError):
        deform_conv2d(x, off.bfloat16(), wgt)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "special", "crowded"])
@pytest.mark.parametrize("s", [4, 2, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("all_levels", [False, True])
def test_roi_align_bwd_matches_plain(cuda, all_levels, dtype, s, case):
    """K4 against its plain version: the float32 pyramid gradient within
    1e-5 of the plain version's largest magnitude (both add the same
    float32 products, K4 with atomics in another order); through autograd
    the levels get it in the features' dtype, one launch per backward. On
    each of `_roi_case`'s roi sets, with a cotangent that has all-zero
    bins (one roi's, two bin rows of another, one bin of every roi)."""
    from htd_tpu_torch.ops.roi_align import roi_align_backward_plain
    from htd_tpu_torch.ops.roi_align_cuda import (launch_counts, launch_roi_align_bwd,
                                                  reset_launch_counts)

    feats, rois = _roi_case(cuda, dtype, case)
    if case == "small":
        rois[:, 5:9] = rois[:, 4:5]              # crowded: several copies of one roi
    geom = pack_pyramid(feats).geom
    lv = None if all_levels else map_roi_levels(rois, 4)
    lead = (4,) if all_levels else ()
    g = torch.randn(lead + tuple(rois.shape[:2]) + (7, 7, geom.channels), device=cuda)
    g[..., 8, :, :, :] = 0.0
    g[..., 9, 2:4, :, :] = 0.0
    g[..., 5, 1, :] = 0.0
    g = g.to(dtype)
    reset_launch_counts()
    k = launch_roi_align_bwd(geom, rois, lv, g, STRIDES, 7, 0, s)
    k2 = launch_roi_align_bwd(geom, rois, lv, g, STRIDES, 7, 0, s)
    p = roi_align_backward_plain(geom, rois, lv, g, STRIDES, 7, 0, s)
    assert k.dtype == torch.float32 and k.shape == p.shape
    assert _rel_err(k, p) <= 1e-5 and _rel_err(k2, p) <= 1e-5
    levels = [f.clone().requires_grad_(True) for f in feats]
    pyr = pack_pyramid(levels)
    out = (roi_align_levels(pyr, rois, STRIDES, 7, 0, s) if all_levels
           else roi_align_pyramid(pyr, rois, lv, STRIDES, 7, 0, s))
    out.backward(g)
    torch.cuda.synchronize()
    assert launch_counts["roi_align_bwd"] == 3
    from htd_tpu_torch.ops.pyramid import pyramid_level_grads
    for f, ref in zip(levels, pyramid_level_grads(p, geom)):
        assert f.grad.dtype == dtype
        assert _rel_err(f.grad, ref) <= (1e-5 if dtype == torch.float32 else 1e-2)


def _bwd_err(k, p, dtype):
    """Largest |k - p| relative to max |p|, and its limit: 1e-5 where both
    are float32 sums of the same products in another order; in bfloat16
    one more bfloat16 ulp of the largest value, for the final rounding."""
    scale = p.float().abs().max().item()
    err = (k.float() - p.float()).abs().max().item() / scale
    ulp = 0.0 if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7) / scale
    return err, 1e-5 + ulp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 64])
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_bwd_matches_plain(cuda, stride, groups, dtype):
    """K5 (d_x, and the d_col it hands K6) and K6 (d_offsets, d_weight)
    against `deform_conv2d_backward_plain` on the same inputs, twice (the
    atomics sum in a run-dependent order): within `_bwd_err`'s limit."""
    from htd_tpu_torch.ops.dcn import deform_conv2d_backward_plain
    from htd_tpu_torch.ops.dcn_cuda import (launch_deform_conv_bwd_input,
                                            launch_deform_conv_bwd_offset_weight)

    x, off, wgt = _dcn_inputs(cuda, dtype, stride, groups)
    g = torch.randn(off.shape[:3] + (wgt.shape[-1],), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(1)).to(dtype)
    ref = deform_conv2d_backward_plain(x, off, wgt, g, stride=stride, groups=groups)
    for _ in range(2):
        d_x, d_col = launch_deform_conv_bwd_input(x.shape, off, wgt, g, stride, 1, 1, groups)
        d_off, d_w = launch_deform_conv_bwd_offset_weight(x, off, g, d_col, wgt.shape, stride,
                                                          1, 1, groups)
        got = (d_x, d_off, d_w.to(dtype))
        for name, k, p in zip(("d_x", "d_off", "d_w"), got, ref):
            assert k.shape == p.shape and k.dtype == p.dtype, name
            err, lim = _bwd_err(k, p, dtype)
            assert err <= lim, f"{name}: {err:.3g} (limit {lim:.3g})"


def _ulp_limit(k, p, rel):
    """Largest |k - p| relative to max |p|, and its limit: `rel` for float32
    sums in another order, plus one bfloat16 ulp of max |p| where the
    outputs are rounded to bfloat16."""
    err, lim = _bwd_err(k, p, p.dtype)
    return err, lim - 1e-5 + rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_groups_match_plain(cuda, stride, dtype):
    """Two deform groups (each sampling its 64 channels at its own offsets,
    the offsets of the second group drawn apart from the first): K3, K5
    and K6 against their plain versions, within `_bwd_err`'s limit (1e-4
    for K3's forward: its tensor cores sum over 9 x 128 products in float32
    in their own order). K3 and K5 take the tensor cores in bfloat16 and
    the CUDA cores in float32."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_backward_plain, \
        deform_conv2d_plain
    from htd_tpu_torch.ops.dcn_cuda import (launch_deform_conv_bwd_input,
                                            launch_deform_conv_bwd_offset_weight)
    from htd_tpu_torch.ops.roi_align_cuda import path_counts, reset_launch_counts

    x, off, wgt = _dcn_inputs(cuda, dtype, stride, 1, deform_groups=2, seed=3)
    reset_launch_counts()
    k = deform_conv2d(x, off, wgt, stride=stride, deform_groups=2)
    p = deform_conv2d_plain(x, off, wgt, stride=stride, deform_groups=2)
    err, lim = _ulp_limit(k, p, 1e-4)
    assert err <= lim, f"K3: {err:.3g} (limit {lim:.3g})"
    # the groups differ: the same conv with the first group's offsets for both is another function
    same = deform_conv2d_plain(x, off[..., :18].repeat(1, 1, 1, 2).contiguous(), wgt,
                               stride=stride, deform_groups=2)
    assert (same.float() - p.float()).abs().max() > 0.1 * p.float().abs().max()
    g = torch.randn(off.shape[:3] + (wgt.shape[-1],), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(4)).to(dtype)
    ref = deform_conv2d_backward_plain(x, off, wgt, g, stride=stride, deform_groups=2)
    d_x, d_col = launch_deform_conv_bwd_input(x.shape, off, wgt, g, stride, 1, 2, 1)
    d_off, d_w = launch_deform_conv_bwd_offset_weight(x, off, g, d_col, wgt.shape, stride, 1, 2,
                                                      1)
    torch.cuda.synchronize()
    for name, k, p in zip(("d_x", "d_off", "d_w"), (d_x, d_off, d_w.to(dtype)), ref):
        assert k.shape == p.shape and k.dtype == p.dtype, name
        err, lim = _bwd_err(k, p, dtype)
        assert err <= lim, f"{name}: {err:.3g} (limit {lim:.3g})"
    tc = int(dtype == torch.bfloat16)
    assert path_counts == {"deform_conv_tc": tc, "deform_conv_cc": 1 - tc,
                           "deform_conv_bwd_input_tc": tc, "deform_conv_bwd_input_cc": 1 - tc,
                           "deform_conv_bwd_offset_weight_tc": tc,
                           "deform_conv_bwd_offset_weight_cc": 1 - tc}


# R-101-DCN's deformable convs at 800x1344: (channels, input size, stride)
R101_DCN_SHAPES = {"layer2": (128, (100, 168), 1), "layer2.0": (128, (200, 336), 2),
                   "layer3.0": (256, (100, 168), 2), "layer3": (256, (50, 84), 1),
                   "layer4.0": (512, (50, 84), 2), "layer4": (512, (25, 42), 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("conv", list(R101_DCN_SHAPES))
def test_tensor_core_paths_at_r101_shapes(cuda, conv, n):
    """bfloat16 K3, K5 and K6 on the tensor cores at R-101-DCN's stage
    shapes (layer 4's 25x42 map a ragged pixel count, strides 1 and 2,
    batch 1 as in inference and 2 as in training) against their plain
    versions: K3's output, K5's d_x and K6's d_off within 1e-4 of max
    |plain| plus one bfloat16 ulp (the same bfloat16 samples and operands,
    float32 sums in another order, then one rounding); K5's d_col and K6's
    d_w (float32, from the bfloat16-rounded samples, split over pixel
    ranges) within 1e-4. K6 reads K5's d_col, as in the backward. One
    launch each, all counted on the tensor-core path."""
    from htd_tpu_torch.ops.dcn import (deform_conv2d, deform_conv2d_backward_input_plain,
                                       deform_conv2d_backward_offset_weight_plain,
                                       deform_conv2d_plain)
    from htd_tpu_torch.ops.dcn_cuda import (launch_deform_conv_bwd_input,
                                            launch_deform_conv_bwd_offset_weight)
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, path_counts, reset_launch_counts

    c, (h, w), stride = R101_DCN_SHAPES[conv]
    x, off, wgt = _dcn_inputs(cuda, torch.bfloat16, stride, 1, n=n, h=h, w=w, channels=(c, c),
                              seed=5)
    g = torch.randn(off.shape[:3] + (c,), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(6)).bfloat16()
    reset_launch_counts()
    k = deform_conv2d(x, off, wgt, stride=stride)
    d_x, d_col = launch_deform_conv_bwd_input(x.shape, off, wgt, g, stride, 1, 1, 1)
    d_off, d_w = launch_deform_conv_bwd_offset_weight(x, off, g, d_col, wgt.shape, stride, 1, 1,
                                                      1)
    torch.cuda.synchronize()
    assert launch_counts["deform_conv"] == launch_counts["deform_conv_bwd_input"] == \
        launch_counts["deform_conv_bwd_offset_weight"] == 1
    assert path_counts["deform_conv_tc"] == path_counts["deform_conv_bwd_input_tc"] == \
        path_counts["deform_conv_bwd_offset_weight_tc"] == 1
    p_off, p_w = deform_conv2d_backward_offset_weight_plain(x, off, g, d_col, wgt.shape, stride)
    err, lim = _ulp_limit(d_off, p_off, 1e-4)
    assert err <= lim, f"K6 d_off: {err:.3g} (limit {lim:.3g})"
    err, lim = _ulp_limit(d_w, p_w, 1e-4)
    assert err <= lim, f"K6 d_w: {err:.3g} (limit {lim:.3g})"
    err, lim = _ulp_limit(k, deform_conv2d_plain(x, off, wgt, stride=stride), 1e-4)
    assert err <= lim, f"K3: {err:.3g} (limit {lim:.3g})"
    p_x, p_col = deform_conv2d_backward_input_plain(x.shape, off, wgt, g, stride)
    err, lim = _ulp_limit(d_x, p_x, 1e-4)
    assert err <= lim, f"K5 d_x: {err:.3g} (limit {lim:.3g})"
    err, lim = _ulp_limit(d_col, p_col, 1e-4)
    assert err <= lim, f"K5 d_col: {err:.3g} (limit {lim:.3g})"


@pytest.mark.cuda
def test_deform_conv_bwd_rejects_what_it_does_not_take(cuda):
    """K5 and K6 raise, rather than fall back or copy, on a cotangent that
    is not contiguous, inputs of two dtypes, offsets that do not fit the
    deform groups, and a d_col that is not K5's float32 one."""
    from htd_tpu_torch.ops.dcn_cuda import (launch_deform_conv_bwd_input,
                                            launch_deform_conv_bwd_offset_weight)

    x, off, wgt = _dcn_inputs(cuda, torch.float32, 1, 1)
    g = torch.randn(off.shape[:3] + (wgt.shape[-1],), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        launch_deform_conv_bwd_input(x.shape, off, wgt, g.transpose(1, 2).contiguous()
                                     .transpose(1, 2), 1, 1, 1, 1)
    with pytest.raises(ValueError, match="one dtype"):
        launch_deform_conv_bwd_input(x.shape, off, wgt, g.bfloat16(), 1, 1, 1, 1)
    with pytest.raises(ValueError, match="deform group"):
        launch_deform_conv_bwd_input(x.shape, off, wgt, g, 1, 1, 2, 1)
    _, d_col = launch_deform_conv_bwd_input(x.shape, off, wgt, g, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="d_col"):
        launch_deform_conv_bwd_offset_weight(x, off, g, d_col.bfloat16(), wgt.shape, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="one dtype"):
        launch_deform_conv_bwd_offset_weight(x.bfloat16(), off, g, d_col, wgt.shape, 1, 1, 1, 1)


@pytest.mark.cuda
def test_deform_conv_module_trains_on_cuda(cuda):
    """`DeformConv2d` on the card with float32 parameters under bfloat16
    autocast, fed bfloat16 activations as the network feeds it: the
    weight and offsets are cast to the input's dtype, the
    output comes from `_DeformConv2d`, one backward launches K5 and K6 once
    each, and the input and every parameter get a finite float32 gradient
    within 3e-2 of the float32 CPU module's largest value (bfloat16
    activations and cotangents). The offset conv has zero weights and a
    bias of eighths off the integers, so the offsets are the same in both
    dtypes: d_offsets jumps where a sample crosses an integer, and
    bfloat16 offsets from a random offset conv would move many samples
    into another cell."""
    from htd_tpu_torch.ops.dcn import DeformConv2d
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    rng = np.random.RandomState(2)
    w_np = rng.normal(0, 0.05, (128, 128, 3, 3)).astype(np.float32)
    bias = (rng.randint(-2, 2, 18) + rng.randint(1, 8, 18) / 8).astype(np.float32)
    x_np = rng.normal(0, 1, (2, 128, 20, 30)).astype(np.float32)
    grads = []
    for dev in ("cpu", "cuda"):
        m = DeformConv2d(128, 128, stride=2)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w_np))
            m.conv_offset.weight.zero_()
            m.conv_offset.bias.copy_(torch.from_numpy(bias))
        m = m.to(dev).to(memory_format=torch.channels_last)
        x = torch.from_numpy(x_np).to(dev).to(memory_format=torch.channels_last)
        x.requires_grad_(True)
        reset_launch_counts()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dev == "cuda"):
            out = m(x.to(torch.bfloat16) if dev == "cuda" else x)
        out.float().square().sum().backward()
        grads.append([x.grad] + [p.grad for p in m.parameters()])
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "_DeformConv2dBackward"
    assert (launch_counts["deform_conv"], launch_counts["deform_conv_bwd_input"],
            launch_counts["deform_conv_bwd_offset_weight"]) == (1, 1, 1)
    for c, k in zip(*grads):
        assert k.dtype == torch.float32 and torch.isfinite(k).all()
        assert (k.cpu() - c).abs().max().item() <= 3e-2 * c.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["htd_r50_1x", "htd_r101_dcn_2x", "htd_x101_dcn_2x"])
def test_train_step_launches(cuda, preset):
    """One bfloat16 train step of HTD R-50 / R-101-DCN / X-101-64x4d-DCN at
    full depth and width (a small 256x384 batch of 2): K1 once, K2 and K4
    three times each, K7 three times (the FPN's top-down adds), and with
    the 30 deformable convs K3, K5 and K6 30 times each; finite float32
    losses; P5's lateral conv gets a finite non-zero gradient."""
    from htd_tpu_torch import config as PC
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts
    from htd_tpu_torch.train.train_step import TrainBatch, create_train_state, train_step

    state = create_train_state(getattr(PC, preset)(compute_dtype="bfloat16"), seed=0)
    rng = np.random.RandomState(0)
    boxes = np.zeros((2, 100, 4), np.float32)
    boxes[:, :3] = [[20, 30, 90, 120], [100, 40, 300, 230], [10, 150, 60, 200]]
    valid = np.zeros((2, 100), bool)
    valid[:, :3] = True
    batch = TrainBatch(torch.from_numpy(rng.normal(0, 1, (2, 256, 384, 3)).astype(np.float32)),
                       torch.tensor([[256.0, 384.0], [240.0, 360.0]]), torch.from_numpy(boxes),
                       torch.from_numpy(rng.randint(0, 80, (2, 100)).astype(np.int32)),
                       torch.from_numpy(valid))
    reset_launch_counts()
    metrics = train_step(state, batch, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    dcn = 0 if preset == "htd_r50_1x" else 30
    assert launch_counts == {"pyramid_pack": 1, "roi_align": 3, "deform_conv": dcn,
                             "roi_align_bwd": 3, "deform_conv_bwd_input": dcn,
                             "deform_conv_bwd_offset_weight": dcn, "upsample_add": 3,
                             "layout_fence": 0}
    assert all(v.dtype == torch.float32 and torch.isfinite(v).item() for v in metrics.values())
    g = state.model.neck.lateral_convs[3].conv.weight.grad
    assert torch.isfinite(g).all() and g.abs().max() > 0


def _up_pair(dev, dtype, b, h, w, c, channels_last=True, seed=0):
    """NHWC views of NCHW low (B, C, h, w) and lat (B, C, 2h, 2w) in
    channels_last (or contiguous) memory, as the FPN hands them over."""
    rng = np.random.RandomState(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return [torch.from_numpy(rng.normal(0, 1, (b, c, hh, ww)).astype(np.float32)).to(dev, dtype)
            .contiguous(memory_format=fmt).permute(0, 2, 3, 1)
            for hh, ww in ((h, w), (2 * h, 2 * w))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 13, 256), (1, 25, 21, 256), (3, 5, 9, 24)],
                         ids=["odd", "p5_like", "narrow"])
def test_upsample_add_matches_plain(cuda, dtype, shape):
    """K7 is bit-equal to its plain version (one add in the inputs' dtype)
    at odd widths, one launch; its output is contiguous NHWC, i.e.
    channels_last as NCHW; the launcher's output is the autograd
    function's."""
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts
    from htd_tpu_torch.ops.upsample import upsample2x_add, upsample2x_add_plain

    low, lat = _up_pair(cuda, dtype, *shape)
    reset_launch_counts()
    k = upsample2x_add(low, lat)
    torch.cuda.synchronize()
    assert launch_counts["upsample_add"] == 1
    assert k.dtype == dtype and k.is_contiguous()
    assert k.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(k, upsample2x_add_plain(low, lat))


@pytest.mark.cuda
def test_upsample_add_rejects_what_it_does_not_take(cuda):
    """An NCHW-contiguous lateral (not channels_last) raises rather than
    being copied; so do two dtypes at the launcher, channels that are not a
    16-byte multiple, and a CPU tensor beside a CUDA one. A pair that is
    not exactly 2x takes the resize branch and launches nothing."""
    from htd_tpu_torch.ops.elementwise_cuda import launch_upsample_add
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts
    from htd_tpu_torch.ops.upsample import upsample2x_add

    low, lat = _up_pair(cuda, torch.float32, 1, 6, 10, 32)
    nlow, nlat = _up_pair(cuda, torch.float32, 1, 6, 10, 32, channels_last=False)
    with pytest.raises(ValueError, match="contiguous"):
        upsample2x_add(nlow, nlat)
    with pytest.raises(ValueError, match="contiguous"):
        upsample2x_add(low, nlat)
    with pytest.raises(ValueError, match="one dtype"):
        launch_upsample_add(low.bfloat16(), lat)
    with pytest.raises(ValueError, match="16 bytes"):
        upsample2x_add(*_up_pair(cuda, torch.float32, 1, 6, 10, 6))
    with pytest.raises(ValueError):
        upsample2x_add(low.cpu(), lat)
    reset_launch_counts()
    out = upsample2x_add(low, lat[:, :11])
    assert out.shape == (1, 11, 20, 32) and launch_counts["upsample_add"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_add_autograd(cuda, dtype):
    """The output carries `_Upsample2xAdd`'s grad_fn; d_lat = g and d_low =
    the 2x2 sum-pool of g, equal to the plain autograd's on the CPU (the
    pool sums four values, in float32 within 1e-6 of max |g|, in bfloat16
    within one rounding)."""
    from htd_tpu_torch.ops.upsample import upsample2x_add

    low, lat = _up_pair(cuda, dtype, 2, 7, 13, 64)
    g = torch.randn(lat.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    g = g.to(dtype)
    grads = []
    for dev in (cuda, "cpu"):
        a, b = (x.to(dev).detach().requires_grad_(True) for x in (low, lat))
        out = upsample2x_add(a, b)
        assert type(out.grad_fn).__name__ == "_Upsample2xAddBackward"
        out.backward(g.to(dev))
        grads.append((a.grad.cpu().float(), b.grad.cpu().float()))
    (kl, kt), (pl, pt) = grads
    assert torch.equal(kt, pt)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    assert (kl - pl).abs().max().item() <= tol * pl.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_fence_matches_plain(cuda, dtype):
    """K8 copies ranks 2-5, odd sizes (a tail of bytes beyond the last
    16-byte vector), channels_last tensors (one spanning many blocks) and
    byte spans of 1, 15 and 16 k + 3 (a vector count that is not a multiple
    of a thread's or a block's share) bit for bit, into a fresh tensor with
    the input's strides, one launch each; the gradient passes through
    `_LayoutFence`; a tensor with gaps raises."""
    from htd_tpu_torch.ops.fence import layout_fence, layout_fence_plain
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    shapes = [(33, 7), (5, 11, 13), (2, 256, 25, 21), (2, 3, 7, 9, 5), (3, 64, 37, 41)]
    xs = [torch.randn(s, device=cuda).to(dtype) for s in shapes]
    xs[2] = xs[2].contiguous(memory_format=torch.channels_last)
    xs[4] = xs[4].contiguous(memory_format=torch.channels_last)
    gen = torch.Generator(device=cuda).manual_seed(7)
    xs += [torch.randint(0, 256, (span,), device=cuda, dtype=torch.uint8, generator=gen)
           for span in (1, 15, 16 * 12345 + 3)]
    reset_launch_counts()
    for x in xs:
        k = layout_fence(x)
        assert k.stride() == x.stride() and k.data_ptr() != x.data_ptr()
        assert torch.equal(k, layout_fence_plain(x))
    torch.cuda.synchronize()
    assert launch_counts["layout_fence"] == len(xs)
    x = xs[2].detach().requires_grad_(True)
    out = layout_fence(x)
    assert type(out.grad_fn).__name__ == "_LayoutFenceBackward"
    out.float().square().sum().backward()
    assert torch.equal(x.grad, (2 * x.detach().float()).to(dtype))
    with pytest.raises(ValueError, match="dense"):
        layout_fence(xs[0][:, :5])


@pytest.mark.cuda
def test_fpn_gradients_through_k7(cuda):
    """The port's FPN on the card (float32, TF32 off) with K7 in its
    top-down adds gives the same outputs and the same gradients for C2-C5
    and every FPN parameter as the two-op form `lat + resize_nearest(low)`,
    within 1e-5 of each tensor's largest value (cuDNN's backward sums in
    its own order); P5's lateral among them."""
    from htd_tpu_torch.models.fpn import FPN
    from htd_tpu_torch.models.layers import resize_nearest
    from htd_tpu_torch.ops.roi_align_cuda import launch_counts, reset_launch_counts

    torch.manual_seed(0)
    neck = FPN().to(cuda).to(memory_format=torch.channels_last)
    rng = np.random.RandomState(4)
    cs = [rng.normal(0, 1, (2, c, 64 >> i, 96 >> i)).astype(np.float32)
          for i, c in enumerate((256, 512, 1024, 2048))]

    def run(use_op):
        neck.zero_grad()
        xs = [torch.from_numpy(c).to(cuda).contiguous(memory_format=torch.channels_last)
              .requires_grad_(True) for c in cs]
        if use_op:
            outs = neck(xs)
        else:
            lats = [m(x) for m, x in zip(neck.lateral_convs, xs)]
            for i in range(3, 0, -1):
                lats[i - 1] = lats[i - 1] + resize_nearest(lats[i], lats[i - 1].shape[-2:])
            outs = [f(x) for f, x in zip(neck.fpn_convs, lats)]
        sum(torch.sin(o).sum() for o in outs[:4]).backward()
        return [o.detach() for o in outs[:4]] + [x.grad for x in xs] + \
            [p.grad.clone() for p in neck.parameters()]

    reset_launch_counts()
    got = run(True)
    torch.cuda.synchronize()
    assert launch_counts["upsample_add"] == 3
    assert neck.lateral_convs[3].conv.weight.grad.abs().max() > 0
    for a, b in zip(got, run(False)):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.cuda
def test_coco_matcher_on_the_drill_dump(cuda, tmp_path):
    """The native COCO matcher equals its numpy twin on the production
    drill's own detections (tools_torch/drill_production.py on the card, 12
    images at 1333x800): every (image, category, area range) at the 10 IoU
    thresholds."""
    from htd_tpu_torch.data import coco_eval as E
    from htd_tpu_torch.data.coco import CocoDataset
    from tools_torch import drill_production as drill

    drill.main(["--images", "12", "--mirror-images", "1", "--out", str(tmp_path)])
    dets = drill.load_dump(str(tmp_path / "raw_dump.json"))
    gts = CocoDataset(str(tmp_path / "ann.json"), str(tmp_path / "images"),
                      test_mode=True).groundtruth()
    compared = 0
    for img, (db, ds, dl) in dets.items():
        gb, gl, gc = gts[img]
        for cat in range(80):
            args = (db[dl == cat], ds[dl == cat], gb[gl == cat], gc[gl == cat].astype(bool))
            for area in E.AREA_RANGES.values():
                got = E._evaluate_img_cat(*args, area, E.IOU_THRS)
                want = E._evaluate_img_cat_plain(*args, area, E.IOU_THRS)
                assert (got is None) == (want is None)
                for g, w in zip(got or [], want or []):
                    compared += 1
                    np.testing.assert_array_equal(g.dt_scores, w.dt_scores)
                    np.testing.assert_array_equal(g.dt_matched, w.dt_matched)
                    np.testing.assert_array_equal(g.dt_ignore, w.dt_ignore)
                    assert g.num_gt == w.num_gt
    assert compared > 0


@pytest.mark.cuda
def test_arithmetic_and_lossless_fixtures_on_the_host(cuda):
    """The arithmetic-coded and lossless fixtures of tests/data/jpeg decode
    on the card's host to cv2.imread's pixels (the manifest's SHA-256)."""
    import hashlib
    import json
    from pathlib import Path

    from htd_tpu_torch.data.jpeg import read_jpeg

    root = Path(__file__).resolve().parent / "data" / "jpeg"
    manifest = json.loads((root / "manifest.json").read_text())
    names = [n for n in manifest if "arith" in n or n.startswith("lossless")]
    assert len(names) >= 10
    for name in names:
        img = read_jpeg(root / name)
        assert [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()] == \
            [manifest[name]["shape"], manifest[name]["sha256"]], name
