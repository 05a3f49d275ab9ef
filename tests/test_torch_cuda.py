"""The port's CUDA kernels against their plain versions, on the card.
Which kernels a call runs is read from its profiler trace, by name
(`htd_tpu_torch.utils.profiling.kernel_counts`).

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
from htd_tpu_torch.utils.profiling import kernel_counts
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
    summation order and, in bfloat16, in one final rounding. K1 runs once
    and K2 once a call, and no other kernel runs."""
    feats, rois = _roi_case(cuda, dtype, case)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    lv = map_roi_levels(rois, 4)

    def run():
        pyr = pack_pyramid(feats)
        assert torch.equal(pyr.buf, pack_pyramid_plain(feats, pyr.geom))
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

    want = {"pyramid_pack_kernel": 1, "roi_align_fwd_kernel": 4 + (case == "special")}
    assert kernel_counts(run, want)[1] == want


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
    cores, with 64 groups of 8 channels the grouped tensor cores, float32
    the CUDA cores: one kernel of that path runs."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_plain

    x, off, wgt = _dcn_inputs(cuda, dtype, stride, groups)
    want = {"deform_conv_fwd_kernel" if dtype == torch.float32 else
            "deform_conv_fwd_tc_kernel" if groups == 1 else "deform_conv_fwd_grouped_tc_kernel": 1}
    k, got = kernel_counts(lambda: deform_conv2d(x, off, wgt, stride=stride, groups=groups), want)
    assert got == want
    p = deform_conv2d_plain(x, off, wgt, stride=stride, groups=groups)
    assert k.shape == p.shape and k.dtype == dtype
    assert _rel_err(k, p) <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("deform_groups", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cg", [8, 16, 32])
def test_grouped_k3_matches_plain(cuda, cg, stride, deform_groups):
    """bfloat16 K3 with 256 channels in groups of 8, 16 and 32 (X-101's
    layer2-4 group widths) on the grouped tensor-core path, against its
    plain version: a 23x37 map, so that the 4 x 16 pixel tiles are ragged
    in both directions, at strides 1 and 2, offsets of up to ~8 px that
    put some samples outside the image, one deform group or two (each
    128 channels): within 1e-4 of max |plain| plus one bfloat16 ulp (the
    same bfloat16 samples and weights, float32 sums in another order, one
    rounding). One kernel of that path runs."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_plain

    x, off, wgt = _dcn_inputs(cuda, torch.bfloat16, stride, 256 // cg, channels=(256, 256),
                              deform_groups=deform_groups, seed=cg + stride)
    ys = off[..., 0::2].float() + torch.arange(3, device=cuda).repeat(3 * deform_groups) - 1
    assert (ys.amin((0, 2, 3)) < -1).any() and (off.float().abs() > 5).any()   # off the map
    want = {"deform_conv_fwd_grouped_tc_kernel": 1}
    k, got = kernel_counts(lambda: deform_conv2d(x, off, wgt, stride=stride,
                                                 deform_groups=deform_groups,
                                                 groups=256 // cg), want)
    assert got == want
    p = deform_conv2d_plain(x, off, wgt, stride=stride, deform_groups=deform_groups,
                            groups=256 // cg)
    assert k.shape == p.shape and k.dtype == torch.bfloat16
    err, lim = _ulp_limit(k, p, 1e-4)
    assert err <= lim, f"K3 cg {cg}: {err:.3g} (limit {lim:.3g})"


# K3's rule, a row each: (dtype, Cin, Cout, groups) -> the kernel that runs
_CC, _TC, _GT = ("deform_conv_fwd_kernel", "deform_conv_fwd_tc_kernel",
                 "deform_conv_fwd_grouped_tc_kernel")
K3_RULE = {"float32_grouped": (torch.float32, 512, 512, 64, _CC),
           "bf16_dense": (torch.bfloat16, 128, 96, 1, _TC),
           "bf16_x101_layer2": (torch.bfloat16, 512, 512, 64, _GT),
           "bf16_x101_layer3": (torch.bfloat16, 1024, 1024, 64, _GT),
           "bf16_x101_layer4": (torch.bfloat16, 2048, 2048, 64, _GT),
           "bf16_more_inputs_than_outputs": (torch.bfloat16, 512, 256, 64, _CC),
           "bf16_64_a_group": (torch.bfloat16, 256, 256, 4, _CC),
           "bf16_24_a_group": (torch.bfloat16, 192, 192, 8, _CC),
           "bf16_cin_96": (torch.bfloat16, 96, 96, 12, _CC)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K3_RULE))
def test_k3_dispatch_rule(cuda, case):
    """Each row of K3's rule runs its one kernel: float32 grouped weights
    the CUDA cores; bfloat16 with one weight group the tensor cores;
    X-101's bfloat16 shapes (8, 16, 32 channels a group) the grouped
    tensor cores; bfloat16 grouped shapes outside the rule (fewer output
    than input channels a group, 64 or 24 channels a group, Cin not a
    multiple of 64) the CUDA cores. Each output is held to the plain
    version within 1e-4 of its largest magnitude, plus one bfloat16 ulp in
    bfloat16."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_plain

    dtype, cin, cout, groups, kernel = K3_RULE[case]
    x, off, wgt = _dcn_inputs(cuda, dtype, 1, groups, n=1, h=12, w=20, channels=(cin, cout),
                              seed=9)
    k, got = kernel_counts(lambda: deform_conv2d(x, off, wgt, groups=groups), {kernel: 1})
    assert got == {kernel: 1}
    err, lim = _ulp_limit(k, deform_conv2d_plain(x, off, wgt, groups=groups), 1e-4)
    assert err <= lim, f"K3 {case}: {err:.3g} (limit {lim:.3g})"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 64])
def test_deform_conv_zero_offsets_is_conv2d(cuda, groups, dtype):
    """With zero offsets K3 computes the regular conv of the same inputs
    (taken in float32, TF32 off): within 1e-4 of its largest magnitude,
    plus one bfloat16 ulp in bfloat16 (the output's rounding); in bfloat16
    with 64 groups, the grouped tensor-core path against
    `F.conv2d(groups=64)`."""
    import torch.nn.functional as F

    from htd_tpu_torch.ops.dcn import deform_conv2d

    x, off, wgt = _dcn_inputs(cuda, dtype, 2, groups)
    k = deform_conv2d(x, torch.zeros_like(off), wgt, stride=2, groups=groups)
    ref = F.conv2d(x.float().permute(0, 3, 1, 2), wgt.float().permute(3, 2, 0, 1), stride=2,
                   padding=1, groups=groups).permute(0, 2, 3, 1)
    err, lim = _bwd_err(k, ref, dtype)
    assert err <= lim - 1e-5 + 1e-4, f"{err:.3g} (limit {lim - 1e-5 + 1e-4:.3g})"


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
    bins (one roi's, two bin rows of another, one bin of every roi). The
    trace holds the three K4 kernels and the forward's K1 and K2."""
    from htd_tpu_torch.ops.roi_align import roi_align_backward_plain
    from htd_tpu_torch.ops.roi_align_cuda import launch_roi_align_bwd

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

    def run():
        k = launch_roi_align_bwd(geom, rois, lv, g, STRIDES, 7, 0, s)
        k2 = launch_roi_align_bwd(geom, rois, lv, g, STRIDES, 7, 0, s)
        levels = [f.clone().requires_grad_(True) for f in feats]
        pyr = pack_pyramid(levels)
        out = (roi_align_levels(pyr, rois, STRIDES, 7, 0, s) if all_levels
               else roi_align_pyramid(pyr, rois, lv, STRIDES, 7, 0, s))
        out.backward(g)
        return k, k2, levels

    want = {"roi_align_bwd_kernel": 3, "pyramid_pack_kernel": 1, "roi_align_fwd_kernel": 1}
    (k, k2, levels), got = kernel_counts(run, want)
    assert got == want
    p = roi_align_backward_plain(geom, rois, lv, g, STRIDES, 7, 0, s)
    assert k.dtype == torch.float32 and k.shape == p.shape
    assert _rel_err(k, p) <= 1e-5 and _rel_err(k2, p) <= 1e-5
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
    the CUDA cores in float32, and so does K6's d_weight."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_backward_plain, \
        deform_conv2d_plain
    from htd_tpu_torch.ops.dcn_cuda import (launch_deform_conv_bwd_input,
                                            launch_deform_conv_bwd_offset_weight)

    x, off, wgt = _dcn_inputs(cuda, dtype, stride, 1, deform_groups=2, seed=3)
    g = torch.randn(off.shape[:3] + (wgt.shape[-1],), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(4)).to(dtype)

    def run():
        k = deform_conv2d(x, off, wgt, stride=stride, deform_groups=2)
        d_x, d_col = launch_deform_conv_bwd_input(x.shape, off, wgt, g, stride, 1, 2, 1)
        return k, d_x, *launch_deform_conv_bwd_offset_weight(x, off, g, d_col, wgt.shape,
                                                              stride, 1, 2, 1)

    tc = "_tc" if dtype == torch.bfloat16 else ""
    want = {f"deform_conv_fwd{tc}_kernel": 1, f"deform_conv_bwd_input{tc}_kernel": 1,
            "deform_conv_bwd_offset_kernel": 1, f"deform_conv_bwd_weight{tc}_kernel": 1}
    (k, d_x, d_off, d_w), got = kernel_counts(run, want)
    assert got == want
    p = deform_conv2d_plain(x, off, wgt, stride=stride, deform_groups=2)
    err, lim = _ulp_limit(k, p, 1e-4)
    assert err <= lim, f"K3: {err:.3g} (limit {lim:.3g})"
    # the groups differ: the same conv with the first group's offsets for both is another function
    same = deform_conv2d_plain(x, off[..., :18].repeat(1, 1, 1, 2).contiguous(), wgt,
                               stride=stride, deform_groups=2)
    assert (same.float() - p.float()).abs().max() > 0.1 * p.float().abs().max()
    ref = deform_conv2d_backward_plain(x, off, wgt, g, stride=stride, deform_groups=2)
    for name, k, p in zip(("d_x", "d_off", "d_w"), (d_x, d_off, d_w.to(dtype)), ref):
        assert k.shape == p.shape and k.dtype == p.dtype, name
        err, lim = _bwd_err(k, p, dtype)
        assert err <= lim, f"{name}: {err:.3g} (limit {lim:.3g})"


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
    call each, every kernel the tensor-core path's."""
    from htd_tpu_torch.ops.dcn import (deform_conv2d, deform_conv2d_backward_input_plain,
                                       deform_conv2d_backward_offset_weight_plain,
                                       deform_conv2d_plain)
    from htd_tpu_torch.ops.dcn_cuda import (launch_deform_conv_bwd_input,
                                            launch_deform_conv_bwd_offset_weight)

    c, (h, w), stride = R101_DCN_SHAPES[conv]
    x, off, wgt = _dcn_inputs(cuda, torch.bfloat16, stride, 1, n=n, h=h, w=w, channels=(c, c),
                              seed=5)
    g = torch.randn(off.shape[:3] + (c,), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(6)).bfloat16()

    def run():
        k = deform_conv2d(x, off, wgt, stride=stride)
        d_x, d_col = launch_deform_conv_bwd_input(x.shape, off, wgt, g, stride, 1, 1, 1)
        return k, d_x, d_col, *launch_deform_conv_bwd_offset_weight(x, off, g, d_col, wgt.shape,
                                                                    stride, 1, 1, 1)

    want = {"deform_conv_fwd_tc_kernel": 1, "deform_conv_bwd_input_tc_kernel": 1,
            "deform_conv_bwd_offset_kernel": 1, "deform_conv_bwd_weight_tc_kernel": 1}
    (k, d_x, d_col, d_off, d_w), got = kernel_counts(run, want)
    assert got == want
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
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [128, 256, 512])
def test_k3_at_dilation_3_matches_plain(cuda, c, stride):
    """bfloat16 K3 on the tensor cores at dilation 3 and padding 3, as
    DetectoRS's switchable atrous convs run its large branch, at layer2's
    input size (200x336 for stride 2, 100x168 for stride 1), against its
    plain version: within 1e-4 of max |plain| plus one bfloat16 ulp (the same
    bfloat16 samples and operands, float32 sums in another order, then one
    rounding); one launch of the tensor-core kernel; and another function
    than dilation 1 on the same inputs. The channels are those of
    DetectoRS R-50's SAC convs in layer2, layer3 and layer4."""
    from htd_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_plain

    h, w = (200, 336) if stride == 2 else (100, 168)
    x, off, wgt = _dcn_inputs(cuda, torch.bfloat16, stride, 1, n=1, h=h, w=w, channels=(c, c),
                              seed=7)
    want = {"deform_conv_fwd_tc_kernel": 1}
    k, got = kernel_counts(lambda: deform_conv2d(x, off, wgt, stride=stride, dilation=3), want)
    assert got == want
    p = deform_conv2d_plain(x, off, wgt, stride=stride, dilation=3)
    assert k.shape == p.shape == (1, (h - 1) // stride + 1, (w - 1) // stride + 1, c)
    err, lim = _ulp_limit(k, p, 1e-4)
    assert err <= lim, f"K3 at dilation 3: {err:.3g} (limit {lim:.3g})"
    one = deform_conv2d(x, off, wgt, stride=stride, dilation=1)
    assert (one.float() - p.float()).abs().max() > 0.1 * p.float().abs().max()


@pytest.fixture(scope="module")
def x101_request():
    """X-101-64x4d-DCN in bfloat16 as the benchmark's `x101dcn.infer` cell
    builds it (`bench_h100/configs/htd_x101_dcn_2x.json`: seeded weights,
    offset convs seeded for about 2 px of offset), and two 480x640 images
    in both orientations, each warmed up once (the kernels built, the
    anchors cached). Needs the card."""
    import json

    from bench_h100.harness import BENCH, port_config
    from bench_h100.program import build_detector
    from bench_h100.weights import make_state_dict
    from htd_tpu_torch.apis import inference_detector

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    doc = json.loads((BENCH / "configs" / "htd_x101_dcn_2x.json").read_text())
    dev = torch.device("cuda")
    model = build_detector(port_config(doc), make_state_dict(doc["config"], doc["assumed"],
                                                             2**31 + 5, dev), dev)
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((480, 640), (640, 480))]
    for img in imgs:
        inference_detector(model, img)
    torch.cuda.synchronize()
    yield model, imgs
    del model
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_x101_request_runs_k3_on_the_cuda_cores(cuda, x101_request):
    """One X-101 request at its test scale (1600x800: the 800x1600 and
    1600x800 buckets) runs K3 30 times, every kernel on the grouped
    tensor-core path (`deform_conv_fwd_grouped_tc_kernel`; before it, the
    CUDA cores), and soft-NMS once; it returns detections. The first
    request at a bucket captures the backbone's graph: its eager warm-up
    runs the 30 K3 and 3 K7 kernels, the capture none, and the replay that
    follows 30 and 3 more. The next request replays the graph alone. Each
    request runs K1 once and K2 three times, and neither of the other two
    K3 kernels; the RPN's hard NMS (its mask and scan kernels) is in the
    graph, so it runs once a pass."""
    from htd_tpu_torch.apis import inference_detector
    from htd_tpu_torch.models import graphs

    model, imgs = x101_request
    for img in imgs:
        for passes, graph in ((2, {"capture": 1, "replay": 1, "eager": 0}),
                              (1, {"capture": 0, "replay": 1, "eager": 0})):
            def request():
                if graph["capture"]:
                    model._drop_graphs()
                graphs.reset_graph_counts()
                return inference_detector(model, img)

            want = {"pyramid_pack_kernel": 1, "roi_align_fwd_kernel": 3,
                    "upsample_add_kernel": 3 * passes,
                    "deform_conv_fwd_grouped_tc_kernel": 30 * passes, "soft_nms_kernel": 1,
                    "nms_mask_kernel": passes, "nms_scan_kernel": passes}
            (boxes, _, _), got = kernel_counts(request, want)
            assert got == want
            assert graphs.graph_counts == graph
            assert len(boxes) > 0


@pytest.mark.cuda
def test_x101_k3_launches_lie_in_dcn_spans(cuda, x101_request):
    """Under the profiler, on a request that captures the backbone's graph:
    the eager warm-up launches each of its 30 K3 kernels inside an
    `htd.dcn` span, one launch to a span; the capture then opens 30 more
    `htd.dcn` spans, whose K3 calls go into the graph and launch nothing;
    all 60 lie inside the request's one `htd.graph.capture` span inside
    `htd.backbone_fpn`, and the replay that follows runs the graph's 30 K3
    kernels, all of them `deform_conv_fwd_grouped_tc_kernel` and none of
    the other two K3 kernels. A trace that lost a K3 kernel's record is
    taken again (3 traces at most)."""
    from torch.profiler import ProfilerActivity, profile

    from bench_h100.trace import from_profiler
    from htd_tpu_torch.apis import inference_detector

    model, imgs = x101_request
    for _ in range(3):
        model._drop_graphs()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            inference_detector(model, imgs[0])
            torch.cuda.synchronize()
        tr = from_profiler(prof)
        k3 = [launch for name, _, _, launch in tr.device
              if "deform_conv_fwd_grouped_tc_kernel" in name and launch is not None]
        replayed = [name for name, _, _, launch in tr.device
                    if "deform_conv_fwd_grouped_tc_kernel" in name and launch is None]
        if len(k3) == 30 and len(replayed) == 30:
            break
    assert len(k3) == 30, f"{len(k3)} K3 kernels with their launch in 3 traces"
    assert len(replayed) == 30, f"{len(replayed)} K3 kernels of the replay in 3 traces"
    others = [name for name, _, _, _ in tr.device if "deform_conv_fwd" in name
              and "deform_conv_fwd_grouped_tc_kernel" not in name]
    assert not others, f"other K3 kernels ran: {others[:2]}"
    dcn = [(a, b) for n, a, b in tr.spans if n == "htd.dcn"]
    backbone = [(a, b) for n, a, b in tr.spans if n == "htd.backbone_fpn"]
    capture = [(a, b) for n, a, b in tr.spans if n == "htd.graph.capture"]
    assert len(dcn) == 60 and len(backbone) == 1 and len(capture) == 1
    assert backbone[0][0] <= capture[0][0] and capture[0][1] <= backbone[0][1]
    assert all(capture[0][0] <= a and b <= capture[0][1] for a, b in dcn)
    assert all(sum(a <= t < b for a, b in dcn) == 1 for t in k3)
    assert [sum(a <= t < b for t in k3) for a, b in dcn] == [1] * 30 + [0] * 30


@pytest.mark.cuda
@pytest.mark.parametrize("conv", ["layer2.0", "layer3.1", "layer4.1"])
def test_x101_grouped_k3_matches_plain_at_request_inputs(cuda, x101_request, monkeypatch, conv):
    """K3's grouped tensor-core path (8, 16 and 32 channels a group)
    against its plain twin on one conv of each stage, at the input and
    offsets a request at 800x1600 gives it (layer2.0 with stride 2): within
    1e-4 of max |plain| plus one bfloat16 ulp (the same bfloat16 samples
    and weights, float32 sums in another order, one rounding). The eager
    request runs its 30 K3 kernels on that path and none on the other
    two."""
    from htd_tpu_torch.apis import inference_detector
    from htd_tpu_torch.models import graphs
    from htd_tpu_torch.ops import dcn

    model, imgs = x101_request
    m = model.backbone.get_submodule(conv + ".conv2")
    seen = []
    real = dcn.deform_conv2d

    def capture(x, off, w, *args):
        out = real(x, off, w, *args)
        if w.data_ptr() == m.weight.data_ptr():
            seen.append((x, off, w, args, out))
        return out

    monkeypatch.setattr(dcn, "deform_conv2d", capture)

    def request():
        seen.clear()
        graphs.reset_graph_counts()
        inference_detector(model, imgs[0])

    # a hooked module keeps the backbone eager, so that the request calls
    # the wrapper (a graph's replay would call no Python)
    hook = m.register_forward_pre_hook(lambda mod, args: None)
    try:
        _, got = kernel_counts(request, {"deform_conv_fwd_grouped_tc_kernel": 30})
    finally:
        hook.remove()
    assert graphs.graph_counts["eager"] == 1
    assert len(seen) == 1 and got["deform_conv_fwd_grouped_tc_kernel"] == 30
    assert "deform_conv_fwd_tc_kernel" not in got and "deform_conv_fwd_kernel" not in got
    x, off, w, args, k = seen[0]
    assert x.dtype == torch.bfloat16 and args[0] == m.stride and args[3] == 64
    assert float(off.float().abs().mean()) > 0.1           # offsets that move the samples
    p = dcn.deform_conv2d_plain(x, off, w, *args)
    err, lim = _ulp_limit(k, p, 1e-4)
    assert err <= lim, f"K3 {conv}: {err:.3g} (limit {lim:.3g})"


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
    weight and offsets are cast to the input's dtype, the output comes
    from `_DeformConv2d` (one K3 kernel), one backward runs K5 and K6 once
    each, all on the tensor cores (the CPU module runs no kernel), and the
    input and every parameter get a finite float32 gradient within 3e-2 of
    the float32 CPU module's largest value (bfloat16 activations and
    cotangents). The offset conv has zero weights and a
    bias of eighths off the integers, so the offsets are the same in both
    dtypes: d_offsets jumps where a sample crosses an integer, and
    bfloat16 offsets from a random offset conv would move many samples
    into another cell."""
    from htd_tpu_torch.ops.dcn import DeformConv2d

    rng = np.random.RandomState(2)
    w_np = rng.normal(0, 0.05, (128, 128, 3, 3)).astype(np.float32)
    bias = (rng.randint(-2, 2, 18) + rng.randint(1, 8, 18) / 8).astype(np.float32)
    x_np = rng.normal(0, 1, (2, 128, 20, 30)).astype(np.float32)
    want = {"deform_conv_fwd_tc_kernel": 1, "deform_conv_bwd_input_tc_kernel": 1,
            "deform_conv_bwd_offset_kernel": 1, "deform_conv_bwd_weight_tc_kernel": 1}
    grads, ran = [], []
    for dev in ("cpu", "cuda"):
        m = DeformConv2d(128, 128, stride=2)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w_np))
            m.conv_offset.weight.zero_()
            m.conv_offset.bias.copy_(torch.from_numpy(bias))
        m = m.to(dev).to(memory_format=torch.channels_last)
        x = torch.from_numpy(x_np).to(dev).to(memory_format=torch.channels_last)
        x.requires_grad_(True)

        def step():
            x.grad = None
            m.zero_grad(set_to_none=True)
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dev == "cuda"):
                out = m(x.to(torch.bfloat16) if dev == "cuda" else x)
            out.float().square().sum().backward()
            return out

        out, got = kernel_counts(step, want if dev == "cuda" else None)
        ran.append(got)
        grads.append([x.grad] + [p.grad for p in m.parameters()])
    assert ran == [{}, want]
    assert out.dtype == torch.bfloat16
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "_DeformConv2dBackward"
    for c, k in zip(*grads):
        assert k.dtype == torch.float32 and torch.isfinite(k).all()
        assert (k.cpu() - c).abs().max().item() <= 3e-2 * c.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["htd_r50_1x", "htd_r101_dcn_2x", "htd_x101_dcn_2x"])
def test_train_step_launches(cuda, preset):
    """One bfloat16 train step of HTD R-50 / R-101-DCN / X-101-64x4d-DCN at
    full depth and width (a small 256x384 batch of 2): K1 once, K2 and K4
    three times each, K7 three times (the FPN's top-down adds), the
    hard-NMS kernels once per image (the RPN's proposals), and with
    the 30 deformable convs K3, K5 and K6 30 times each, on the tensor
    cores for R-101-DCN; for X-101's grouped convs K3 on the grouped
    tensor-core path, K5 and K6 on the CUDA cores;
    finite float32 losses; P5's lateral conv gets a finite non-zero
    gradient."""
    from htd_tpu_torch import config as PC
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
    want = {"pyramid_pack_kernel": 1, "roi_align_fwd_kernel": 3, "roi_align_bwd_kernel": 3,
            "upsample_add_kernel": 3, "nms_mask_kernel": 2, "nms_scan_kernel": 2}
    if preset != "htd_r50_1x":
        tc = "_tc" if preset == "htd_r101_dcn_2x" else ""
        fwd = "deform_conv_fwd_tc_kernel" if tc else "deform_conv_fwd_grouped_tc_kernel"
        want.update({fwd: 30, f"deform_conv_bwd_input{tc}_kernel": 30,
                     "deform_conv_bwd_offset_kernel": 30, f"deform_conv_bwd_weight{tc}_kernel": 30})
    metrics, got = kernel_counts(
        lambda: train_step(state, batch, torch.Generator(device="cuda").manual_seed(0)), want)
    assert got == want
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
    from htd_tpu_torch.ops.upsample import upsample2x_add, upsample2x_add_plain

    low, lat = _up_pair(cuda, dtype, *shape)
    k, got = kernel_counts(lambda: upsample2x_add(low, lat), {"upsample_add_kernel": 1})
    assert got == {"upsample_add_kernel": 1}
    assert k.dtype == dtype and k.is_contiguous()
    assert k.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(k, upsample2x_add_plain(low, lat))


@pytest.mark.cuda
def test_upsample_add_rejects_what_it_does_not_take(cuda):
    """An NCHW-contiguous lateral (not channels_last) raises rather than
    being copied; so do two dtypes at the launcher, channels that are not a
    16-byte multiple, and a CPU tensor beside a CUDA one. A pair that is
    not exactly 2x takes the resize branch and runs no hand-written kernel."""
    from htd_tpu_torch.ops.elementwise_cuda import launch_upsample_add
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
    out, got = kernel_counts(lambda: upsample2x_add(low, lat[:, :11]))
    assert out.shape == (1, 11, 20, 32) and got == {}


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

    shapes = [(33, 7), (5, 11, 13), (2, 256, 25, 21), (2, 3, 7, 9, 5), (3, 64, 37, 41)]
    xs = [torch.randn(s, device=cuda).to(dtype) for s in shapes]
    xs[2] = xs[2].contiguous(memory_format=torch.channels_last)
    xs[4] = xs[4].contiguous(memory_format=torch.channels_last)
    gen = torch.Generator(device=cuda).manual_seed(7)
    xs += [torch.randint(0, 256, (span,), device=cuda, dtype=torch.uint8, generator=gen)
           for span in (1, 15, 16 * 12345 + 3)]

    def run():
        for x in xs:
            k = layout_fence(x)
            assert k.stride() == x.stride() and k.data_ptr() != x.data_ptr()
            assert torch.equal(k, layout_fence_plain(x))

    want = {"layout_fence_kernel": len(xs)}
    assert kernel_counts(run, want)[1] == want
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

    got, ran = kernel_counts(lambda: run(True), {"upsample_add_kernel": 3})
    assert ran == {"upsample_add_kernel": 3}
    assert neck.lateral_convs[3].conv.weight.grad.abs().max() > 0
    for a, b in zip(got, run(False)):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def _float_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _soft_nms_inputs(dev, n, case):
    """`multiclass_nms`'s arguments for `n` soft-NMS candidates: 1,000 rois in
    a 1333x800 image, 80 classes, `candidate_cap` n, and (score_thr,
    iou_threshold, soft_min_score, max_per_img) by case:
    "spread": uniform scores, every candidate live;
    "ties": scores on a 0.01 grid (ties), about half the candidates -inf
        (not above score_thr), rois in identical pairs, IoU threshold 0.3;
    "dead": every score between score_thr and soft_min_score;
    "short": 40 live (roi, class) scores, max_per_img 300, more rounds than
        live candidates."""
    rng = np.random.RandomState(n)
    r, c = 1000, 80
    xy = rng.uniform(0, [1333, 800], (r, 2))
    rois = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 300, (r, 2)), [1333, 800])], 1)
    scores = rng.uniform(0.05, 1.0, (r, c + 1))
    settings = (0.05, 0.5, 0.05, 100)
    if case == "ties":
        rois[1::2] = rois[0::2]
        live = rng.uniform(0, 1, (r, c + 1)) < n / (2.0 * r * c)
        scores = np.where(live, np.round(rng.uniform(0.06, 0.3, (r, c + 1)), 2), 0.0)
        settings = (0.05, 0.3, 0.05, 100)
    elif case == "dead":
        scores = rng.uniform(0.02, 0.049, (r, c + 1))
        settings = (0.01, 0.5, 0.05, 100)
    elif case == "short":
        scores = np.full((r, c + 1), 0.03)
        flat = scores.reshape(-1)
        flat[rng.choice(r * c, 40, replace=False)] = rng.uniform(0.1, 0.9, 40)
        settings = (0.01, 0.5, 0.05, 300)
    return (torch.from_numpy(rois.astype(np.float32)).to(dev),
            torch.from_numpy(scores.astype(np.float32)).to(dev), settings)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spread", "ties", "dead", "short"])
@pytest.mark.parametrize("n", [1, 37, 1500, 2048, 5000, 9216, 12000])
def test_soft_nms_kernel_equals_plain(cuda, monkeypatch, n, case):
    """`multiclass_nms(use_soft_nms=True)` on CUDA tensors launches the
    soft-NMS kernel once (hard NMS never), and the kernel's indices, scores
    and validity on the class-offset candidates that `multiclass_nms` hands
    over are `soft_nms_plain`'s on the same CUDA tensors, bit for bit, at
    sizes that are and are not a multiple of the block, with the entries in
    shared memory (up to 9,216) and in the device-memory workspace."""
    from htd_tpu_torch.ops import nms

    boxes, scores, (thr, iou, min_score, max_out) = _soft_nms_inputs(cuda, n, case)
    seen = []

    def capture(*args):
        seen.append(args)
        return soft_nms(*args)

    soft_nms = nms.soft_nms
    monkeypatch.setattr(nms, "soft_nms", capture)
    one = {"soft_nms_kernel": 1}

    def soft():
        seen.clear()
        return nms.multiclass_nms(boxes, scores, thr, iou, max_out, candidate_cap=n,
                                  use_soft_nms=True, soft_min_score=min_score)

    dets, ran = kernel_counts(soft, one)
    assert ran == one and len(seen) == 1
    _, ran = kernel_counts(lambda: nms.multiclass_nms(boxes, scores, thr, iou, max_out,
                                                      candidate_cap=n))
    assert ran == {}
    cand, cand_scores = seen[0][0], seen[0][1]
    assert cand.shape == (n, 4) and cand.is_cuda
    got, ran = kernel_counts(lambda: soft_nms(*seen[0]), one)
    assert ran == one
    want = nms.soft_nms_plain(*seen[0])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape == (max_out,)
        assert torch.equal(_float_bits(a), _float_bits(b))
    valid = int(dets[3].sum())
    if case == "dead":
        assert valid == 0 and not want[0].any() and torch.isneginf(want[1]).all()
    elif case == "short":
        assert 0 < valid <= min(n, 40) < max_out
    elif case == "spread":
        assert valid == min(n, max_out) if n >= 1500 else valid > 0
    elif n >= 1500:
        assert torch.isneginf(cand_scores).any() and valid > 0


@pytest.mark.cuda
def test_soft_nms_nan_as_plain(cuda):
    """A dead box identical to the emitted one decays to -inf * 0 = NaN,
    which `torch.argmax` ranks first: the kernel emits it in the next round
    as the plain version does (an invalid slot with a NaN score), then goes
    on; bit for bit, with the kernel's block of 32 threads."""
    from htd_tpu_torch.ops.nms import soft_nms, soft_nms_plain

    boxes = torch.tensor([[0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30], [1, 1, 11, 11]],
                         dtype=torch.float32, device=cuda)
    scores = torch.tensor([0.9, 0.01, 0.5, 0.7], device=cuda)
    got, want = soft_nms(boxes, scores, 0.5, 0.05, 6), soft_nms_plain(boxes, scores, 0.5, 0.05, 6)
    assert torch.isnan(want[1][1]) and not want[2][1]
    for a, b in zip(got, want):
        assert torch.equal(_float_bits(a), _float_bits(b))


def _hard_nms_inputs(dev, n, case):
    """(boxes, scores, iou_threshold, max_out) for `n` hard-NMS candidates in
    a 1333x800 image, by case:
    "spread": uniform boxes and scores, the RPN's settings (0.7, 1,000);
    "ties": scores on a 0.1 grid, a tenth of them -inf (absent);
    "duplicates": boxes in identical pairs, tied scores;
    "chains": rows of 96 boxes 12 px apart (the rows 150 px apart), each
        suppressing the next (IoU 0.79) and not the one after (0.61), in
        falling score, so the greedy pass alternates along each row,
        across tiles;
    "invalid": every score -inf;
    "short": `max_out` 10, below the keep count;
    "nan": some NaN scores (absent) and boxes with NaN or infinite
        corners (a NaN IoU suppresses nothing);
    "batched": 80 classes' offset boxes as `batched_nms` hands them over,
        post's settings (0.5, 100)."""
    rng = np.random.RandomState(n)
    xy = rng.uniform(0, [1333, 800], (n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 300, (n, 2)), [1333, 800])], 1)
    scores = rng.uniform(0, 1, n)
    thr, max_out = 0.7, 1000
    if case in ("ties", "duplicates"):
        scores = np.round(scores, 1)
        scores[rng.uniform(0, 1, n) < 0.1] = -np.inf
        if case == "duplicates":
            boxes[1::2] = boxes[:n // 2 * 2:2]
    elif case == "chains":
        k = np.arange(n)
        x = (k % 96) * 12.0
        y = (k // 96) * 150.0
        boxes = np.stack([x, y, x + 100.0, y + 100.0], 1)
        scores = 1.0 - k / n
    elif case == "invalid":
        scores[:] = -np.inf
    elif case == "short":
        max_out = 10
    elif case == "nan":
        scores[rng.uniform(0, 1, n) < 0.1] = np.nan
        bad = rng.uniform(0, 1, n) < 0.1
        boxes[bad, rng.randint(0, 4, n)[bad]] = rng.choice([np.nan, np.inf, -np.inf], bad.sum())
    elif case == "batched":
        from htd_tpu_torch.ops.nms import _offset_by_ids

        ids = torch.from_numpy(rng.randint(0, 80, n).astype(np.int32))
        boxes = _offset_by_ids(torch.from_numpy(boxes.astype(np.float32)),
                               torch.from_numpy(scores.astype(np.float32)), ids).numpy()
        thr, max_out = 0.5, 100
    return (torch.from_numpy(boxes.astype(np.float32)).to(dev),
            torch.from_numpy(scores.astype(np.float32)).to(dev), thr, max_out)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spread", "ties", "duplicates", "chains", "invalid", "short",
                                  "nan", "batched"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 2048, 4819, 10000])
def test_hard_nms_kernel_equals_plain(cuda, n, case):
    """`nms` on CUDA tensors runs the hard-NMS kernels (the mask launch and
    the scan launch, once each), and their indices, scores and validity
    are `nms_plain`'s on the same CUDA tensors, bit for bit: at sizes that
    are and are not whole 64-box tiles, from one box to training's RPN
    (about 10,000), with ties, absent and NaN entries, duplicates, chains
    of suppressions across tiles, and an early stop at `max_out`."""
    from htd_tpu_torch.ops.nms import nms, nms_plain

    boxes, scores, thr, max_out = _hard_nms_inputs(cuda, n, case)
    two = {"nms_mask_kernel": 1, "nms_scan_kernel": 1}
    got, ran = kernel_counts(lambda: nms(boxes, scores, thr, max_out), two)
    assert ran == two
    want = nms_plain(boxes, scores, thr, max_out)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape == (max_out,)
        assert torch.equal(_float_bits(a), _float_bits(b))
    kept = int(want[2].sum())
    if case == "invalid":
        assert kept == 0 and not want[0].any() and torch.isneginf(want[1]).all()
    elif case == "short" and n >= 63:
        assert kept == max_out
    elif case == "chains" and n >= 64:
        assert (want[0][:kept] % 2 == 0).all() and kept == min(max_out, n - n // 2)
    else:
        assert kept > 0 or n == 1


@pytest.mark.cuda
def test_hard_nms_replays_in_a_cuda_graph(cuda):
    """`nms` captured into a CUDA graph (the sort, the gathers and both
    kernels; nothing synchronises) and replayed on other boxes and scores
    copied into its inputs gives `nms_plain`'s outputs on those, bit for
    bit, at the RPN's size and settings."""
    from htd_tpu_torch.ops.nms import nms, nms_plain

    boxes, scores, thr, max_out = _hard_nms_inputs(cuda, 4819, "spread")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nms(boxes, scores, thr, max_out)                 # builds and loads the kernels
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = nms(boxes, scores, thr, max_out)
    for case in ("ties", "nan", "spread"):
        b, s, _, _ = _hard_nms_inputs(cuda, 4819, case)
        boxes.copy_(b)
        scores.copy_(s)
        graph.replay()
        for a, w in zip(out, nms_plain(b, s, thr, max_out)):
            assert torch.equal(_float_bits(a), _float_bits(w)), case


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


def test_encoder_on_the_host(cuda):
    """The JPEG encoder on the card's host: each fixture of tests/data/jpeg
    (the small ones and photo0-3) decoded and encoded to the bytes of
    cv2.imencode (tests/data/visualize/manifest.json's SHA-256), and read
    back as cv2.imdecode reads them; the YCCK fixture decodes as imread."""
    import hashlib
    import json
    from pathlib import Path

    from htd_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg, read_jpeg

    data_dir = Path(__file__).resolve().parent / "data"
    manifest = json.loads((data_dir / "visualize" / "manifest.json").read_text())["encode"]
    assert len(manifest) >= 30
    for name, want in manifest.items():
        img = read_jpeg(data_dir / "jpeg" / name)
        data = encode_jpeg(img)
        assert [hashlib.sha256(data).hexdigest(),
                hashlib.sha256(decode_jpeg(data).tobytes()).hexdigest()] == \
            [want["sha256"], want["decoded_sha256"]], name
    jm = json.loads((data_dir / "jpeg" / "manifest.json").read_text())
    ycck = read_jpeg(data_dir / "jpeg" / "ycck_27x41_q85.jpg")
    assert hashlib.sha256(ycck.tobytes()).hexdigest() == jm["ycck_27x41_q85.jpg"]["sha256"]


def test_text_and_draw_on_the_host(cuda, tmp_path):
    """draw_detections (boxes, OpenCV 5's text, the JPEG writer) on the
    card's host: the committed detections on photo0 give the JAX package's
    pixel and .jpg hashes (tests/data/visualize/manifest.json)."""
    import hashlib
    import json
    from pathlib import Path

    from chip_smoke import load_detections
    from htd_tpu_torch.data.jpeg import read_jpeg
    from htd_tpu_torch.utils.visualize import draw_detections

    data_dir = Path(__file__).resolve().parent / "data"
    want = json.loads((data_dir / "visualize" / "manifest.json").read_text())["draw"]
    name, boxes, scores, labels, classes = load_detections(str(data_dir / "visualize"))
    out = tmp_path / "drawn.jpg"
    drawn = draw_detections(read_jpeg(data_dir / "jpeg" / name), boxes, scores, labels, classes,
                            want["score_thr"], str(out))
    assert hashlib.sha256(drawn.tobytes()).hexdigest() == want["pixels_sha256"]
    assert hashlib.sha256(out.read_bytes()).hexdigest() == want["jpg_sha256"]
