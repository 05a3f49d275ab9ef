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
    assert launch_counts == {"pyramid_pack": 1, "roi_align": 3, "deform_conv": 0,
                             "roi_align_bwd": 0, "deform_conv_bwd_input": 0,
                             "deform_conv_bwd_offset_weight": 0}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("all_levels", [False, True])
def test_roi_align_bwd_matches_plain(cuda, all_levels, dtype):
    """K4 against its plain version: the float32 pyramid gradient within
    1e-5 of the plain version's largest magnitude (both add the same
    float32 products, K4 with atomics in another order); through autograd
    the levels get it in the features' dtype, one launch per backward."""
    from htd_tpu_torch.ops.roi_align import roi_align_backward_plain
    from htd_tpu_torch.ops.roi_align_cuda import (launch_counts, launch_roi_align_bwd,
                                                  reset_launch_counts)

    feats, rois = _inputs(cuda, dtype)
    rois[:, 5:9] = rois[:, 4:5]                  # crowded: several copies of one roi
    geom = pack_pyramid(feats).geom
    lv = None if all_levels else map_roi_levels(rois, 4)
    s = 1 if all_levels else 4
    lead = (4,) if all_levels else ()
    g = torch.randn(lead + tuple(rois.shape[:2]) + (7, 7, 64), device=cuda).to(dtype)
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


@pytest.mark.cuda
def test_deform_conv_bwd_rejects_what_it_does_not_take(cuda):
    """K5 and K6 raise, rather than fall back or copy, on a cotangent that
    is not contiguous, inputs of two dtypes, two deform groups, and a d_col
    that is not K5's float32 one."""
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
    three times each, and with the 30 deformable convs K3, K5 and K6 30
    times each; finite float32 losses."""
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
                             "deform_conv_bwd_offset_weight": dcn}
    assert all(v.dtype == torch.float32 and torch.isfinite(v).item() for v in metrics.values())
