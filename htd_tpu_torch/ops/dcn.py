"""Deformable convolution v1 forward (kernel K3).

Function: mmcv-full `DeformConv2d` (DCNv1), as the JAX package computes
it in `htd_tpu/ops/dcn.py` (`_dcn_xla_impl(impl="gather")` with
`_bilinear_gather`): a per-pixel (dy, dx) offset for every kernel tap
moves the tap's sample point, the sample is bilinear with zero padding
outside the map, and the samples are contracted with the conv weight,

    out[n, i, j, :] = sum_k sum_c bilinear(x[n, :, :, c], base(i, j, k) + off(n, i, j, k))
                      * W[k, c, :]

with base(i, j, k) = (i * stride - pad + ky * dilation, j * stride - pad +
kx * dilation) and pad = (kh - 1) // 2 * dilation. A sample counts when
-1 < y < H and -1 < x < W, and each of its four corners only when that
corner lies in the map. Layouts are the JAX package's: x (N, H, W, Cin),
offsets (N, Ho, Wo, dg * 2 * kh * kw) with channels ordered
[deform group][tap][(y, x)], weight (kh, kw, Cin / groups, Cout) (HWIO,
grouped), out (N, Ho, Wo, Cout) in x's dtype.

`deform_conv2d` launches the CUDA kernel (`csrc/deform_conv.cu`) on CUDA
tensors and runs the plain version (`deform_conv2d_plain`, corner gathers
and a per-group contraction) on CPU tensors. The kernel is exact for
every offset: the TPU kernel's sample window and its capped correction
pass have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _out_size(size: int, k: int, stride: int, dilation: int) -> int:
    pad = (k - 1) // 2 * dilation
    return (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def _check(x, offsets, weight, stride, dilation, deform_groups, groups) -> None:
    if x.dim() != 4 or offsets.dim() != 4 or weight.dim() != 4:
        raise ValueError("x, offsets and weight must be 4-D (NHWC, NHWC, HWIO)")
    n, h, w, cin = x.shape
    kh, kw, cg, cout = weight.shape
    if groups < 1 or deform_groups < 1 or cin % groups or cout % groups \
            or cg * groups != cin or cin % deform_groups:
        raise ValueError(f"channels {cin} -> {cout} do not split into {groups} groups "
                         f"and {deform_groups} deform groups (weight {tuple(weight.shape)})")
    want = (n, _out_size(h, kh, stride, dilation), _out_size(w, kw, stride, dilation),
            deform_groups * 2 * kh * kw)
    if tuple(offsets.shape) != want:
        raise ValueError(f"offsets must be {want}, got {tuple(offsets.shape)}")
    if offsets.device != x.device or weight.device != x.device:
        raise ValueError("x, offsets and weight are on different devices")


def _bilinear_gather(feat: torch.Tensor, h: int, w: int, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """feat (N, H*W, C); ys, xs (N, ...) float32 -> (N, ..., C) float32
    bilinear samples, zero outside the map (the JAX `_bilinear_gather`)."""
    n, c = feat.shape[0], feat.shape[-1]
    inside = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    img = torch.arange(n, device=feat.device).view(n, 1)

    def corner(yi, xi, wgt):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w) & inside
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = feat[img, idx.reshape(n, -1)].reshape(idx.shape + (c,)).to(torch.float32)
        return v * torch.where(ok, wgt, torch.zeros_like(wgt))[..., None]

    return (corner(y0i, x0i, (1 - ly) * (1 - lx))
            + corner(y0i, x0i + 1, (1 - ly) * lx)
            + corner(y0i + 1, x0i, ly * (1 - lx))
            + corner(y0i + 1, x0i + 1, ly * lx))


def deform_conv2d_plain(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                        stride: int = 1, dilation: int = 1, deform_groups: int = 1,
                        groups: int = 1) -> torch.Tensor:
    """The plain version of K3: gathers every (pixel, tap) sample, then
    contracts per weight group. Samples and sums are float32 whatever the
    input dtype; the result is cast to x's dtype."""
    _check(x, offsets, weight, stride, dilation, deform_groups, groups)
    n, h, w, cin = x.shape
    kh, kw, cg, cout = weight.shape
    k = kh * kw
    pad = (kh - 1) // 2 * dilation
    ho, wo = offsets.shape[1], offsets.shape[2]
    dev = x.device
    off = offsets.to(torch.float32).reshape(n, ho, wo, deform_groups, k, 2)
    # integer base grid, then one float32 add of the offset (as the JAX
    # package does): floor() of the sum picks the corners, so the sum
    # must be rounded exactly as the kernel rounds it
    iy = torch.arange(ho, device=dev) * stride - pad
    ix = torch.arange(wo, device=dev) * stride - pad
    ky = torch.arange(kh, device=dev) * dilation
    kx = torch.arange(kw, device=dev) * dilation
    base_y = (iy.view(ho, 1, 1, 1) + ky.view(1, 1, kh, 1)).expand(ho, wo, kh, kw)
    base_x = (ix.view(1, wo, 1, 1) + kx.view(1, 1, 1, kw)).expand(ho, wo, kh, kw)
    base_y = base_y.reshape(1, ho, wo, 1, k).to(torch.float32)
    base_x = base_x.reshape(1, ho, wo, 1, k).to(torch.float32)
    ys = base_y + off[..., 0]                                   # (N, Ho, Wo, dg, K)
    xs = base_x + off[..., 1]

    flat = x.reshape(n, h * w, cin)
    cdg = cin // deform_groups
    col = torch.cat([
        _bilinear_gather(flat[..., g * cdg:(g + 1) * cdg], h, w, ys[..., g, :], xs[..., g, :])
        for g in range(deform_groups)], dim=-1)                 # (N, Ho, Wo, K, Cin)
    og = cout // groups
    col = col.reshape(n, ho * wo, k, groups, cg)
    wg = weight.to(torch.float32).reshape(k, cg, groups, og)
    out = torch.einsum("npkgc,kcgo->npgo", col, wg)
    return out.reshape(n, ho, wo, cout).to(x.dtype)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  stride: int = 1, dilation: int = 1, deform_groups: int = 1,
                  groups: int = 1) -> torch.Tensor:
    """DCNv1 forward: x (N, H, W, Cin), offsets (N, Ho, Wo, dg * 2 * kh * kw),
    weight (kh, kw, Cin / groups, Cout) -> (N, Ho, Wo, Cout). One K3 launch
    on CUDA (3x3, deform_groups 1, inputs of one dtype; x and offsets
    contiguous, the weight's memory in (Cout, kh, kw, Cin / groups) order
    as `DeformConv2d.hwio_weight()` gives it); the plain version on the
    CPU."""
    _check(x, offsets, weight, stride, dilation, deform_groups, groups)
    dev = x.device.type
    if dev == "cpu":
        return deform_conv2d_plain(x, offsets, weight, stride, dilation, deform_groups, groups)
    if dev != "cuda":
        raise ValueError(f"deform_conv2d runs on cuda or cpu tensors, not {dev}")
    from htd_tpu_torch.ops.dcn_cuda import launch_deform_conv

    return launch_deform_conv(x, offsets, weight, stride, dilation, deform_groups, groups)


class DeformConv2d(nn.Module):
    """mmcv `DeformConv2dPack`, 3x3 with padding 1: `weight` (Cout,
    Cin / groups, 3, 3) without bias, and `conv_offset`, the regular conv
    (with bias) that predicts the deform_groups * 18 offsets. NCHW in and
    out; the kernel reads the channels_last input, offsets and weight
    through their NHWC / HWIO views, which cost no copy."""

    def __init__(self, cin: int, cout: int, stride: int = 1, groups: int = 1,
                 deform_groups: int = 1):
        super().__init__()
        self.stride, self.groups, self.deform_groups = stride, groups, deform_groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, 3, 3))
        self.conv_offset = nn.Conv2d(cin, deform_groups * 18, 3, stride=stride, padding=1)

    def hwio_weight(self) -> torch.Tensor:
        """The weight as a (3, 3, Cin / groups, Cout) view of its channels_last
        memory, which is what K3 reads: no copy for the channels_last
        parameter that `init_detector` makes (a layout copy otherwise)."""
        return self.weight.contiguous(memory_format=torch.channels_last).permute(2, 3, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        off = self.conv_offset(x)
        out = deform_conv2d(x.permute(0, 2, 3, 1), off.permute(0, 2, 3, 1), self.hwio_weight(),
                            self.stride, 1, self.deform_groups, self.groups)
        return out.permute(0, 3, 1, 2)
