"""Deformable convolution v1 (kernel K3) and its gradients (kernels K5, K6).

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

`deform_conv2d` is differentiable in x, offsets and weight through
`_DeformConv2d`. On CUDA tensors its forward launches K3
(`csrc/deform_conv.cu`) and its backward K5 (`csrc/deform_conv_bwd_input.cu`:
d_x, and d_col = g . W_t^T) then K6 (`csrc/deform_conv_bwd_offset_weight.cu`:
d_offsets and d_weight); on CPU tensors it runs the plain versions,
`deform_conv2d_plain` (corner gathers and a per-group contraction),
`deform_conv2d_backward_input_plain` (K5's: an einsum and an `index_add_`
onto the same corners) and `deform_conv2d_backward_offset_weight_plain`
(K6's: the corners' derivatives and an einsum). The kernels are exact for
every offset: the TPU kernels' sample window and their capped correction
passes have no counterpart here.
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


def _corners(h: int, w: int, ys: torch.Tensor, xs: torch.Tensor):
    """The four bilinear corners of float32 sample positions ys, xs
    (N, ...): per corner, its flat index into the (H, W) map (clamped),
    its weight, and the weight's derivatives along y and x (unit slope
    inside a floor cell, floor itself carries no gradient), all zero where
    the corner or the sample lies outside (the JAX `_bilinear_gather` and
    `_bilinear_gather_grad`; the kernels' `sample_corners`)."""
    inside = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    zero = torch.zeros_like(ly)
    out = []
    for cy in (0, 1):
        for cx in (0, 1):
            yi, xi = y0i + cy, x0i + cx
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w) & inside
            wy = ly if cy else 1 - ly
            wx = lx if cx else 1 - lx
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            out.append((idx, torch.where(ok, wy * wx, zero),
                        torch.where(ok, wx if cy else -wx, zero),
                        torch.where(ok, wy if cx else -wy, zero)))
    return out


def _gather(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feat (N, H*W, C), idx (N, ...) -> (N, ..., C) float32 rows."""
    n, c = feat.shape[0], feat.shape[-1]
    img = torch.arange(n, device=feat.device).view(n, 1)
    return feat[img, idx.reshape(n, -1)].reshape(idx.shape + (c,)).to(torch.float32)


def _bilinear_gather(feat: torch.Tensor, h: int, w: int, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """feat (N, H*W, C); ys, xs (N, ...) float32 -> (N, ..., C) float32
    bilinear samples, zero outside the map (the JAX `_bilinear_gather`)."""
    out = 0
    for idx, wgt, _, _ in _corners(h, w, ys, xs):
        out = out + _gather(feat, idx) * wgt[..., None]
    return out


def _sample_positions(n: int, ho: int, wo: int, kh: int, kw: int, stride: int,
                      dilation: int, offsets: torch.Tensor, deform_groups: int):
    """(ys, xs), each (N, Ho, Wo, dg, K) float32: the integer base grid plus
    one float32 add of the offset, as the JAX package and the kernels add
    them (floor() of the sum picks the corners, so the sum must be rounded
    exactly as the kernel rounds it)."""
    k = kh * kw
    pad = (kh - 1) // 2 * dilation
    dev = offsets.device
    off = offsets.to(torch.float32).reshape(n, ho, wo, deform_groups, k, 2)
    iy = torch.arange(ho, device=dev) * stride - pad
    ix = torch.arange(wo, device=dev) * stride - pad
    ky = torch.arange(kh, device=dev) * dilation
    kx = torch.arange(kw, device=dev) * dilation
    base_y = (iy.view(ho, 1, 1, 1) + ky.view(1, 1, kh, 1)).expand(ho, wo, kh, kw)
    base_x = (ix.view(1, wo, 1, 1) + kx.view(1, 1, 1, kw)).expand(ho, wo, kh, kw)
    base_y = base_y.reshape(1, ho, wo, 1, k).to(torch.float32)
    base_x = base_x.reshape(1, ho, wo, 1, k).to(torch.float32)
    return base_y + off[..., 0], base_x + off[..., 1]


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
    ho, wo = offsets.shape[1], offsets.shape[2]
    ys, xs = _sample_positions(n, ho, wo, kh, kw, stride, dilation, offsets, deform_groups)

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


def deform_conv2d_backward_input_plain(x_shape, offsets: torch.Tensor, weight: torch.Tensor,
                                       g: torch.Tensor, stride: int = 1, dilation: int = 1,
                                       deform_groups: int = 1, groups: int = 1):
    """The plain version of K5: for the cotangent g (N, Ho, Wo, Cout) of an
    input of shape `x_shape` (N, H, W, Cin), d_col = g . W_t^T per tap and
    weight group (an einsum, float32) and d_x, each sample's corner weights
    times d_col added to its four corners (`index_add_`, float32; the JAX
    `_dcn_dx_folded` without its fold) -> (d_x in g's dtype, d_col
    (N, Ho, Wo, K, Cin) float32)."""
    n, h, w, cin = x_shape
    kh, kw, cg, cout = weight.shape
    k, og = kh * kw, cout // groups
    ho, wo = offsets.shape[1], offsets.shape[2]
    if tuple(g.shape) != (n, ho, wo, cout):
        raise ValueError(f"the cotangent must be {(n, ho, wo, cout)}, got {tuple(g.shape)}")
    ys, xs = _sample_positions(n, ho, wo, kh, kw, stride, dilation, offsets, deform_groups)
    wg = weight.to(torch.float32).reshape(k, cg, groups, og)
    d_col = torch.einsum("npgo,kcgo->npkgc", g.to(torch.float32).reshape(n, ho * wo, groups, og),
                         wg).reshape(n, ho, wo, k, cin)
    cdg = cin // deform_groups
    d_x = torch.zeros((n * h * w, cin), dtype=torch.float32, device=g.device)
    img = (torch.arange(n, device=g.device) * (h * w)).view(n, 1, 1, 1)
    for dg in range(deform_groups):
        sl = slice(dg * cdg, (dg + 1) * cdg)
        for idx, wgt, _, _ in _corners(h, w, ys[..., dg, :], xs[..., dg, :]):
            vals = (d_col[..., sl] * wgt[..., None]).reshape(-1, cdg)
            d_x[:, sl].index_add_(0, (idx + img).reshape(-1), vals)
    return d_x.reshape(n, h, w, cin).to(g.dtype), d_col


def deform_conv2d_backward_offset_weight_plain(x: torch.Tensor, offsets: torch.Tensor,
                                               g: torch.Tensor, d_col: torch.Tensor,
                                               weight_shape, stride: int = 1,
                                               dilation: int = 1, deform_groups: int = 1,
                                               groups: int = 1):
    """The plain version of K6: from K3's x and offsets, the cotangent g
    and K5's d_col, d_off sums d_col times the corners' coordinate
    derivatives over the channels (`_bilinear_gather_grad`) and d_w
    contracts the samples, recomputed from x and the offsets as the JAX
    package's backward does, with g -> (d_off in the offsets' dtype, d_w
    of `weight_shape` in float32)."""
    n, h, w, cin = x.shape
    kh, kw, cg, cout = weight_shape
    k, og = kh * kw, cout // groups
    ho, wo = offsets.shape[1], offsets.shape[2]
    ys, xs = _sample_positions(n, ho, wo, kh, kw, stride, dilation, offsets, deform_groups)
    flat = x.reshape(n, h * w, cin)
    cdg = cin // deform_groups
    col, d_off = [], []
    for dg in range(deform_groups):
        sl = slice(dg * cdg, (dg + 1) * cdg)
        col_g, dy, dx = 0, 0, 0
        for idx, wgt, dwy, dwx in _corners(h, w, ys[..., dg, :], xs[..., dg, :]):
            v = _gather(flat[..., sl], idx)                     # (N, Ho, Wo, K, cdg)
            col_g = col_g + v * wgt[..., None]
            dv = (d_col[..., sl] * v).sum(-1)
            dy = dy + dwy * dv
            dx = dx + dwx * dv
        col.append(col_g)
        d_off.append(torch.stack([dy, dx], -1))                  # (N, Ho, Wo, K, 2)
    col = torch.cat(col, -1).reshape(n, ho * wo, k, groups, cg)
    g32 = g.to(torch.float32).reshape(n, ho * wo, groups, og)
    d_w = torch.einsum("npkgc,npgo->kcgo", col, g32).reshape(kh, kw, cg, cout)
    d_off = torch.stack(d_off, 3).reshape(n, ho, wo, deform_groups * 2 * k)
    return d_off.to(offsets.dtype), d_w


def deform_conv2d_backward_plain(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                                 g: torch.Tensor, stride: int = 1, dilation: int = 1,
                                 deform_groups: int = 1, groups: int = 1):
    """The plain version of K5 then K6: the gradients (d_x, d_off, d_w) of
    `deform_conv2d_plain` for the cotangent g (N, Ho, Wo, Cout), each in
    its input's dtype, from float32 sums."""
    _check(x, offsets, weight, stride, dilation, deform_groups, groups)
    args = (stride, dilation, deform_groups, groups)
    d_x, d_col = deform_conv2d_backward_input_plain(x.shape, offsets, weight, g, *args)
    d_off, d_w = deform_conv2d_backward_offset_weight_plain(x, offsets, g, d_col, weight.shape,
                                                            *args)
    return d_x.to(x.dtype), d_off, d_w.to(weight.dtype)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  stride: int = 1, dilation: int = 1, deform_groups: int = 1,
                  groups: int = 1) -> torch.Tensor:
    """DCNv1: x (N, H, W, Cin), offsets (N, Ho, Wo, dg * 2 * kh * kw),
    weight (kh, kw, Cin / groups, Cout) -> (N, Ho, Wo, Cout), differentiable
    in all three. On CUDA one K3 launch forward and one K5 and one K6
    launch backward (3x3, deform_groups 1, inputs of one dtype; x and
    offsets contiguous, the weight's memory in (Cout, kh, kw, Cin / groups)
    order as `DeformConv2d.hwio_weight()` gives it); the plain versions on
    the CPU."""
    _check(x, offsets, weight, stride, dilation, deform_groups, groups)
    dev = x.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"deform_conv2d runs on cuda or cpu tensors, not {dev}")
    return _DeformConv2d.apply(x, offsets, weight, stride, dilation, deform_groups, groups)


class _DeformConv2d(torch.autograd.Function):
    """K3 forward, K5 + K6 backward on CUDA tensors; the plain versions on
    CPU tensors. Saves x, offsets and weight, and the backward recomputes
    the samples (no (N, Ho, Wo, K, Cin) tensor is kept). Each gradient
    comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, x, offsets, weight, stride, dilation, deform_groups, groups):
        ctx.save_for_backward(x, offsets, weight)
        ctx.args = (stride, dilation, deform_groups, groups)
        if x.device.type == "cpu":
            return deform_conv2d_plain(x, offsets, weight, *ctx.args)
        from htd_tpu_torch.ops.dcn_cuda import launch_deform_conv

        return launch_deform_conv(x, offsets, weight, *ctx.args)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, offsets, weight = ctx.saved_tensors
        g = g.contiguous()
        if x.device.type == "cpu":
            grads = deform_conv2d_backward_plain(x, offsets, weight, g, *ctx.args)
        else:
            from htd_tpu_torch.ops import dcn_cuda

            d_x, d_col = dcn_cuda.launch_deform_conv_bwd_input(x.shape, offsets, weight, g,
                                                               *ctx.args)
            d_off, d_w = dcn_cuda.launch_deform_conv_bwd_offset_weight(
                x, offsets, g, d_col, weight.shape, *ctx.args)
            grads = (d_x, d_off, d_w.to(weight.dtype))
        return tuple(d if need else None
                     for d, need in zip(grads, ctx.needs_input_grad)) + (None,) * 4


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

    def hwio_weight(self, dtype=None) -> torch.Tensor:
        """The weight, in `dtype` when given, as a (3, 3, Cin / groups, Cout)
        view of its channels_last memory, which is what K3, K5 and K6 read:
        no layout copy for the channels_last parameter that `init_detector`
        makes, and the cast keeps that layout (one otherwise)."""
        w = self.weight.contiguous(memory_format=torch.channels_last)
        return (w if dtype is None else w.to(dtype)).permute(2, 3, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the offsets and the weight in x's dtype, as the JAX package casts
        # its weight (under autocast the offset conv gives bfloat16 and the
        # parameter is float32; the kernels take one dtype)
        off = self.conv_offset(x).to(x.dtype)
        out = deform_conv2d(x.permute(0, 2, 3, 1), off.permute(0, 2, 3, 1),
                            self.hwio_weight(x.dtype), self.stride, 1, self.deform_groups,
                            self.groups)
        return out.permute(0, 3, 1, 2)
