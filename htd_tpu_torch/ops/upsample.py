"""The FPN top-down step, lat + nearest_2x(low) (kernel K7).

Counterpart of `htd_tpu/ops/upsample.py` (`upsample2x_add`; mmdet fpn.py's
`F.interpolate(scale_factor=2, mode="nearest")` + add): pure duplication,
no resampling. Layouts are the JAX package's, NHWC: low (B, h, w, C), lat
(B, 2h, 2w, C). The shape rule is the JAX package's too: only an exact 2x
pair of one batch and width goes through `_Upsample2xAdd` (K7 on CUDA
tensors, `upsample2x_add_plain` on CPU tensors); any other pair is
`lat + resize_nearest(low)`. `low` is cast to lat's dtype first, as the
TPU kernel casts it. The gradient is the JAX package's VJP: d_lat = g,
d_low = the 2x2 sum-pool of g, in plain torch (the TPU has no backward
kernel for it either).
"""

from __future__ import annotations

import torch

from htd_tpu_torch.models.layers import resize_nearest


def upsample2x_add_plain(low: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """The plain version of K7: lat + low with each pixel repeated 2x2, one
    add in lat's dtype; a contiguous (B, 2h, 2w, C) result."""
    up = low.to(lat.dtype).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return (lat + up).contiguous()


def pool2x2_sum(g: torch.Tensor) -> torch.Tensor:
    """(B, 2h, 2w, C) -> (B, h, w, C): the sum of each 2x2 block, the
    gradient of the 2x nearest upsample."""
    b, h2, w2, c = g.shape
    return g.reshape(b, h2 // 2, 2, w2 // 2, 2, c).sum(dim=(2, 4))


def upsample2x_add(low: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """lat + nearest_2x(low) for NHWC low (B, h, w, C) and lat (B, 2h, 2w,
    C), differentiable in both; other shape pairs resize to lat's shape.
    On CUDA one K7 launch, which takes contiguous NHWC inputs (the NHWC
    permute of a channels_last tensor) and raises on any other strides; its
    output's NCHW permute is channels_last."""
    b, h, w, c = low.shape
    if tuple(lat.shape) != (b, 2 * h, 2 * w, c):
        up = resize_nearest(low.permute(0, 3, 1, 2), lat.shape[1:3]).permute(0, 2, 3, 1)
        return lat + up
    if lat.device.type not in ("cuda", "cpu") or low.device != lat.device:
        raise ValueError(f"upsample2x_add runs on cuda or cpu tensors on one device, not "
                         f"{low.device} and {lat.device}")
    return _Upsample2xAdd.apply(low.to(lat.dtype), lat)


class _Upsample2xAdd(torch.autograd.Function):
    """K7 forward on CUDA tensors, the plain version on CPU tensors; the
    backward is plain torch on both."""

    @staticmethod
    def forward(ctx, low, lat):
        if lat.device.type == "cpu":
            return upsample2x_add_plain(low, lat)
        from htd_tpu_torch.ops.elementwise_cuda import launch_upsample_add

        return launch_upsample_add(low, lat)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return pool2x2_sum(g) if ctx.needs_input_grad[0] else None, g
