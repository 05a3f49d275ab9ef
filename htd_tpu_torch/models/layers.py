"""Shared building blocks (NCHW modules; the detector keeps activations in
`torch.channels_last` memory format).

Counterpart of `htd_tpu/models/layers.py`. The JAX package's
`MXUGroupNorm` is a TPU workaround and is not ported: the heads use
`nn.GroupNorm`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with stored statistics only (mmdet `norm_eval=True`).

    State-dict keys are BatchNorm2d's (`weight`, `bias`, `running_mean`,
    `running_var`); an mmdet checkpoint's `num_batches_tracked` is dropped
    on load. The affine `weight` and `bias` are parameters, trained where
    the optimizer's mask allows (mmdet `requires_grad=True`); the running
    statistics are buffers and never change. The scale and shift are
    folded in float32, as the JAX package does, then applied in the
    activation's dtype.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        add = self.bias.float() - self.running_mean.float() * mul
        shape = (1, -1, 1, 1)
        return x * mul.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)


def conv(cin: int, cout: int, kernel: int, stride: int = 1, bias: bool = True) -> nn.Conv2d:
    """Conv with torch-style 'same' padding for odd kernels."""
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=bias)


class ConvModule(nn.Module):
    """mmcv ConvModule without activation: `.conv`, then `.gn` when
    `gn_groups` is given, so that state-dict keys read `<name>.conv.weight`
    and `<name>.gn.weight` as in mmdet checkpoints."""

    def __init__(self, cin: int, cout: int, kernel: int, bias: bool = True,
                 gn_groups: Optional[int] = None):
        super().__init__()
        self.conv = conv(cin, cout, kernel, bias=bias)
        self.gn = nn.GroupNorm(gn_groups, cout, eps=1e-5) if gn_groups else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return x if self.gn is None else self.gn(x)


def ring_mask(edge: int, size: int, device) -> torch.Tensor:
    """(size, size) bool, True on the border ring `edge` pixels wide."""
    ys = torch.arange(size, device=device)
    border = (ys < edge) | (ys >= size - edge)
    return border[:, None] | border[None, :]


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Max pool with torch-style symmetric padding (pads never win)."""
    return F.max_pool2d(x, window, stride=stride, padding=padding)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NCHW to (H, W) = size with half-pixel centres, as
    `jax.image.resize`; an integer upscale duplicates pixels exactly."""
    return F.interpolate(x, size=(int(size[0]), int(size[1])), mode="nearest-exact")
