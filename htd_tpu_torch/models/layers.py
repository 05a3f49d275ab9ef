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


def conv(cin: int, cout: int, kernel: int, stride: int = 1, bias: bool = True,
         aws: bool = False) -> nn.Conv2d:
    """Conv with torch-style 'same' padding for odd kernels; weight-standardised
    (`ConvAWS2d`) when `aws`."""
    cls = ConvAWS2d if aws else nn.Conv2d
    return cls(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=bias)


def standardize(weight: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """mmcv `ConvAWS2d._get_weight` in float32: each output channel's
    weights less their mean, over the square root of their unbiased variance
    plus 1e-5, times `gamma` plus `beta` ((Cout, 1, 1, 1) each)."""
    w = weight.float()
    flat = w.flatten(1)
    mean = flat.mean(1).view(-1, 1, 1, 1)
    std = torch.sqrt(flat.var(1) + 1e-5).view(-1, 1, 1, 1)
    return gamma.float() * ((w - mean) / std) + beta.float()


class ConvAWS2d(nn.Conv2d):
    """mmcv `ConvAWS2d`: a conv whose weight is standardised per output
    channel (`standardize`), with the (Cout, 1, 1, 1) buffers `weight_gamma`
    (ones) and `weight_beta` (zeros) of its state dict. A call that records
    no autograd reuses the standardised weight, in the weight's dtype and
    memory format, that the first such call derived, until the module is
    moved, cast or loaded (`_apply`, `_load_from_state_dict`): a weight
    changed in place in between is loaded with `load_state_dict`. A call
    that records autograd derives it afresh."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("weight_gamma", torch.ones(self.out_channels, 1, 1, 1))
        self.register_buffer("weight_beta", torch.zeros(self.out_channels, 1, 1, 1))
        self._kept = None

    def _apply(self, *args, **kwargs):
        self._kept = None
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._kept = None
        return super()._load_from_state_dict(*args, **kwargs)

    def derive(self):
        """The weight the conv runs with."""
        w = standardize(self.weight, self.weight_gamma, self.weight_beta)
        return torch.empty_like(self.weight).copy_(w)

    def weights(self):
        """`derive()`, kept between calls that record no autograd."""
        if torch.is_grad_enabled():
            return self.derive()
        if self._kept is None:
            self._kept = self.derive()
        return self._kept

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weights(), self.bias)


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
