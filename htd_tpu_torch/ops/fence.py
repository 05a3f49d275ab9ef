"""The layout fence (kernel K8): the identity, as a fresh copy.

Counterpart of `htd_tpu/ops/fence.py` (`layout_fence`), an identity Pallas
copy that pinned a row-major layout at its boundary so that XLA's layout
assignment could not flip the producing convolution into a slow layout.
The JAX package places it at three call sites, each behind its own
switch, off by default: `HTD_FPN_FENCE` on each FPN top-down sum,
`HTD_RPN_FENCE` on each level entering the RPN head and `HTD_DCN_FENCE` on
the input of every deformable conv. The port reads the same switches at
the same places (`fenced`). On CUDA tensors K8 writes the copy in the
input's own memory format; on CPU tensors the plain version makes the
same copy. The gradient passes through unchanged.
"""

from __future__ import annotations

import os

import torch


def layout_fence_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of K8: a fresh tensor with x's strides and values."""
    return torch.empty_like(x).copy_(x)


def layout_fence(x: torch.Tensor) -> torch.Tensor:
    """Identity in value and gradient; on CUDA one K8 launch, which takes a
    dense tensor (every memory format) and raises on any other."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"layout_fence runs on cuda or cpu tensors, not {x.device}")
    return _LayoutFence.apply(x)


def switched_on(switch: str) -> bool:
    """Whether the environment variable `switch` is "1" (the JAX package's
    opt-in switches)."""
    return os.environ.get(switch, "0") == "1"


def fenced(x: torch.Tensor, switch: str) -> torch.Tensor:
    """`layout_fence(x)` when `switch` is on, else x itself."""
    return layout_fence(x) if switched_on(switch) else x


class _LayoutFence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if x.device.type == "cpu":
            return layout_fence_plain(x)
        from htd_tpu_torch.ops.elementwise_cuda import launch_layout_fence

        return launch_layout_fence(x)

    @staticmethod
    def backward(ctx, g):
        return g
