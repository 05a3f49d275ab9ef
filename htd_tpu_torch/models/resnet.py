"""ResNet backbone with frozen BatchNorm (torchvision / mmdet layout).

Counterpart of `htd_tpu/models/resnet.py`: pytorch-style bottleneck
(stride on conv2), plain 7x7/2 stem, C2-C5 outputs. Module names are the
mmdet state-dict names (`conv1`, `bn1`, `layer{1-4}.{i}.conv{1-3}`,
`downsample.{0,1}`). Depth 10 is the test-only variant of the JAX
package's `ARCH_BLOCKS`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from htd_tpu_torch.models.layers import FrozenBatchNorm2d, conv, max_pool

ARCH_BLOCKS = {
    10: (1, 1, 1, 1),  # test-only tiny variant
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = conv(cin, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride=stride, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = conv(planes, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(conv(cin, cout, 1, stride=stride, bias=False),
                                            FrozenBatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-50/101/152 (depth 10 for tests). Returns C2-C5 (NCHW)."""

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (0, 1, 2, 3),
                 base_planes: int = 64):
        super().__init__()
        blocks = ARCH_BLOCKS[depth]
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(3, base_planes, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(base_planes)
        cin, planes = base_planes, base_planes
        for stage, n in enumerate(blocks):
            layers = []
            for i in range(n):
                stride = (1 if stage == 0 else 2) if i == 0 else 1
                layers.append(Bottleneck(cin, planes, stride, downsample=(i == 0)))
                cin = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))
            planes *= 2

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = max_pool(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
