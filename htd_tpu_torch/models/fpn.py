"""Feature Pyramid Network neck.

Counterpart of `htd_tpu/models/fpn.py` (mmdet fpn.py with the HTD config):
1x1 laterals, top-down nearest-upsample adds, 3x3 output convs, and P6 as
a stride-2 max-pool of P5. The JAX package's tap-dot 3x3 conv and Pallas
upsample-add are TPU workarounds; here they are `nn.Conv2d` and a plain
`lateral + upsample(lower)`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from htd_tpu_torch.models.layers import ConvModule, max_pool, resize_nearest


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3) for _ in in_channels])

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [lat(x) for lat, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [f(x) for f, x in zip(self.fpn_convs, laterals)]
        for _ in range(self.num_outs - len(outs)):
            outs.append(max_pool(outs[-1], 1, 2, 0))
        return tuple(outs)
