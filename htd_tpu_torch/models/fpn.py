"""Feature Pyramid Network neck.

Counterpart of `htd_tpu/models/fpn.py` (mmdet fpn.py with the HTD config):
1x1 laterals, top-down nearest-upsample adds, 3x3 output convs, and P6 as
a stride-2 max-pool of P5. Each top-down add is `ops.upsample.upsample2x_add`
on the NHWC views of the channels_last laterals (kernel K7 on CUDA for an
exact 2x pair, three launches per forward), fenced (K8) when
`HTD_FPN_FENCE=1`. The JAX package's tap-dot 3x3 conv is a TPU workaround;
here it is `nn.Conv2d`.

`RFP` is DetectoRS's recursive feature pyramid (mmdet `RFP`, port only):
the FPN, then for each further step a separately weighted backbone re-runs
over the image with the pyramid fed back through `ASPP`, the same FPN
weights run on its output, and a sigmoid gate blends the two pyramids.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from htd_tpu_torch.models.layers import ConvModule, max_pool
from htd_tpu_torch.ops.fence import fenced
from htd_tpu_torch.ops.upsample import upsample2x_add


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
            top_down = upsample2x_add(laterals[i].permute(0, 2, 3, 1),
                                      laterals[i - 1].permute(0, 2, 3, 1))
            laterals[i - 1] = fenced(top_down, "HTD_FPN_FENCE").permute(0, 3, 1, 2)
        outs = [f(x) for f, x in zip(self.fpn_convs, laterals)]
        for _ in range(self.num_outs - len(outs)):
            outs.append(max_pool(outs[-1], 1, 2, 0))
        return tuple(outs)


class ASPP(nn.Module):
    """mmdet RFP's `ASPP` as DetectoRS sets it: four branches of 64 channels
    at dilations (1, 3, 6, 1), each a conv with bias and a ReLU,
    concatenated over channels; a dilation above 1 is a 3x3 conv padded by
    it, 1 a 1x1 conv, and the last branch reads the input's mean over H and
    W, broadcast back. The mean is taken over the whole input, the bucket's
    padding included."""

    out_channels = 64
    dilations = (1, 3, 6, 1)

    def __init__(self, cin: int):
        super().__init__()
        self.aspp = nn.ModuleList([
            nn.Conv2d(cin, self.out_channels, 3 if d > 1 else 1, padding=d if d > 1 else 0,
                      dilation=d)
            for d in self.dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [F.relu(conv(x)) for conv in self.aspp[:-1]]
        outs.append(F.relu(self.aspp[-1](x.mean((2, 3), keepdim=True))).expand_as(outs[-1]))
        return torch.cat(outs, 1).contiguous(memory_format=torch.channels_last)


class RFP(FPN):
    """mmdet `RFP` (DetectoRS): `forward(inputs, img)` runs the FPN on the
    first backbone's C2-C5 `inputs`, then for each backbone of
    `rfp_modules` (`rfp_steps - 1` of them, each with an `rfp_conv` on block
    0 of layer2-4):

        r   = ASPP(P3), ASPP(P4), ASPP(P5)       fed to layer2, layer3, layer4
        F2  = FPN(backbone.rfp_forward(img, r))  the same FPN weights
        out = g * F2 + (1 - g) * F,  g = sigmoid(rfp_weight(F2)), every level

    (mmdet also computes ASPP(P6), which nothing reads.) Each further step
    runs in an `htd.rfp` span."""

    def __init__(self, in_channels: Sequence[int], out_channels: int, num_outs: int,
                 rfp_modules: Sequence[nn.Module]):
        super().__init__(in_channels, out_channels, num_outs)
        self.rfp_modules = nn.ModuleList(rfp_modules)
        self.rfp_aspp = ASPP(out_channels)
        self.rfp_weight = nn.Conv2d(out_channels, 1, 1)

    def forward(self, inputs: Sequence[torch.Tensor],
                img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = super().forward(inputs)
        for backbone in self.rfp_modules:
            with record_function("htd.rfp"):
                fed = [self.rfp_aspp(x[i]) for i in (1, 2, 3)]
                y = super().forward(backbone.rfp_forward(img, fed))
                x = tuple(torch.lerp(old, new, torch.sigmoid(self.rfp_weight(new)))
                          for old, new in zip(x, y))
        return x
